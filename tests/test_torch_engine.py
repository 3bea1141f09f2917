"""The port's graph engine against the JAX package's on the same inputs:
packs byte-equal with equal quality metrics, SSSP / WCC exact, PageRank close.

PageRank tolerance: XLA's and torch's scatter-adds sum the f32 contributions
in different orders, so the ranks agree to rtol=1e-5, atol=1e-7, not bitwise.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import numpy as np
import pytest
import torch

from repro.core import baselines as J_baselines
from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.graphs import engine as J_E
from repro.launch import mesh as J_MM
from repro_torch import compat
from repro_torch.core.graph import rmat_graph
from repro_torch.graphs import engine as E
from repro_torch.kernels import _build, min_sweep

GRAPHS = [(8, 6), (6, 4)]  # (scale, edge_factor)
KS = [1, 4, 8, 16, 17]


@pytest.fixture(scope="module", params=GRAPHS, ids=lambda p: f"rmat{p[0]}x{p[1]}")
def ordered(request):
    scale, ef = request.param
    jg = J_rmat(scale, ef, seed=0)
    order = J_ordering.geo_order(jg, seed=0)
    return rmat_graph(scale, ef, seed=0), jg, order


@pytest.fixture(scope="module")
def mesh1():
    return J_MM.make_test_mesh(data=1, model=1)


def _assert_same_pack(got, want):
    for name, dtype in (("edges", torch.int32), ("mask", torch.float32), ("degrees", torch.float32)):
        t = getattr(got, name)
        assert t.dtype == dtype, name
        assert np.array_equal(t.cpu().numpy(), np.asarray(getattr(want, name))), name
    assert (got.num_vertices, got.k, got.num_edges) == (want.num_vertices, want.k, want.num_edges)
    assert got.mirrors == want.mirrors
    assert got.replication_factor == want.replication_factor


def _port_of(jdata):
    """The very same pack, handed from the JAX package to the port."""
    return E.engine_data_from_arrays(
        np.asarray(jdata.edges), np.asarray(jdata.mask), np.asarray(jdata.degrees),
        num_vertices=jdata.num_vertices, k=jdata.k, mirrors=jdata.mirrors,
        replication_factor=jdata.replication_factor, num_edges=jdata.num_edges, device="cpu",
    )


@pytest.mark.parametrize("k", KS)
def test_pack_ordered_byte_equal(ordered, k):
    g, jg, order = ordered
    s, d = g.src[order], g.dst[order]
    _assert_same_pack(
        E.pack_ordered(s, d, g.num_vertices, k, device="cpu"), J_E.pack_ordered(s, d, jg.num_vertices, k)
    )


@pytest.mark.parametrize("k", [4, 8])
def test_cep_engine_data_and_comm_volume_equal(ordered, k):
    g, jg, order = ordered
    got, want = E.cep_engine_data(g, order, k, device="cpu"), J_E.cep_engine_data(jg, order, k)
    _assert_same_pack(got, want)
    assert E.comm_volume_per_iteration(got) == J_E.comm_volume_per_iteration(want)


def test_pack_ordered_e_max_headroom_equal(ordered):
    g, jg, order = ordered
    s, d = g.src[order], g.dst[order]
    e_max = g.num_edges // 4 + 9
    _assert_same_pack(
        E.pack_ordered(s, d, g.num_vertices, 4, e_max=e_max, device="cpu"),
        J_E.pack_ordered(s, d, jg.num_vertices, 4, e_max=e_max),
    )
    with pytest.raises(ValueError):
        E.pack_ordered(s, d, g.num_vertices, 4, e_max=1, device="cpu")


@pytest.mark.parametrize("method", ["hash_1d", "dbh"])
def test_build_engine_data_byte_equal(ordered, method):
    g, jg, _ = ordered
    part = getattr(J_baselines, method)(jg, 8)
    _assert_same_pack(E.build_engine_data(g, part, 8, device="cpu"), J_E.build_engine_data(jg, part, 8))


@pytest.mark.parametrize("k", [4, 17])
def test_unpack_ordered_round_trip(ordered, k):
    g, _, order = ordered
    s, d = g.src[order], g.dst[order]
    got_s, got_d = E.unpack_ordered(E.pack_ordered(s, d, g.num_vertices, k, device="cpu"))
    assert np.array_equal(got_s, s) and np.array_equal(got_d, d)


def test_engine_data_from_arrays_checks_dtypes(ordered):
    _, jg, order = ordered
    jdata = J_E.cep_engine_data(jg, order, 4)
    _assert_same_pack(_port_of(jdata), jdata)
    with pytest.raises(TypeError):
        E.engine_data_from_arrays(
            np.asarray(jdata.edges).astype(np.int64), np.asarray(jdata.mask), np.asarray(jdata.degrees),
            num_vertices=jdata.num_vertices, k=4, mirrors=0, replication_factor=0.0,
            num_edges=jdata.num_edges, device="cpu",
        )


@pytest.mark.parametrize("k", [4, 8])
def test_sssp_exact(ordered, mesh1, k):
    _, jg, order = ordered
    jdata = J_E.cep_engine_data(jg, order, k)
    source = int(np.argmax(np.asarray(jdata.degrees)))
    want, want_it = J_E.sssp(jdata, mesh1, source=source)
    got, got_it = E.sssp(_port_of(jdata), source=source)
    assert got_it == want_it
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [4, 8])
def test_wcc_exact(ordered, mesh1, k):
    _, jg, order = ordered
    jdata = J_E.cep_engine_data(jg, order, k)
    want, want_it = J_E.wcc(jdata, mesh1)
    got, got_it = E.wcc(_port_of(jdata))
    assert got_it == want_it
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [4, 8])
def test_pagerank_close(ordered, mesh1, k):
    _, jg, order = ordered
    jdata = J_E.cep_engine_data(jg, order, k)
    want = np.asarray(J_E.pagerank(jdata, mesh1, iterations=20))
    got = E.pagerank(_port_of(jdata), iterations=20)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_entry_points_default_to_cuda(ordered):
    """device=None means CUDA: without a CUDA device the pack raises instead of
    running on the CPU; with one, it lands on the GPU."""
    g, _, order = ordered
    s, d = g.src[order], g.dst[order]
    if torch.cuda.is_available():
        assert E.pack_ordered(s, d, g.num_vertices, 4).edges.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            E.pack_ordered(s, d, g.num_vertices, 4)
        with pytest.raises(RuntimeError):
            compat.resolve_device("cuda:0")
    assert compat.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        compat.resolve_device("meta")


# ------------------------------------------------------------------ min-sweep
def _numpy_sweep(edges, mask, x, step):
    """One sweep by numpy: min(x, scatter-min of the neighbours' x + step) over
    the slots with mask > 0, each edge both ways; and whether x fell anywhere."""
    e = edges.reshape(-1, 2)
    valid = mask.reshape(-1) > 0
    u, v = e[valid, 0], e[valid, 1]
    cand = np.full_like(x, np.inf)
    np.minimum.at(cand, v, x[u] + np.float32(step))
    np.minimum.at(cand, u, x[v] + np.float32(step))
    nx = np.minimum(x, cand)
    return nx, bool((nx < x).any())


def _sweep_state(kind, state, v, rng):
    if state == "start":
        if kind == "sssp":
            x = np.full(v, 1e9, dtype=np.float32)
            x[0] = 0.0
            return x
        return np.arange(v, dtype=np.float32)
    if state == "midway":  # a frontier of known distances, the rest unreached; labels partly merged
        if kind == "sssp":
            x = np.full(v, 1e9, dtype=np.float32)
            known = rng.random(v) < 0.3
            x[known] = rng.integers(0, 6, size=int(known.sum()))
            return x
        return np.minimum(np.arange(v), rng.integers(0, v, size=v)).astype(np.float32)
    return rng.permutation(v).astype(np.float32)  # "shuffled": every label or distance distinct


@pytest.mark.parametrize("k", [4, 17])
@pytest.mark.parametrize("state", ["start", "midway", "shuffled"])
@pytest.mark.parametrize("kind,step", [("sssp", 1.0), ("wcc", 0.0)])
def test_min_sweep_on_cpu_equals_numpy_sweep(ordered, monkeypatch, kind, step, state, k):
    """A sweep through the wrapper from a chosen state, on a pack whose
    masked-off slots hold real ids (as a stream pack's), equals numpy's, and
    so does its stop flag; a CPU tensor never reaches the kernel."""
    g, _, _ = ordered
    rng = np.random.default_rng(k + len(state))
    data = E.pack_ordered(g.src, g.dst, g.num_vertices, k, device="cpu")
    edges, mask = data.edges.clone(), data.mask.clone()
    drop = torch.from_numpy(rng.random(tuple(mask.shape)) < 0.1)
    mask[drop] = 0.0
    off = mask <= 0
    edges[off] = torch.from_numpy(rng.integers(0, g.num_vertices, size=(int(off.sum()), 2)).astype(np.int32))
    x = _sweep_state(kind, state, g.num_vertices, rng)

    def no_kernel(name):
        raise AssertionError(f"a CPU sweep loaded the {name} kernel")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = min_sweep.launches
    nx, flags = min_sweep.min_sweep(edges, mask, torch.from_numpy(x), step)
    want, want_changed = _numpy_sweep(edges.numpy(), mask.numpy(), x, step)
    assert min_sweep.launches == before
    assert nx.dtype == torch.float32 and np.array_equal(nx.numpy(), want)
    assert min_sweep.changed(flags) == want_changed


def test_min_sweep_queries_on_cpu_never_launch(ordered, monkeypatch):
    """Whole SSSP and WCC queries on a CPU pack run the plain version:
    ``launches`` does not move and no kernel is built or loaded."""
    g, _, _ = ordered
    data = E.pack_ordered(g.src, g.dst, g.num_vertices, 8, device="cpu")

    def no_kernel(name):
        raise AssertionError(f"a CPU query loaded the {name} kernel")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = min_sweep.launches
    (_, it_s), (_, it_w) = E.sssp(data, source=int(g.src[0])), E.wcc(data)
    assert it_s > 1 and it_w > 1 and min_sweep.launches == before


@pytest.mark.parametrize("bad", ["edges-int64", "mask-shape", "x-2d", "x-non-contiguous", "edges-not-pairs"])
def test_min_sweep_wrapper_rejects_bad_input_on_cpu(bad):
    edges = torch.zeros((2, 5, 2), dtype=torch.int32)
    mask, x = torch.ones((2, 5)), torch.arange(8, dtype=torch.float32)
    if bad == "edges-int64":
        edges = edges.long()
    elif bad == "mask-shape":
        mask = torch.ones((2, 4))
    elif bad == "x-2d":
        x = x.reshape(2, 4)
    elif bad == "x-non-contiguous":
        x = torch.arange(16, dtype=torch.float32)[::2]
    else:
        edges = torch.zeros((2, 5, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        min_sweep.min_sweep(edges, mask, x, 1.0)
