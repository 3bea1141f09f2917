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
