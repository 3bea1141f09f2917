"""The port on the GPU: each CUDA kernel (segment_rf, edge_spmv,
flash_attention, decode_attention, full_reorder, rescale_migrate, min_sweep)
against its plain version, the paths on
the card against the same paths on the CPU, and the streaming engine's device
programs against their host mirrors and the ``pack_slots`` oracle, and the
multi-rank layout on the one card (ranks over gloo, one rank over NCCL), and
the serving front end on the card against the same queries and loop on the
CPU.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.compat import PAD_ID
from repro_torch.core import cep, metrics, ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic.rescale_exec import ElasticRescaler
from repro_torch.graphs import engine as E
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import edge_spmv, min_sweep, ops, packed_sort, ref, rescale_migrate, segment_rf
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import multihost as MH
from repro_torch.launch import sharding as SH

pytestmark = pytest.mark.cuda

# The parity cases of tests/test_kernels.py and edge cases; the five row
# shapes the paths count ((16, 1,962,714) the k = 16 pack, (4, 1,962,714) a
# rank's rows of it, (3, 2,944,512) path 3's span keys, (3, 798,720) and
# (2, 161,792) the full rung's and a span's keys over ranks); W % 4 of 1, 2
# and 3 (rows that start off a 16-byte boundary), W < 4 and C = 1.
SHAPES = [(4, 8), (16, 64), (7, 40), (33, 24), (13, 1000), (9, 4097), (5, 1), (1, 3 * 4096 + 1),
          (128, 240_000), (4, 7_500_000),
          (16, 1_962_714), (4, 1_962_714), (3, 2_944_512), (3, 798_720), (2, 161_792),
          (5, 40_002), (6, 40_003), (3, 2), (4, 3), (1, 1000), (1, 161_793)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ordered():
    g = rmat_graph(10, 8, seed=0)
    order = ordering.geo_order(g, seed=0)
    return g, g.src[order], g.dst[order]


def _rows(c, w, seed):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, 3 * w, size=(c, w)).astype(np.int32), axis=1)
    n_valid = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] >= n_valid[:, None]] = PAD_ID
    if c >= 3:  # fewer rows stay random
        rows[0] = PAD_ID  # an all-PAD row
        rows[1] = 7  # a single distinct id
    return rows


@pytest.mark.parametrize("c,w", SHAPES)
def test_kernel_matches_plain_version(cuda, c, w):
    rows = _rows(c, w, seed=c + w)
    t = torch.from_numpy(rows).to(cuda)
    before = segment_rf.launches
    got = segment_rf.segment_distinct_counts(t)
    torch.cuda.synchronize()
    assert segment_rf.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, segment_rf.segment_distinct_counts_torch(t))
    if c * w <= 1 << 16:
        assert np.array_equal(got.cpu().numpy(), ref.segment_distinct_counts_ref(rows, PAD_ID))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_takes_views_off_a_16_byte_boundary(cuda, offset):
    """A contiguous view whose data starts 4, 8 or 12 bytes past a 16-byte
    boundary: every row takes the kernel's scalar head."""
    rows = _rows(3, 40_000, seed=offset)
    buf = torch.full((rows.size + offset,), -5, dtype=torch.int32, device=cuda)
    t = buf[offset:].view(rows.shape)
    t.copy_(torch.from_numpy(rows).to(cuda))
    assert torch.equal(segment_rf.segment_distinct_counts(t), segment_rf.segment_distinct_counts_torch(t))


@pytest.mark.parametrize("bad", [torch.int64, "non-contiguous"])
def test_kernel_wrapper_rejects_bad_input(cuda, bad):
    if bad == "non-contiguous":
        t = torch.zeros((8, 4), dtype=torch.int32, device=cuda).t()
        with pytest.raises(ValueError):
            segment_rf.segment_distinct_counts(t)
    else:
        with pytest.raises(TypeError):
            segment_rf.segment_distinct_counts(torch.zeros((4, 8), dtype=bad, device=cuda))


@pytest.mark.parametrize("k", [4, 16, 17])
def test_pack_on_cuda_equals_pack_on_cpu_and_oracle(cuda, ordered, k):
    g, s, d = ordered
    got = E.pack_ordered(s, d, g.num_vertices, k)  # device=None means CUDA
    want = E.pack_ordered(s, d, g.num_vertices, k, device="cpu")
    assert got.edges.device.type == "cuda"
    for name in ("edges", "mask", "degrees"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert got.replication_factor == metrics.replication_factor_ordered(s, d, k, g.num_vertices)
    assert got.mirrors == metrics.mirror_count_ordered(s, d, k, g.num_vertices)
    assert ops.replication_factor_kernel(s, d, k, g.num_vertices) == got.replication_factor


def test_rescale_on_cuda_rechecks_through_the_kernel(cuda, ordered):
    """One launch of the migration kernel and one of ``segment_rf`` a
    re-checked rescale; the migration alone without the re-check."""
    g, s, d = ordered
    data = E.pack_ordered(s, d, g.num_vertices, 8)
    before, migrations = segment_rf.launches, rescale_migrate.launches
    new, stats = ElasticRescaler().rescale(data, 12, verify=True)
    assert (segment_rf.launches, rescale_migrate.launches) == (before + 1, migrations + 1)
    assert stats.oracle_checked and new.edges.device.type == "cuda"
    assert new.replication_factor == metrics.replication_factor_ordered(s, d, 12, g.num_vertices)
    back, _ = ElasticRescaler().rescale(new, 8, verify=True, recheck=False)
    assert (segment_rf.launches, rescale_migrate.launches) == (before + 1, migrations + 2)
    assert torch.equal(back.edges, data.edges) and torch.equal(back.mask, data.mask)


# ---------------------------------------------------------------- packed_sort
# (k, E_max, num_vertices, layout): a row under one tile, a row of exactly one
# tile (8,192 keys) and one past it, many short rows, every pass count (1 to
# 4), ids at num_vertices - 1, a hub of one id, rows already sorted.
SORT_CASES = [(3, 50, None, "random"), (2, 4096, 2**20, "random"), (3, 4097, 1, "random"), (5, 12_289, 2, "random"),
              (130, 9, 513, "random"), (4, 40_000, 2**22, "hub"), (4, 40_000, 2**16, "sorted"),
              (16, 200_000, 2**24, "top"), (3, 300_001, 2**31 - 1, "top"), (1, 1, 7, "random")]


@pytest.mark.parametrize("k,e_max,nv,layout", SORT_CASES)
def test_packed_sort_kernel_equals_torch_sort(cuda, k, e_max, nv, layout):
    gen = torch.Generator(device=cuda).manual_seed(k + e_max)
    hi = nv or 2**31 - 1
    edges = torch.randint(0, hi, (k, e_max, 2), dtype=torch.int32, device=cuda, generator=gen)
    if layout == "hub":
        edges[:, : e_max // 2] = hi - 1
    elif layout == "sorted":
        edges = torch.sort(edges.reshape(k, -1), dim=1).values.reshape(k, e_max, 2).contiguous()
    elif layout == "top":
        edges[:, ::5, 1] = hi - 1
    mask = (torch.rand((k, e_max), device=cuda, generator=gen) > 0.3).float()
    mask[0, e_max // 3 : e_max // 2] = 0.0  # slots masked out in the middle of a row
    if k > 2:
        mask[2] = 0.0  # a row with no valid slot
    launches, passes = packed_sort.launches, packed_sort.passes
    got = ops.packed_rows(edges, mask, nv)
    torch.cuda.synchronize()
    assert (packed_sort.launches, packed_sort.passes) == (launches + 1, passes + packed_sort.digit_passes(nv))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, packed_sort.packed_sort_torch(edges, mask))


def test_packed_sort_rejects_a_view_off_an_8_byte_boundary(cuda):
    buf = torch.zeros(2 * 10 * 2 + 1, dtype=torch.int32, device=cuda)
    edges = buf[1:].view(2, 10, 2)
    with pytest.raises(ValueError):
        packed_sort.packed_sort(edges, torch.ones((2, 10), device=cuda), 100)


def test_recheck_sorts_through_the_kernel_in_its_passes(cuda, ordered):
    """A re-checked rescale sorts its rows once on the card, in the passes its
    vertex count needs, and counts them in ``rescale.recheck.sort_passes``."""
    from repro_torch.obs import metrics as OM

    g, s, d = ordered
    data = E.pack_ordered(s, d, g.num_vertices, 8)
    registry = OM.MetricsRegistry()
    launches = packed_sort.launches
    ElasticRescaler(metrics_registry=registry).rescale(data, 12)
    assert packed_sort.launches == launches + 1
    assert registry.snapshot()["rescale.recheck.sort_passes"] == packed_sort.digit_passes(g.num_vertices)


# ------------------------------------------------------------ rescale_migrate
def _migrate_program(n, k_old, k_new, g, rank, device):
    """Rank ``rank`` of ``g``'s migration program on ``device`` (the table is
    built from the plan alone; no process group is needed)."""
    from repro_torch.launch.mesh import GraphGroup, make_graph_group

    group = make_graph_group(device) if g == 1 else GraphGroup(size=g, rank=rank, device=str(device),
                                                                backend="gloo", processes=(0,) * g)
    plan = cep.scale_plan(n, k_old, k_new)
    return ElasticRescaler()._program(n, k_old, k_new, plan, group, torch.device(device))


# (n, k_old, k_new, g, rank, offset of the old view in edges, of the new one):
# E_max at k_new odd (every other row starts 8 bytes off a 16-byte boundary,
# so segments' source and destination parities differ) and even; a
# single-row plan; padded rows (k_new not a multiple of g) with receive
# ranges; views 8 bytes off a 16-byte boundary; RMAT-20's 16 -> 17.
MIGRATE_CASES = [(100_003, 16, 17, 1, 0, 0, 0), (100_000, 8, 12, 1, 0, 0, 0), (100_000, 12, 8, 1, 0, 0, 0),
                 (99_999, 5, 1, 1, 0, 0, 0), (100_003, 7, 5, 4, 1, 0, 0), (100_003, 6, 9, 4, 3, 0, 0),
                 (100_003, 16, 17, 1, 0, 1, 0), (100_003, 16, 17, 1, 0, 0, 1), (100_001, 3, 7, 2, 1, 1, 1),
                 (13, 2, 18, 1, 0, 0, 0), (15_701_711, 16, 17, 1, 0, 0, 0)]


@pytest.mark.parametrize("n,k_old,k_new,g,rank,old_off,new_off", MIGRATE_CASES,
                         ids=["odd-E_max", "even-E_max", "12to8", "single-row", "padded-rows-recv",
                              "padded-rows-g4", "old-view-off-16B", "new-view-off-16B", "both-views-off",
                              "past-E", "rmat20-16to17"])
def test_migrate_kernel_equals_plain_version(cuda, n, k_old, k_new, g, rank, old_off, new_off):
    """Byte for byte, edges and mask, with the blocks filled with a sentinel
    first: every slot the plain version writes the kernel writes the same,
    and the receive ranges keep the sentinel in both."""
    prog = _migrate_program(n, k_old, k_new, g, rank, cuda)
    t = prog.table
    m_old = SH.padded_partition_count(k_old, g) // g
    e_old = int(np.diff(cep.chunk_bounds(n, k_old)).max())
    gen = torch.Generator(device=cuda).manual_seed(n + k_new)
    buf = torch.randint(-2**30, 2**30, (m_old * e_old * 2 + 2 * old_off,), dtype=torch.int32, device=cuda,
                        generator=gen)
    old = buf[2 * old_off:].view(m_old, e_old, 2)
    outs = []
    for fn in (rescale_migrate.migrate, rescale_migrate.migrate_torch):
        e = torch.full((t.rows * t.width * 2 + 2 * new_off,), -7, dtype=torch.int32, device=cuda)
        m = torch.full((t.rows * t.width + new_off,), -7.0, device=cuda)
        out = (e[2 * new_off:].view(t.rows, t.width, 2), m[new_off:].view(t.rows, t.width))
        before = rescale_migrate.launches
        assert fn(old, t, out=out)[0].data_ptr() == out[0].data_ptr()
        assert rescale_migrate.launches == before + (fn is rescale_migrate.migrate)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    left = sum(b - a for _, _, a, b, _ in prog.recvs)
    assert int((outs[0][0] == -7).all(dim=2).sum()) == left and (left > 0) == bool(prog.recvs)
    assert not bool((outs[0][1] == -7.0).any())


def test_migrate_kernel_allocates_its_outputs(cuda, ordered):
    g, s, d = ordered
    data = E.pack_ordered(s, d, g.num_vertices, 8)
    t = _migrate_program(len(s), 8, 12, 1, 0, cuda).table
    edges, mask = rescale_migrate.migrate(data.edges, t)
    want_edges, want_mask = E.host_pack(s, d, 12)
    assert edges.cpu().numpy().tobytes() == want_edges.tobytes() and mask.cpu().numpy().tobytes() == want_mask.tobytes()


@pytest.mark.parametrize("bad", ["int64", "too-narrow", "non-contiguous", "table-on-cpu", "out-dtype"])
def test_migrate_wrapper_rejects_bad_input(cuda, bad):
    t = _migrate_program(1000, 4, 5, 1, 0, cuda).table
    old = torch.zeros((4, 250, 2), dtype=torch.int32, device=cuda)
    out = None
    exc = ValueError
    if bad == "int64":
        old, exc = old.long(), TypeError
    elif bad == "too-narrow":
        old = old[:, :200].contiguous()
    elif bad == "non-contiguous":
        old = torch.zeros((4, 250, 2, 2), dtype=torch.int32, device=cuda)[..., 0]
    elif bad == "table-on-cpu":
        t = _migrate_program(1000, 4, 5, 1, 0, "cpu").table
    else:
        out = (torch.zeros((5, 200, 2), dtype=torch.int32, device=cuda), torch.zeros((5, 200), device=cuda).double())
    before = rescale_migrate.launches
    with pytest.raises(exc):
        rescale_migrate.migrate(old, t, out=out)
    assert rescale_migrate.launches == before


def test_migrate_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses raises with the CUDA error's string and
    counts nothing: here the C entry point returns cudaErrorInvalidValue (1),
    what it returns for a grid it cannot launch. Nothing falls back to the
    plain version."""
    rescale_migrate._kernel()
    monkeypatch.setattr(rescale_migrate, "_fn", lambda *args: 1)
    t = _migrate_program(1000, 4, 5, 1, 0, cuda).table
    before = rescale_migrate.launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        rescale_migrate.migrate(torch.zeros((4, 250, 2), dtype=torch.int32, device=cuda), t)
    assert rescale_migrate.launches == before


def test_apps_on_cuda_match_cpu(cuda, ordered):
    g, s, d = ordered
    gpu = E.pack_ordered(s, d, g.num_vertices, 8)
    cpu = E.pack_ordered(s, d, g.num_vertices, 8, device="cpu")
    # CUDA scatter-add uses atomics, so the f32 sums run in another order.
    torch.testing.assert_close(E.pagerank(gpu).cpu(), E.pagerank(cpu), rtol=1e-5, atol=1e-7)
    for app in (E.sssp, E.wcc):
        (x_gpu, it_gpu), (x_cpu, it_cpu) = app(gpu), app(cpu)
        assert it_gpu == it_cpu and torch.equal(x_gpu.cpu(), x_cpu)


# ----------------------------------------------------------------- min_sweep
def _hub_graph(spokes: int, seed: int):
    """A star of ``spokes`` leaves around vertex 0 over a sparse random
    graph: one hub whose slots lie side by side in the order."""
    rng = np.random.default_rng(seed)
    v = spokes + 1
    a, b = rng.integers(1, v, size=(2, 4 * spokes))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    pairs = np.unique(np.stack([np.concatenate([np.zeros(spokes, np.int64), lo[lo != hi]]),
                                np.concatenate([np.arange(1, v), hi[lo != hi]])], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), v


def _sweep_case(case: str, k: int, layout: str):
    """``(edges, mask, V)`` on the CPU: an RMAT graph with hubs or a star,
    GEO-ordered and packed at k; ``stream``: a tenth of the slots masked off
    and every masked-off slot holding real ids."""
    if case == "star":
        src, dst, v = _hub_graph(5_000, seed=k)
    else:
        scale = int(case[4:])
        g = rmat_graph(scale, 16, seed=scale)
        order = ordering.geo_order(g, seed=0)
        src, dst, v = g.src[order], g.dst[order], g.num_vertices
    data = E.pack_ordered(src, dst, v, k, device="cpu")
    edges, mask = data.edges, data.mask
    rng = np.random.default_rng(k)
    if layout == "stream":
        edges, mask = edges.clone(), mask.clone()
        mask[torch.from_numpy(rng.random(tuple(mask.shape)) < 0.1)] = 0.0
        off = mask <= 0
        edges[off] = torch.from_numpy(rng.integers(0, v, size=(int(off.sum()), 2)).astype(np.int32))
    return edges, mask, v


def _off_boundary(t: torch.Tensor, elements: int) -> torch.Tensor:
    buf = torch.zeros(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:].view(t.shape)
    view.copy_(t)
    return view


MIN_SWEEP_CASES = [("rmat12", 4, "pack"), ("rmat12", 17, "pack"), ("rmat12", 128, "stream"),
                   ("rmat14", 1, "pack"), ("rmat14", 16, "stream"), ("rmat14", 64, "pack"),
                   ("star", 4, "pack"), ("star", 7, "pack"), ("star", 16, "stream")]


@pytest.mark.parametrize("case,k,layout", MIN_SWEEP_CASES)
@pytest.mark.parametrize("kind,step", [("sssp", 1.0), ("wcc", 0.0)])
def test_min_sweep_kernel_equals_plain_version(cuda, case, k, layout, kind, step):
    """Every sweep of a whole SSSP (from the highest-degree vertex) or WCC
    query through the kernel against the plain version on the CPU from the
    same state: x, nx and the stop flag exactly equal, so the answers and the
    sweep counts are too."""
    edges, mask, v = _sweep_case(case, k, layout)
    g_edges, g_mask = edges.to(cuda), mask.to(cuda)
    if kind == "sssp":
        deg = torch.bincount(edges[mask > 0].reshape(-1).long(), minlength=v)
        x = torch.full((v,), 1e9)
        x[int(deg.argmax())] = 0.0
    else:
        x = torch.arange(v, dtype=torch.float32)
    sweeps, changed = 0, True
    while changed and sweeps < 64:
        before = min_sweep.launches
        nx, flags = min_sweep.min_sweep(g_edges, g_mask, x.to(cuda), step)
        changed = min_sweep.changed(flags)
        assert min_sweep.launches == before + 1
        want, want_flags = min_sweep.min_sweep_torch(edges, mask, x, step)
        assert torch.equal(nx.cpu().view(torch.int32), want.view(torch.int32)), (sweeps, (nx.cpu() != want).sum())
        assert changed == bool(want_flags)
        x, sweeps = want, sweeps + 1
    assert 1 < sweeps < 64
    (got, got_it), (want, want_it) = (
        E.sssp(d, source=int(x.argmin())) if kind == "sssp" else E.wcc(d)
        for d in (E.engine_data_from_arrays(edges.numpy(), mask.numpy(), np.zeros(v, np.float32), num_vertices=v,
                                            k=edges.shape[0], mirrors=0, replication_factor=0.0,
                                            num_edges=int((mask > 0).sum()), device=dev) for dev in (cuda, "cpu")))
    assert got_it == want_it and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["sssp", "wcc", "sssp-program"])
def test_min_sweep_query_on_cuda_launches_once_a_sweep(cuda, ordered, kind):
    """A query on a card's pack goes through the kernel: ``launches`` rises
    by its sweep count, and the answer equals the CPU pack's."""
    g, s, d = ordered
    assert 5 in s or 5 in d  # the source has an edge
    gpu = E.pack_ordered(s, d, g.num_vertices, 8)
    cpu = E.pack_ordered(s, d, g.num_vertices, 8, device="cpu")
    before = min_sweep.launches
    if kind == "sssp-program":
        program = E.query_program("sssp", num_vertices=g.num_vertices)
        (x, it), (want, want_it) = program(gpu.edges, gpu.mask, 5), program(cpu.edges, cpu.mask, 5)
    else:
        app = (lambda d: E.sssp(d, source=5)) if kind == "sssp" else E.wcc
        (x, it), (want, want_it) = app(gpu), app(cpu)
    assert it > 1 and min_sweep.launches == before + it
    assert it == want_it and torch.equal(x.cpu(), want)


@pytest.mark.parametrize("bad", ["edges-int64", "mask-on-cpu", "x-float64", "mask-shape", "edges-non-contiguous",
                                 "x-non-contiguous", "edges-off-boundary", "mask-off-boundary", "id-past-V"])
def test_min_sweep_wrapper_rejects_bad_input(cuda, bad):
    edges = torch.randint(0, 50, (4, 100, 2), dtype=torch.int32, device=cuda)
    mask = torch.ones((4, 100), device=cuda)
    x = torch.arange(50, dtype=torch.float32, device=cuda)
    if bad == "edges-int64":
        edges = edges.long()
    elif bad == "mask-on-cpu":
        mask = mask.cpu()
    elif bad == "x-float64":
        x = x.double()
    elif bad == "mask-shape":
        mask = mask[:, :99].contiguous()
    elif bad == "edges-non-contiguous":
        edges = edges.transpose(0, 1)
    elif bad == "x-non-contiguous":
        x = torch.arange(100, dtype=torch.float32, device=cuda)[::2]
    elif bad == "edges-off-boundary":  # 8 bytes off: the 16-byte loads need the boundary
        edges = _off_boundary(edges, 2)
    elif bad == "mask-off-boundary":
        mask = _off_boundary(mask, 1)
    else:  # a slot with mask 1 names vertex 50 of 50: the kernel skips it and the flag says so
        edges[2, 7, 1] = 50
        before = min_sweep.launches
        nx, flags = min_sweep.min_sweep(edges, mask, x, 0.0)
        assert min_sweep.launches == before + 1
        with pytest.raises(ValueError, match="outside"):
            min_sweep.changed(flags)
        return
    before = min_sweep.launches
    with pytest.raises((TypeError, ValueError)):
        min_sweep.min_sweep(edges, mask, x, 1.0)
    assert min_sweep.launches == before


# ----------------------------------------------------------------- edge_spmv
# The kernel adds with atomics: its f32 sums run in an order that changes
# from run to run, hence 1e-5 and not equality.
@pytest.mark.parametrize("c,we,wv", [(2, 16, 32), (5, 64, 128), (3, 128, 256), (1, 1, 8), (4, 50, 16),
                                     (16, 200_000, 1 << 16)])
def test_edge_spmv_kernel_matches_plain_version(cuda, c, we, wv):
    rng = np.random.default_rng(c + we)
    ids = [torch.from_numpy(rng.integers(-2, wv + 3, size=(c, we)).astype(np.int32)).to(cuda) for _ in range(2)]
    w = torch.from_numpy(rng.random((c, we)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.random((c, wv)).astype(np.float32)).to(cuda)
    before = edge_spmv.launches
    got = edge_spmv.spmv_blocked(*ids, w, x)
    torch.cuda.synchronize()
    assert edge_spmv.launches == before + 1
    torch.testing.assert_close(got, edge_spmv.spmv_blocked_torch(*ids, w, x), rtol=1e-5, atol=1e-5)


def _dst_layout(layout, rng, c, we, wv):
    if layout.startswith("hub"):  # one dst in every slot: one run across warps and blocks
        return np.full((c, we), 7)
    if layout == "alternating":  # no two neighbours share a dst
        return np.broadcast_to(np.arange(we) % 2 * 5 + 3, (c, we))
    if layout == "padding":  # every slot is padding
        return np.full((c, we), wv)
    if layout == "outside":  # ids below 0 and at or past W_V, in runs
        return np.sort(rng.integers(-wv, 2 * wv, size=(c, we)), axis=1)
    return np.sort(rng.integers(0, wv, size=(c, we)), axis=1)  # "sorted": runs, as GEO order makes


# A block tile is 1,024 edge slots, one block a tile up to 65,536 tiles: a
# chunk of W_E 4,097 spans 5 blocks, and 70,000 one-tile chunks make the first
# blocks stride to a second chunk. W_E 981 is odd, so most rows start off a
# 16-byte boundary.
@pytest.mark.parametrize("layout,c,we,wv", [("hub", 3, 5_001, 512), ("hub-integer", 3, 5_001, 512),
                                            ("alternating", 2, 9_999, 512),
                                            ("padding", 4, 3_000, 256), ("outside", 3, 4_097, 64),
                                            ("sorted", 5, 981, 100), ("sorted", 400, 4_097, 1024),
                                            ("sorted", 70_000, 3, 8)],
                         ids=["hub", "hub-integer", "alternating", "all-padding", "ids-outside", "odd-W_E",
                              "many-chunks", "grid-strides"])
def test_edge_spmv_kernel_on_run_layouts(cuda, layout, c, we, wv):
    rng = np.random.default_rng(we)
    src = torch.from_numpy(rng.integers(0, wv, size=(c, we)).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(np.ascontiguousarray(_dst_layout(layout, rng, c, we, wv), dtype=np.int32)).to(cuda)
    # hub-integer: integers in [-8, 8], so every partial sum of the 5,001
    # products (|Σ| ≤ 5,001·64 < 2²⁴) is exact in f32 in any order.
    draw = (lambda shape: rng.integers(-8, 9, size=shape)) if layout == "hub-integer" else rng.standard_normal
    w = torch.from_numpy(draw((c, we)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(draw((c, wv)).astype(np.float32)).to(cuda)
    before = edge_spmv.launches
    got = edge_spmv.spmv_blocked(src, dst, w, x)
    torch.cuda.synchronize()
    assert edge_spmv.launches == before + 1
    if layout == "hub":
        # 5,001 products reach one element through atomics in a varying
        # order: held against their float64 sum with a bound that holds for
        # any order of the f32 additions.
        _assert_within_summation_bound(got, src, dst, w, x)
    elif layout == "hub-integer":
        # Exact: one product dropped or added twice changes the sum.
        exact, _, _ = _float64_sums(src, dst, w, x)
        np.testing.assert_array_equal(got.double().cpu().numpy().reshape(-1), exact)
    else:
        torch.testing.assert_close(got, edge_spmv.spmv_blocked_torch(src, dst, w, x), rtol=1e-5, atol=1e-5)
    if layout == "padding":
        assert not bool(got.any())  # exact zeros


def _float64_sums(src, dst, w, x):
    """Per flat output element: the float64 sum of the float64 products that
    reach it, the sum of their magnitudes, and their number."""
    s, d = src.long().cpu().numpy(), dst.long().cpu().numpy()
    wv, xv = w.double().cpu().numpy(), x.double().cpu().numpy()
    c, w_v = xv.shape
    rows = np.broadcast_to(np.arange(c)[:, None], s.shape)
    ok = (s >= 0) & (s < w_v) & (d >= 0) & (d < w_v)
    flat = (rows * w_v + d)[ok]
    prod = wv[ok] * xv[rows[ok], s[ok]]
    size = c * w_v
    return (np.bincount(flat, weights=prod, minlength=size), np.bincount(flat, weights=np.abs(prod), minlength=size),
            np.bincount(flat, minlength=size))


def _assert_within_summation_bound(got, src, dst, w, x):
    """|got − exact| ≤ n·2⁻²⁴·Σ|wᵢ·xᵢ|·(1 + n·2⁻²⁴) + 1e-30 per element, where
    exact is the float64 sum of the float64 products of the same terms and n
    the number of slots that reach the element: (n − 1) roundings of the f32
    additions, in any order, and one rounding of each f32 product."""
    exact, mag, n = _float64_sums(src, dst, w, x)
    u = 2.0**-24
    bound = n * u * mag * (1 + n * u) + 1e-30
    err = np.abs(got.double().cpu().numpy().reshape(-1) - exact)
    assert (err <= bound).all(), f"max err/bound {float((err / bound).max()):.3f} at n = {int(n.max())}"


@pytest.mark.parametrize("window", ["full", 32, "past-V"])
def test_device_packing_on_cuda_equals_cpu(cuda, ordered, window):
    g, s, d = ordered
    v = g.num_vertices
    bounds = np.asarray(cep.chunk_bounds(len(s), 8))
    if window == "full":
        starts, size = [0] * 8, v
    else:
        starts, size = [int(np.clip(s[bounds[i]:bounds[i + 1]].min(), 0, v - 32)) for i in range(8)], 32
        if window == "past-V":
            starts[-1] = v
    w = np.random.default_rng(2).random(len(s)).astype(np.float32)
    got = ops.pack_windows_device(s, d, w, bounds, starts, size)  # device=None means CUDA
    want = ops.pack_windows_device(s, d, w, bounds, starts, size, device="cpu")
    for a, b, c in zip(got, want, ops.pack_windows(s, d, w, bounds, starts, size)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes() == c.tobytes()


@pytest.mark.parametrize("window", ["full", 32])
def test_chunked_spmv_on_cuda_matches_cpu(cuda, ordered, window):
    g, s, d = ordered
    v = g.num_vertices
    bounds = np.asarray(cep.chunk_bounds(len(s), 8))
    if window == "full":
        starts, size = [0] * 8, v
    else:
        starts, size = [int(np.clip(s[bounds[i]:bounds[i + 1]].min(), 0, v - 32)) for i in range(8)], 32
    x = np.random.default_rng(0).random(v).astype(np.float32)
    w = np.random.default_rng(1).random(len(s)).astype(np.float32)
    before = edge_spmv.launches
    got = ops.chunked_spmv(s, d, w, x, bounds, starts, size)
    assert edge_spmv.launches == before + 1 and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), ops.chunked_spmv(s, d, w, x, bounds, starts, size, device="cpu"),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- flash attention
FLASH_CASES = [(1, 2, 128, 64, None, None, True), (2, 1, 256, 32, None, None, True),
               (1, 2, 256, 64, 128, None, True), (1, 1, 128, 64, None, 30.0, True),
               (2, 2, 384, 128, 256, 50.0, True), (1, 1, 128, 32, None, None, False),
               (1, 2, 512, 256, 100, 50.0, True), (1, 1, 100, 32, 7, None, True),
               (1, 2, 1000, 128, None, None, True), (1, 1, 777, 256, 300, 50.0, True),
               # head dims the kernels are not built for, zero-padded by the wrapper (96 → 128, 16 → 32)
               (1, 2, 256, 96, None, None, True), (1, 2, 300, 96, 64, 50.0, True),
               (2, 1, 128, 16, None, None, True), (1, 2, 200, 16, 50, 30.0, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,window,softcap,causal", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda, b, h, s, d, window, softcap, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype) for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before, tc_before = fa.launches, fa.tc_launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    # bf16 runs on the tensor-core kernel, f32 on the CUDA-core kernel.
    assert fa.tc_launches == tc_before + (dtype == torch.bfloat16)
    # Both sides are f32 sums rounded to the output type: in bf16 they may
    # differ by one rounding step (2^-7 of the value), plus slack near zero.
    rtol, atol = (2**-7, 1e-4) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), fa.flash_attention_torch(q, k, v, **kw).float(), rtol=rtol, atol=atol)


# ---------------------------------------------------------- decode attention
DECODE_CASES = [(2, 4, 512, 64, 128, None, "f32", None), (1, 1, 1024, 32, 256, None, "f32", None),
                (3, 8, 256, 128, 256, None, "f32", [0, 100, 256]), (2, 4, 512, 128, 128, 20.0, "f32", None),
                (4, 4, 2048, 128, 512, None, "bf16", [1, 700, 1536, 2048]), (2, 5, 256, 256, 64, None, "bf16", None),
                (4, 4, 2048, 96, 512, None, "bf16", [1, 700, 1536, 2048]), (2, 4, 512, 96, 128, 20.0, "f32", None),
                (3, 4, 512, 16, 128, None, "f32", [0, 77, 512]), (2, 4, 512, 16, 256, None, "bf16", None)]


@pytest.mark.parametrize("bh,gq,s,d,block_s,softcap,kv_dtype,cache", DECODE_CASES)
def test_decode_kernel_matches_plain_version(cuda, bh, gq, s, d, block_s, softcap, kv_dtype, cache):
    gen = torch.Generator(device=cuda).manual_seed(bh * 100 + s)
    kvt = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
    q = torch.randn((bh, gq, d), generator=gen, device=cuda)
    k, v = (torch.randn((bh, s, d), generator=gen, device=cuda).to(kvt) for _ in range(2))
    cl = torch.randint(1, s + 1, (bh,), generator=gen, device=cuda, dtype=torch.int32) if cache is None else \
        torch.tensor(cache, dtype=torch.int32, device=cuda)
    before = dec.launches
    got = dec.decode_attention_partials(q, k, v, cl, block_s=block_s, softcap=softcap)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    want = dec.decode_attention_partials_torch(q, k, v, cl, scale=d**-0.5, block_s=block_s, softcap=softcap)
    for name, g_, w_ in zip("oml", got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4, msg=name)
    torch.testing.assert_close(dec.merge_partials(*got)[0], dec.merge_partials(*want)[0], rtol=1e-4, atol=1e-4)


# The merged path: the split kernel over the keys below cache_len, then the
# combine kernel; merge_partials must not run. cache_len covers an empty row
# (the mean of v), one key, a split boundary and its neighbours, and a full row.
S_MERGED = 3 * dec.SPLIT
MERGED_CACHE = [0, 1, dec.SPLIT - 1, dec.SPLIT, dec.SPLIT + 1, S_MERGED]


def _merged_case(cuda, monkeypatch, d, kv_dtype, gq, q_dtype, softcap=None, cache=MERGED_CACHE, s=S_MERGED,
                 shifted=False):
    gen = torch.Generator(device=cuda).manual_seed(d * 10 + gq)
    bh = len(cache)
    q = torch.randn((bh, gq, d), generator=gen, device=cuda).to(q_dtype)
    if shifted:
        k, v = (_shifted((bh, s, d), kv_dtype, gen, cuda) for _ in range(2))
    else:
        k, v = (torch.randn((bh, s, d), generator=gen, device=cuda).to(kv_dtype) for _ in range(2))
    cl = torch.tensor(cache, dtype=torch.int32, device=cuda)
    plain = dec.merge_partials
    want = plain(*dec.decode_attention_partials_torch(q, k, v, cl, scale=d**-0.5, block_s=512 if s % 512 == 0 else s,
                                                      softcap=softcap))[0]

    def no_merge(*a, **kw):
        raise AssertionError("the CUDA path must merge on the card, not through merge_partials")

    monkeypatch.setattr(dec, "merge_partials", no_merge)
    before, merges_before = dec.launches, dec.merge_launches
    got = dec.decode_attention(q, k, v, cl, softcap=softcap)
    torch.cuda.synchronize()
    assert dec.launches == before + 1 and dec.merge_launches == merges_before + 1
    assert got.shape == (bh, gq, d) and got.dtype == torch.float32 and got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if cache[0] == 0:  # an empty cache decodes to the mean of all of v
        torch.testing.assert_close(got[0], v[0].float().mean(0).expand(gq, d), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [16, 96, 128, 256])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_merged_kernels_match_plain_version(cuda, monkeypatch, d, kv_dtype):
    gq = {16: 1, 96: 5, 128: 8, 256: 8}[d]
    q_dtype = torch.bfloat16 if (d // 16 + (kv_dtype == torch.float32)) % 2 else torch.float32
    _merged_case(cuda, monkeypatch, d, kv_dtype, gq, q_dtype)


@pytest.mark.parametrize("gq", [1, 4, 5, 8, 12])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["q-f32", "q-bf16"])
def test_decode_merged_kernels_across_query_heads(cuda, monkeypatch, gq, q_dtype):
    _merged_case(cuda, monkeypatch, 128, torch.bfloat16, gq, q_dtype, softcap=30.0 if gq == 5 else None)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_merged_kernels_take_unaligned_kv(cuda, monkeypatch, kv_dtype):
    _merged_case(cuda, monkeypatch, 64, kv_dtype, 4, torch.float32, shifted=True)


def test_decode_merged_kernels_combine_more_than_32_splits(cuda, monkeypatch):
    """The combine kernel walks a row's splits 32 at a time."""
    s = 40 * dec.SPLIT
    _merged_case(cuda, monkeypatch, 128, torch.bfloat16, 4, torch.bfloat16, cache=[0, 33 * dec.SPLIT + 5, s], s=s)


def test_decode_both_entry_points_past_65535_rows(cuda):
    """70,000 cache rows: the split kernel's rows stride past the grid's y limit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    bh, s, d = 70_000, 64, 32
    q = torch.randn((bh, 2, d), generator=gen, device=cuda)
    k, v = (torch.randn((bh, s, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    cl = torch.randint(0, s + 1, (bh,), generator=gen, device=cuda, dtype=torch.int32)
    want = dec.decode_attention_partials_torch(q, k, v, cl, scale=d**-0.5, block_s=32)
    got = dec.decode_attention_partials(q, k, v, cl, block_s=32)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec.decode_attention(q, k, v, cl, block_s=32), dec.merge_partials(*want)[0],
                               rtol=1e-4, atol=1e-4)


def test_decode_wrapper_rejects_tiles_beyond_shared_memory(cuda):
    q, k = torch.zeros((1, 8, 64), device=cuda), torch.zeros((1, 1 << 14, 64), device=cuda)
    with pytest.raises(ValueError):
        dec.decode_attention_partials(q, k, k, torch.ones(1, dtype=torch.int32, device=cuda), block_s=1 << 14)


# ---------------------------- operands the wrappers copy instead of refusing
def _shifted(shape, dtype, gen, device):
    """A contiguous tensor whose data start one element past an allocation,
    so not on a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.randn(n + 1, generator=gen, device=device).to(dtype)
    t = base[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


def test_flash_takes_unaligned_bf16_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_shifted((1, 2, 256, 64), torch.bfloat16, gen, cuda) for _ in range(3))
    before = fa.tc_launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.tc_launches == before + 1
    torch.testing.assert_close(got.float(), fa.flash_attention_torch(q, k, v).float(), rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_takes_unaligned_kv(cuda, kv_dtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((2, 4, 64), generator=gen, device=cuda)
    k, v = (_shifted((2, 512, 64), kv_dtype, gen, cuda) for _ in range(2))
    cl = torch.tensor([300, 512], dtype=torch.int32, device=cuda)
    got = dec.decode_attention_partials(q, k, v, cl, block_s=128)
    want = dec.decode_attention_partials_torch(q, k, v, cl, scale=64**-0.5, block_s=128)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


def test_head_dims_above_256_still_raise(cuda):
    q = torch.zeros((1, 1, 64, 288), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    kv = torch.zeros((1, 128, 320), device=cuda)
    with pytest.raises(ValueError):
        dec.decode_attention_partials(torch.zeros((1, 2, 320), device=cuda), kv, kv,
                                      torch.ones(1, dtype=torch.int32, device=cuda), block_s=128)


# ------------------------------------------------ streaming: device twins + engine
def _stream_slots(case: str):
    """(u, v, valid, num_vertices) slot arrays: a drifted RMAT stream with
    dead slots, a star (every greedy priority ties) and a ring with gaps."""
    from repro_torch.stream import IncrementalOrderer, SyntheticStream

    if case == "drifted":
        g = rmat_graph(9, 8, seed=0)
        order = ordering.geo_order(g, seed=0)
        o = IncrementalOrderer(g.src[order], g.dst[order], g.num_vertices, regions=4)
        stream = SyntheticStream(g, batch_size=256, delete_frac=0.3, seed=5)
        for _ in range(4):
            o.apply(stream.batch())
        valid = o.slot_valid.copy()
        valid[::7] = False
        return o.slot_src * valid, o.slot_dst * valid, valid, g.num_vertices
    if case == "star":
        n = 500
        u, v = np.zeros(n, np.int64), np.arange(1, n + 1, dtype=np.int64)
        valid = np.arange(n) % 9 != 4
        return u * valid, v * valid, valid, n + 1
    n = 700
    u = np.arange(n, dtype=np.int64)
    v = (u + 1) % n
    u, v = np.minimum(u, v), np.maximum(u, v)
    valid = np.arange(n) % 3 != 1
    return u * valid, v * valid, valid, n


@pytest.mark.parametrize("case", ["drifted", "star", "ring"])
def test_stream_device_twins_on_cuda_equal_host_mirrors(cuda, case):
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK

    u, v, valid, nv = _stream_slots(case)
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (u, v))
    vd = torch.from_numpy(valid).to(cuda)
    n = int(valid.sum())
    ks = SRK.eval_ks(4, 128)
    np.testing.assert_array_equal(SRK.span_order_device(ut, vt, vd, nv).cpu().numpy(),
                                  SRK.span_order_host(u, v, valid, nv))
    for cand in (SRK.identity_candidate(valid), SRK.span_order_host(u, v, valid, nv)[::-1].copy()):
        ct = torch.from_numpy(cand).to(cuda)
        for use_pallas in (False, True):
            got = SRK.span_objective_device(ut, vt, vd, ct, vd.sum(), ks, use_pallas=use_pallas)
            assert int(got) == SRK.span_objective_host(u, v, valid, cand, ks)
        np.testing.assert_array_equal(
            SRK.select_span_order_device(ut, vt, vd, nv, ct, ks, use_pallas=True).cpu().numpy(),
            SRK.select_span_order_host(u, v, valid, nv, cand, ks)[0])
    for regions in (1, 3):
        spr = -(-len(u) // regions)
        np.testing.assert_array_equal(
            SRK.splice_targets_device(torch.tensor(n, device=cuda), regions, spr, regions * spr).cpu().numpy(),
            SRK.splice_targets_device(torch.tensor(n), regions, spr, regions * spr).numpy())
    deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
    alpha, beta, delta = FRK.greedy_params(n, 4, 128, int(deg.max()))
    permpos = FRK.fallback_positions(nv)
    pt = torch.from_numpy(permpos.astype(np.int32)).to(cuda)
    host, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    np.testing.assert_array_equal(
        FRK.full_order_device(ut, vt, vd, nv, alpha, beta, delta, pt, steps=steps).cpu().numpy(), host)
    ks_full = FRK.eval_ks_full(4, 128, 4)
    cand = FRK.identity_candidate(valid)
    chosen, _, steps = FRK._select_full_order_host(u, v, valid, nv, cand, ks_full, alpha, beta, delta, permpos)
    got = FRK.select_full_order_device(ut, vt, vd, nv, torch.from_numpy(cand).to(cuda), ks_full, alpha, beta,
                                       delta, pt, use_pallas=True, steps=steps)
    np.testing.assert_array_equal(got.cpu().numpy(), chosen)


def test_stream_select_launches_segment_rf_twice(cuda):
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK

    u, v, valid, nv = _stream_slots("drifted")
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (u, v))
    vd = torch.from_numpy(valid).to(cuda)
    cand = torch.from_numpy(SRK.identity_candidate(valid)).to(cuda)
    before = segment_rf.launches
    SRK.select_span_order_device(ut, vt, vd, nv, cand, SRK.eval_ks(4, 128), use_pallas=True)
    assert segment_rf.launches == before + 2
    SRK.select_span_order_device(ut, vt, vd, nv, cand, SRK.eval_ks(4, 128), use_pallas=False)
    assert segment_rf.launches == before + 2
    n = int(valid.sum())
    deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
    alpha, beta, delta = FRK.greedy_params(n, 4, 128, int(deg.max()))
    permpos = FRK.fallback_positions(nv)
    pt = torch.from_numpy(permpos.astype(np.int32)).to(cuda)
    _, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    FRK.select_full_order_device(ut, vt, vd, nv, cand, FRK.eval_ks_full(4, 128, 4), alpha, beta, delta, pt,
                                 use_pallas=True, steps=steps)
    torch.cuda.synchronize()
    assert segment_rf.launches == before + 4


def _path4_slots():
    """Path 4's size: RMAT-14 (edge factor 16) as live slots, objective k in [4, 32]."""
    g = rmat_graph(14, 16, seed=0)
    return g.src.astype(np.int64), g.dst.astype(np.int64), np.ones(g.num_edges, bool), g.num_vertices


def _greedy_slots(case: str):
    """(u, v, valid, nv, k_min, k_max) of a greedy case: the stream cases
    and path 4's (one CTA); "rmat16", the smoke's RMAT-16 (65,536 vertices:
    a cluster, its state in distributed shared memory); "past-one-cta",
    30,000 vertices, just past one CTA's shared memory (a cluster of 2);
    "wide-ids", 2,000 random edges over ids up to 400,000 (past 16 CTAs'
    shared memory: the state in global memory); "hub", a vertex joined to
    every 97th of 300,000, its spokes joined in a ring (a cluster of 14 or
    more, the hub's list over every rank's share)."""
    if case in ("drifted", "star", "ring"):
        return (*_stream_slots(case), 4, 128)
    if case in ("path4", "rmat16"):
        g = rmat_graph(14 if case == "path4" else 16, 16, seed=0)
        return (g.src.astype(np.int64), g.dst.astype(np.int64), np.ones(g.num_edges, bool), g.num_vertices,
                4 if case == "path4" else 26, 32)
    rng = np.random.default_rng(11)
    if case == "past-one-cta":
        nv = 30_000
        e = rng.integers(0, nv, size=(60_000, 2))
    elif case == "wide-ids":
        nv = 400_000
        e = rng.integers(0, nv, size=(2_000, 2))
    else:
        nv = 300_000
        spokes = np.arange(1, 3_001, dtype=np.int64) * 97
        e = np.concatenate([np.stack([np.zeros_like(spokes), spokes], axis=1),
                            np.stack([spokes[:-1], spokes[1:]], axis=1)])
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    return e[:, 0].astype(np.int64), e[:, 1].astype(np.int64), np.ones(e.shape[0], bool), nv, 4, 128


GREEDY_CASES = ["drifted", "star", "ring", "path4", "rmat16", "past-one-cta", "wide-ids", "hub"]


def _greedy_run(cuda, case, stream):
    """``greedy_keys`` and ``full_order_device`` on one case, on the given
    stream, against the host mirror; returns the launch plan."""
    from repro_torch.kernels import full_reorder as FRK

    u, v, valid, nv, k_min, k_max = _greedy_slots(case)
    n = int(valid.sum())
    deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
    alpha, beta, delta = FRK.greedy_params(n, k_min, k_max, int(deg.max()))
    permpos = FRK.fallback_positions(nv)
    host, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (u, v))
    vd = torch.from_numpy(valid).to(cuda)
    pt = torch.from_numpy(permpos.astype(np.int32)).to(cuda)
    before = FRK.launches
    with torch.cuda.stream(stream):
        keys, kernel_steps, work = FRK.greedy_keys(ut, vt, vd, nv, alpha, beta, delta, pt)
        perm = FRK.full_order_device(ut, vt, vd, nv, alpha, beta, delta, pt, steps=0)  # steps: CPU only
    torch.cuda.synchronize()
    assert FRK.launches == before + 2
    assert int(kernel_steps[0]) == steps and int(work[0]) > 0
    np.testing.assert_array_equal(perm.cpu().numpy(), host)
    slot = np.arange(len(u))
    k = keys.cpu().numpy()
    np.testing.assert_array_equal(np.lexsort((slot, k[3], k[2], k[1], k[0])), host)
    return FRK.greedy_plan(nv)


@pytest.mark.parametrize("stream", ["default", "side"])
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_kernel_equals_mirror(cuda, case, stream):
    """The greedy kernel, one launch, against the host mirror: the same
    permutation and the mirror's step count, on the default stream and on a
    side stream (where the async rebuild launches it), in every branch the
    kernel has: one CTA, a cluster with the state in its shared memory, and
    a cluster of 16 with the state in global memory."""
    side = torch.cuda.Stream() if stream == "side" else torch.cuda.current_stream()
    side.wait_stream(torch.cuda.current_stream())
    cluster, global_bytes = _greedy_run(cuda, case, side)
    want = {"rmat16": (4, 0), "past-one-cta": (2, 0)}.get(case)
    if want is not None:
        assert (cluster, global_bytes) == want
    elif case == "wide-ids":
        assert cluster == 16 and global_bytes > 0
    elif case == "hub":
        assert cluster >= 14 and global_bytes == 0
    else:
        assert (cluster, global_bytes) == (1, 0)


def test_greedy_cluster_beside_a_long_scatter_on_another_stream(cuda):
    """A cluster launch of the greedy while another stream runs a long queue
    of scatters that fills the card: the cluster's CTAs are scheduled
    together, so it finishes, and equals the mirror."""
    busy = torch.cuda.Stream()
    busy.wait_stream(torch.cuda.current_stream())
    target = torch.zeros(1 << 20, device=cuda)
    index = torch.randint(0, 1 << 20, (1 << 24,), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    ones = torch.ones(1 << 24, device=cuda)
    with torch.cuda.stream(busy):
        for _ in range(40):
            target.index_add_(0, index, ones)
    side = torch.cuda.Stream()
    cluster, _ = _greedy_run(cuda, "past-one-cta", side)
    assert cluster > 1 and float(target.sum()) == 40 * (1 << 24)


@pytest.mark.parametrize("bad", ["int64", "non-contiguous", "valid-uint8", "permpos-short"])
def test_greedy_wrapper_rejects_bad_input(cuda, bad):
    from repro_torch.kernels import full_reorder as FRK

    u, v, valid, nv = _stream_slots("ring")
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (u, v))
    vd = torch.from_numpy(valid).to(cuda)
    pt = torch.from_numpy(FRK.fallback_positions(nv).astype(np.int32)).to(cuda)
    exc = ValueError if bad == "non-contiguous" else TypeError
    if bad == "int64":
        ut = ut.long()
    elif bad == "non-contiguous":
        ut = torch.stack([ut, ut], dim=1)[:, 0]
    elif bad == "valid-uint8":
        vd = vd.to(torch.uint8)
    else:
        pt = pt[:-1]
    before = FRK.launches
    with pytest.raises(exc):
        FRK.greedy_keys(ut, vt, vd, nv, 3, 1, 2, pt)
    assert FRK.launches == before


def test_greedy_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses raises with the CUDA error's string and
    counts nothing: here the C entry point returns
    cudaErrorInvalidClusterSize (912), what it returns where
    cudaOccupancyMaxActiveClusters finds room for no cluster of the plan's
    size. Nothing falls back to one CTA or to the plain version."""
    from repro_torch.kernels import full_reorder as FRK

    _, plan = FRK._kernel()
    monkeypatch.setattr(FRK, "_greedy_fns", (lambda *args: 912, plan))
    u, v, valid, nv = _stream_slots("ring")
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (u, v))
    pt = torch.from_numpy(FRK.fallback_positions(nv).astype(np.int32)).to(cuda)
    before = FRK.launches
    with pytest.raises(RuntimeError, match="cudaError 912"):
        FRK.greedy_keys(ut, vt, torch.from_numpy(valid).to(cuda), nv, 3, 1, 2, pt)
    assert FRK.launches == before


def _oc_block(case: str) -> np.ndarray:
    """Out-of-core edge blocks over ids spread across 2**20: "small" (an
    RMAT-12 graph, 2,967 compacted vertices: the greedy on one CTA), "wide"
    (100,000 random edges among 30,000 vertices: on a cluster, its state in
    the cluster's shared memory) and "duplicates" (the small block with
    repeated rows, shuffled)."""
    rng = np.random.default_rng(5)
    ids = rng.choice(1 << 20, size=30_000, replace=False)
    if case == "wide":
        e = ids[rng.integers(0, ids.shape[0], size=(100_000, 2))]
        e = e[e[:, 0] != e[:, 1]]
    else:
        g = rmat_graph(12, 8, seed=1)
        e = ids[np.stack([g.src, g.dst], axis=1)]
        if case == "duplicates":
            e = np.concatenate([e, e[:500], e[:100]])
            e = e[rng.permutation(e.shape[0])]
    return np.sort(e, axis=1).astype(np.int64)


@pytest.mark.parametrize("case", ["small", "wide", "duplicates"])
def test_outofcore_chunk_on_the_greedy_kernel_equals_mirror(cuda, case):
    """``order_edge_block`` in the device chunk mode on the card: one launch
    of the greedy kernel a block, the permutation equal to the mirror mode's;
    the compacted vertex count picks the kernel's branch."""
    from repro_torch.core import hier_order as HO
    from repro_torch.kernels import full_reorder as FRK

    block = _oc_block(case)
    nv = np.unique(block).shape[0]
    cfg = HO.HierConfig(chunk_mode="device")
    before = FRK.launches
    got = HO.order_edge_block(block, cfg, seed=7, device="cuda")
    assert FRK.launches == before + 1
    np.testing.assert_array_equal(got, HO.order_edge_block(block, HO.HierConfig(chunk_mode="mirror"), seed=7))
    cluster, global_bytes = FRK.greedy_plan(nv)  # "wide": a cluster, its state in shared memory
    assert (cluster > 1, global_bytes) == (case == "wide", 0), (nv, cluster, global_bytes)


def test_outofcore_device_mode_without_a_card_raises(monkeypatch):
    """On the CPU side: with no CUDA device visible, the device chunk mode
    raises for ``device=None`` and ``"cuda"`` and launches nothing."""
    from repro_torch.core import hier_order as HO
    from repro_torch.kernels import full_reorder as FRK

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = FRK.launches
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HO.order_edge_block(_oc_block("small"), HO.HierConfig(chunk_mode="device"), device=device)
    assert FRK.launches == before


@pytest.mark.parametrize("span_repair,full_rebuild", [("device", "device"), ("differential", "differential"),
                                                      ("oracle", "geo")])
def test_short_stream_on_cuda_stays_bit_identical(cuda, span_repair, full_rebuild):
    """Ingest, span repairs, a rescale, a rebuild aborted by a rescale and one
    committed after two batches in flight: the card's pack equals
    ``pack_slots`` of the host slots after every event."""
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    g = rmat_graph(9, 8, seed=0)
    order = ordering.geo_order(g, seed=0)
    o = IncrementalOrderer(g.src[order], g.dst[order], g.num_vertices, regions=4,
                           config=StreamConfig(partial_drift=1.0, full_drift=99.0, span_regions=2))
    eng = StreamingEngine(o, span_repair=span_repair, full_rebuild=full_rebuild, rebuild_flight=2)
    assert eng.data.edges.device.type == "cuda"
    stream = SyntheticStream(g, batch_size=128, seed=3)
    for b in range(9):
        if b in (3, 7):
            eng.rescale({3: 6, 7: 5}[b], verify=True)
        eng.ingest(stream.batch(), verify=True)
        if b in (2, 4):
            o.drift = lambda: 200.0
        eng.monitor()
        if b in (2, 4):
            del o.drift
        eng.verify_bit_identity()
    log = eng.drain_rebuild_events()
    assert [(r["aborted"], r["committed"]) for r in log] == [(True, False), (False, True)]
    assert log[1]["flight_batches"] == 2 and log[1]["splice_ops"] > 0
    assert eng.rung_counts["partial"] >= 3
    pr = E.pagerank(eng.data)
    torch.testing.assert_close(pr, E.pagerank(eng.oracle_pack()), rtol=1e-4, atol=1e-7)


# ------------------------------------------------------- multi-rank layout
MULTIHOST_WORKER = pathlib.Path(__file__).resolve().parent / "test_torch_multihost.py"
MULTIHOST_RESCALES = [("chain12", 12), ("chain8", 8), ("pair5_9", 9), ("pair12_20", 20), ("pair3_7", 7),
                      ("pair20_16", 16), ("pair7_8", 8)]  # what the worker keeps, at its k


@pytest.mark.parametrize("backend,n_procs,devs_per_proc", [("gloo", 1, 2), ("nccl", 1, 1)],
                         ids=["gloo-2-ranks", "nccl-1-rank"])
def test_multirank_layout_on_the_card(cuda, ordered, tmp_path, backend, n_procs, devs_per_proc):
    """The multi-rank worker of ``tests/test_torch_multihost.py`` with every
    rank on the one card: two ranks over gloo (NCCL refuses two ranks of one
    communicator on one device), or one rank over NCCL. Its sharded packs and
    verified rescales are held byte-equal to the host pack, its apps against
    the port on the CPU, and every rank must have launched ``segment_rf``,
    and the migration kernel once a rescale."""
    g, src, dst = ordered
    src, dst, v = src.astype(np.int32), dst.astype(np.int32), g.num_vertices
    source = int(np.argmax(np.bincount(np.concatenate([src, dst]), minlength=v)))
    np.savez(tmp_path / "inputs.npz", src=src, dst=dst, num_vertices=v, source=source)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "slots.npz", src=rng.integers(0, v, 240), dst=rng.integers(0, v, 240),
             valid=rng.random(240) < 0.7)
    world = n_procs * devs_per_proc
    res = MH.spawn_local_cluster(
        n_procs, devs_per_proc, [str(MULTIHOST_WORKER), "worker", str(tmp_path)], backend=backend,
        devices=["cuda:0"] * world, timeout=300.0, env_extra={"PYTHONPATH": str(MULTIHOST_WORKER.parents[1] / "src")},
    )
    assert res.ok, res.format_logs()
    ranks = [(dict(np.load(tmp_path / f"rank{r}.npz")), json.loads((tmp_path / f"rank{r}.json").read_text()))
             for r in range(world)]
    for name, k in MULTIHOST_RESCALES:
        edges = np.concatenate([a[f"{name}_edges"] for a, _ in ranks])
        mask = np.concatenate([a[f"{name}_mask"] for a, _ in ranks])
        rows = [SH.partition_row(p, k, world) for p in range(k)]
        want_edges, want_mask = E.host_pack(src, dst, k)
        assert edges[rows].tobytes() == want_edges.tobytes() and mask[rows].tobytes() == want_mask.tobytes(), name
        assert int(np.count_nonzero(mask)) == src.shape[0], name
    for k in (5, 8):
        d = E.pack_ordered(src, dst, v, k, device="cpu")
        pr = E.pagerank(d, iterations=20).numpy()
        (ss, ss_it), (wc, wc_it) = E.sssp(d, source=source), E.wcc(d)
        for arrays, meta in ranks:
            np.testing.assert_allclose(arrays[f"pagerank{k}"], pr, rtol=1e-4, atol=1e-7)
            assert np.array_equal(arrays[f"sssp{k}"], ss.numpy()) and meta[f"sssp{k}_it"] == ss_it
            assert np.array_equal(arrays[f"wcc{k}"], wc.numpy()) and meta[f"wcc{k}_it"] == wc_it
    for _, meta in ranks:
        assert meta["group"][:3] == [world, meta["rank"], backend]
        assert meta["segment_rf_launches"] > 0
        assert meta["chain_stats"][0]["oracle_checked"]
        # One migration launch a rescale on every rank; re-run into a block
        # holding a sentinel, the receive ranges (gloo: the other rank's
        # ranges) keep it and every other slot equals the executed result.
        assert meta["rescale_migrate_launches"] == len(MULTIHOST_RESCALES)
        assert all(meta["recv_left"].values()) and len(meta["recv_left"]) == len(MULTIHOST_RESCALES)


# ------------------------------------------------------ stream over ranks
STREAM_WORKER = pathlib.Path(__file__).resolve().parent / "test_torch_stream_multirank.py"


@pytest.mark.parametrize("backend,n_procs,devs_per_proc", [("gloo", 1, 2), ("nccl", 1, 1)],
                         ids=["gloo-2-ranks", "nccl-1-rank"])
def test_stream_engine_over_ranks_on_the_card(cuda, tmp_path, backend, n_procs, devs_per_proc):
    """The multi-rank stream worker of ``tests/test_torch_stream_multirank.py``
    with every rank on the one card: two ranks over gloo, or one rank over
    NCCL. Each script's blocks, reassembled, equal ``pack_slots`` of a host
    replay through the port's orderer and mirrors, the ladder and rebuild logs
    equal the replay's, and every rank launches ``segment_rf`` exactly twice
    a selection of script C."""
    import test_torch_stream_multirank as SM
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK
    from repro_torch.stream import SyntheticStream
    from repro_torch.stream import incremental as inc

    g = rmat_graph(**SM.GRAPH)
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)
    np.savez(tmp_path / "inputs.npz", src=src, dst=dst)
    world = n_procs * devs_per_proc
    res = MH.spawn_local_cluster(
        n_procs, devs_per_proc, [str(STREAM_WORKER), "worker", str(tmp_path)], backend=backend,
        devices=["cuda:0"] * world, timeout=300.0, env_extra={"PYTHONPATH": str(STREAM_WORKER.parents[1] / "src")},
    )
    assert res.ok, res.format_logs()
    ranks = [(dict(np.load(tmp_path / f"rank{r}.npz")), json.loads((tmp_path / f"rank{r}.json").read_text()))
             for r in range(world)]
    for name in ("A", "B", "C", "D"):
        script = "A" if name == "D" else name
        rep = SM.new_replay((inc, SRK, FRK), script, src, dst, g.num_vertices)
        stream = SyntheticStream(g, batch_size=SM.BATCH, seed=SM.SCRIPTS[script]["seed"])
        read = SM.replay_script(rep, script, stream)
        if name == "D":
            rep.ingest(stream.batch())
        o = rep.o
        rows = [SH.partition_row(p, o.regions, world) for p in range(o.regions)]
        pad = np.setdiff1d(np.arange(SH.padded_partition_count(o.regions, world)), rows)
        for part, want in zip(("edges", "mask"), E.host_pack_slots(o.slot_src, o.slot_dst, o.slot_valid,
                                                                   o.regions, g.num_vertices)):
            whole = np.concatenate([a[f"{name}_{part}"] for a, _ in ranks])
            assert whole[rows].tobytes() == want.tobytes() and not whole[pad].any(), (name, part)
        for arrays, meta in ranks:
            assert meta[name]["k"] == o.regions and meta["device"] == "cuda:0" and meta["jax_loaded"] is False
            if name != "D":
                assert meta[name]["rungs"] == read["rungs"] and meta[name]["log"] == rep.log, name
    for _, meta in ranks:
        c = meta["C"]
        selections = c["span_selections"] + c["full_selections"]
        assert selections > 0 and c["segment_rf_launches"] == c["objective_calls"] == 2 * selections
        assert meta["D_equal_to_A"] == {"edges": True, "mask": True, "degrees": True}


# ----------------------------------------------------------- control plane
def _control_run(tmp_path, span_repair, full_rebuild):
    """An ``ElasticController`` with a ``SlotCheckpoint`` driving a
    ``StreamingEngine`` on the card (RMAT-10, 6 regions): three batches, a
    host lost to ``poll``, the full rung forced and one batch in flight.
    Returns (controller, orderer, config, engine keywords, clock)."""
    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    g = rmat_graph(10, 8, seed=0)
    order = ordering.geo_order(g, seed=0, k_min=4, k_max=32)
    cfg = StreamConfig(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=32)
    o = IncrementalOrderer(g.src[order], g.dst[order], g.num_vertices, regions=6, config=cfg)
    kw = dict(span_repair=span_repair, full_rebuild=full_rebuild, rebuild_flight=2)
    eng = StreamingEngine(o, **kw)
    t = [0.0]
    ctl = ElasticController(6, dead_after_s=5.0, clock=lambda: t[0])
    ctl.attach_stream(eng)
    ctl.attach_checkpoint(SlotCheckpoint(tmp_path / "ckpt", interval=3))  # snapshots at 0 and 3, step 4 in the WAL
    stream = SyntheticStream(g, batch_size=128, seed=3)
    for b in range(5):
        t[0] += 1.0
        for h in range(5 if b else 6):
            ctl.heartbeat(h, b)
        if b == 2:
            t[0] += 5.0
            for h in range(5):
                ctl.heartbeat(h, b)
            assert ctl.poll().executed  # host 5 went silent: 6 → 5
        if b == 3:
            o.drift = lambda: 200.0
        ctl.ingest(stream.batch())
        if b == 3:
            del o.drift
        eng.verify_bit_identity()
    assert eng.rebuilds_in_flight == 1
    return ctl, o, cfg, kw, stream


@pytest.mark.parametrize("span_repair,full_rebuild", [("differential", "device"), ("device", "device"),
                                                      ("oracle", "geo")])
def test_controller_driven_engine_on_cuda_restores_from_disk(cuda, tmp_path, span_repair, full_rebuild):
    """A controller-driven engine on the card, killed with a rebuild in
    flight: the checkpoint restores the live slots exactly, ``from_restored``
    commits them to the card equal to ``pack_slots``, and a reported failure
    rescales the restored engine on the card, bit-identical afterwards."""
    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.stream import StreamingEngine

    ctl, o, cfg, kw, stream = _control_run(tmp_path, span_repair, full_rebuild)
    want = (o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy())
    torch.cuda.synchronize()
    del ctl, o
    o2, info = SlotCheckpoint(tmp_path / "ckpt").restore(config=cfg)
    assert all(np.array_equal(a, b) for a, b in zip((o2.slot_src, o2.slot_dst, o2.slot_valid), want))
    assert info["replayed"] >= 1
    eng2 = StreamingEngine.from_restored(o2, **kw)
    assert eng2.data.edges.device.type == "cuda" and eng2.rebuilds_in_flight == 0
    pack = E.pack_slots(o2.slot_src, o2.slot_dst, o2.slot_valid, o2.regions, o2.num_vertices, device="cuda")
    got = E.unshard_engine_data(eng2.data)
    assert all(torch.equal(getattr(got, n), getattr(pack, n)) for n in ("edges", "mask", "degrees"))
    ctl2 = ElasticController(o2.regions)
    ctl2.attach_stream(eng2)
    fev, sev = ctl2.report_failure([o2.regions - 1], restored_bytes=info["bytes_read"])
    assert sev.executed and eng2.k == o2.regions == fev.k_new
    ctl2.ingest(stream.batch())
    eng2.verify_bit_identity()


def test_kill_mid_flight_then_the_ladder_fires_again_on_cuda(cuda, tmp_path):
    """Span ``differential`` and full ``device``: every ``segment_rf`` launch
    (two a span selection) exact against its plain version and every greedy
    launch equal to the host mirror, before the kill and after the restore,
    where both rungs fire again on the card."""
    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK
    from repro_torch.stream import StreamingEngine

    rf_kernel, greedy_kernel, rf_tapped, greedy_tapped = SRK.segment_distinct_counts, FRK.greedy_keys, [], []

    def rf_tap(rows):
        counts = rf_kernel(rows)
        rf_tapped.append((rows.clone(), counts.clone()))
        return counts

    def greedy_tap(u, v, valid, nv, alpha, beta, delta, permpos):
        keys, steps, work = greedy_kernel(u, v, valid, nv, alpha, beta, delta, permpos)
        greedy_tapped.append((u.clone(), v.clone(), valid.clone(), nv, (alpha, beta, delta), permpos.clone(),
                              keys.clone(), steps.clone()))
        return keys, steps, work

    SRK.segment_distinct_counts, FRK.greedy_keys = rf_tap, greedy_tap
    rf_before, greedy_before = segment_rf.launches, FRK.launches
    try:
        ctl, o, cfg, kw, stream = _control_run(tmp_path, "differential", "device")
        at_kill = (len(rf_tapped), len(greedy_tapped))
        torch.cuda.synchronize()
        del ctl, o
        o2, info = SlotCheckpoint(tmp_path / "ckpt").restore(config=cfg)
        eng2 = StreamingEngine.from_restored(o2, **kw)
        ctl2 = ElasticController(o2.regions)
        ctl2.attach_stream(eng2)
        ev = ctl2.ingest(stream.batch())
        assert ev.escalation == "partial" and ev.repair == "differential"
        o2.drift = lambda: 200.0
        ev = ctl2.ingest(stream.batch())
        del o2.drift
        assert ev.escalation == "full" and ev.rebuild_state == "dispatch"
        eng2.verify_bit_identity()
    finally:
        SRK.segment_distinct_counts, FRK.greedy_keys = rf_kernel, greedy_kernel
    assert 0 < at_kill[0] < len(rf_tapped) and 0 < at_kill[1] < len(greedy_tapped)
    assert segment_rf.launches - rf_before == len(rf_tapped) and FRK.launches - greedy_before == len(greedy_tapped)
    for rows, counts in rf_tapped:
        assert torch.equal(counts, segment_rf.segment_distinct_counts_torch(rows))
    for u, v, valid, nv, params, permpos, keys, steps in greedy_tapped:
        host, host_steps = FRK._full_order_host(u.cpu().numpy().astype(np.int64), v.cpu().numpy().astype(np.int64),
                                                valid.cpu().numpy(), nv, *params,
                                                permpos.cpu().numpy().astype(np.int64))
        k = keys.cpu().numpy()
        assert np.array_equal(np.lexsort((np.arange(u.shape[0]), k[3], k[2], k[1], k[0])), host)
        assert int(steps[0]) == host_steps


def test_sigkill_drill_on_the_card(cuda, tmp_path):
    """``tests/torch_faults_harness.py``'s drill with every rank on the one
    card over gloo: process 1's ranks SIGKILLed after batch 5, recovery on 2
    ranks; restore point, final slots and final pack byte-equal to the
    no-failure host oracle."""
    import torch_faults_harness as FH

    res = FH.run_drill(tmp_path / "shared", tmp_path / "out", device="cuda", backend="gloo",
                       live_devices=["cuda:0"] * 4, recover_devices=["cuda:0"] * 2)
    last = res["records"][0]["restore"]["step"]
    assert FH.KILL_STEP <= last < FH.BATCHES - 1 and 0.0 < res["detect_s"] <= FH.LEASE_S + 2.0
    oracle, point = FH.drill_oracle(last)
    for a in res["arrays"]:
        assert all(np.array_equal(x, y) for x, y in zip((a["restore_src"], a["restore_dst"], a["restore_valid"]),
                                                        point))
        assert all(np.array_equal(x, y) for x, y in zip((a["final_src"], a["final_dst"], a["final_valid"]),
                                                        (oracle.slot_src, oracle.slot_dst, oracle.slot_valid)))
    want_e, want_m, _ = E.host_pack_slots(oracle.slot_src, oracle.slot_dst, oracle.slot_valid, 4,
                                          oracle.num_vertices)
    got_e, got_m = FH.reassemble(res["records"], res["arrays"])
    assert got_e.tobytes() == want_e.tobytes() and got_m.tobytes() == want_m.tobytes()
    assert res["records"][0]["events_jsonl"] == res["records"][1]["events_jsonl"]
    assert all(r["group"][2] == "cuda:0" for r in res["records"])


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("regions", [4, 7])
def test_query_engine_on_cuda_equals_cpu(cuda, ordered, regions):
    """``QueryEngine`` on a card's live pack against the same queries on a CPU
    engine over the same orderer input: PageRank within rtol 1e-5 (atomics
    sum in another order), SSSP and WCC exact with equal iteration counts."""
    from repro_torch.launch.serve import QueryEngine
    from repro_torch.stream import IncrementalOrderer, StreamingEngine

    g, src, dst = ordered
    engines = {dev: StreamingEngine(IncrementalOrderer(src.astype(np.int64), dst.astype(np.int64), g.num_vertices,
                                                       regions=regions), device=dev) for dev in ("cuda", "cpu")}
    got, want = (QueryEngine(engines[dev]) for dev in ("cuda", "cpu"))
    got.warm()
    (pr, elapsed), (pr_cpu, _) = got.query("pagerank"), want.query("pagerank")
    assert pr.device.type == "cuda" and elapsed > 0
    torch.testing.assert_close(pr.cpu(), pr_cpu, rtol=1e-5, atol=1e-8)
    for kind, source in (("sssp", 0), ("sssp", 17), ("wcc", 0)):
        (a, it), _ = got.query(kind, source)
        (b, it_cpu), _ = want.query(kind, source)
        assert it == it_cpu and torch.equal(a.cpu(), b)


def test_serve_loop_ticks_on_cuda_stay_bit_identical(cuda):
    """A day of path 9 (b)'s scenario at scale 7 on the card (both rungs on
    the device, an ingest every tick, probes every 8 ticks): the pack equals
    ``pack_slots`` after every event (the loop checks), and the trajectory
    equals the same loop's on the CPU."""
    import torch_serve_harness as SH

    s = dict(SH.SCENARIO, scale=7, day_ticks=48, days=1, ingest_batch=16)
    ordered = SH.build_ordered(**s)
    runs = {}
    for dev in ("cuda", "cpu"):
        loop, _, policy, eng = SH.build_loop(ordered, device=dev, **s)
        probes = SH.record_probes(loop)
        SH.run_scenario(loop, **s)
        assert eng.data.edges.device.type == dev and eng.verify_bit_identity()
        runs[dev] = (SH.trajectory(loop, policy), probes, eng.rung_counts)
    (tr, probes, rungs), (tr_cpu, probes_cpu, rungs_cpu) = runs["cuda"], runs["cpu"]
    assert tr == tr_cpu and rungs == rungs_cpu and len(tr["k_path"]) > 2
    assert rungs["partial"] > 0 and rungs["full"] > 0 and len(probes) > 0
    for (_, kind, _, a, it), (_, _, _, b, it_cpu) in zip(probes, probes_cpu):
        assert it == it_cpu
        if kind == "pagerank":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the LM harness
@pytest.fixture
def f32_exact():
    """float32 products stay float32 (TF32 off), as on the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "gemma3-4b", "qwen3-8b", "qwen2-1.5b", "gemma2-9b",
                                  "whisper-small", "mamba2-1.3b", "deepseek-moe-16b", "granite-moe-3b-a800m",
                                  "hymba-1.5b"])
def test_lm_smoke_config_on_cuda_equals_cpu(cuda, f32_exact, arch):
    """forward_train, forward_prefill (every cache leaf) and forward_decode of
    a smoke config on the card against the same on the CPU, in float32."""
    import torch_lm_harness as LH

    from repro_torch import configs
    from repro_torch.models import model as LM

    cfg = configs.get_smoke(arch)
    s = LH.PARITY_SETUP
    params, inputs = LH.numpy_params(LM.param_shapes(cfg)), LH.numpy_inputs(cfg, s["batch"], s["seq"])
    got = LH.port_outputs(cfg, params, inputs, s["max_len"], cuda)
    want = LH.port_outputs(cfg, params, inputs, s["max_len"], "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"{arch} {k}")


def test_lm_mea_attention_at_gemma3_width_on_cuda_equals_cpu(cuda, f32_exact):
    """gemma3-4b's attention shape (8 heads over 4 KV heads, head dim 256),
    2,048 queries over a 3,072-position cache, the 1,024 window, float32."""
    from repro_torch.models import layers as LL

    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, 2048, 256), generator=gen)
    k, v = (torch.randn((2, 4, 3072, 256), generator=gen) for _ in range(2))
    kw = dict(window=1024, kv_len=2048)
    got = LL.mea_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), LL.mea_attention(q, k, v, **kw), rtol=2e-5, atol=2e-5)


def test_lm_moe_block_at_granite_width_on_cuda_equals_cpu(cuda, f32_exact):
    """granite-moe-3b's MoE layer at full width (40 experts padded to 48,
    top-8, d 1536, expert width 512) over 2 x 256 tokens, float32: the
    output, the aux loss, every token's expert ids and the kept set."""
    from repro_torch import configs
    from repro_torch.models import layers as LL

    cfg = configs.get_config("granite-moe-3b-a800m")
    gen = torch.Generator().manual_seed(1)
    e, d, f = cfg.experts_alloc, cfg.d_model, cfg.moe_d_ff
    p = {"router": 0.02 * torch.randn((d, e), generator=gen), "w1": 0.02 * torch.randn((e, d, f), generator=gen),
         "w3": 0.02 * torch.randn((e, d, f), generator=gen), "w2": 0.02 * torch.randn((e, f, d), generator=gen)}
    x = torch.randn((2, 256, d), generator=gen) + torch.randn(d, generator=gen)  # skewed loads: some drop
    pc = {k: t.to(cuda) for k, t in p.items()}
    y, aux = LL.moe_block(pc, x.to(cuda), cfg)
    y_cpu, aux_cpu = LL.moe_block(p, x, cfg)
    r, r_cpu = LL.moe_route(x.to(cuda).reshape(1, 512, d), pc["router"], cfg), LL.moe_route(x.reshape(1, 512, d),
                                                                                          p["router"], cfg)
    assert torch.equal(r["expert_ids"].cpu(), r_cpu["expert_ids"]) and torch.equal(r["kept"].cpu(), r_cpu["kept"])
    assert not r_cpu["kept"].all() and (r_cpu["expert_ids"] < cfg.num_experts).all()
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b", "granite-moe-3b-a800m"])
def test_lm_train_step_on_cuda_equals_cpu(cuda, f32_exact, arch, mb):
    """Two train steps of a smoke config on the card against the same on the
    CPU, in float32: the step's scalars and every leaf's gradient at the CPU
    parity tests' tolerances (the readings path 11 (c) holds to the JAX
    fixture), and the updated parameters."""
    import torch_lm_harness as LH

    from repro_torch import configs
    from repro_torch.models import model as LM
    from repro_torch.train import optimizer as LO

    cfg = configs.get_smoke(arch)
    params, inputs = LH.numpy_params(LM.param_shapes(cfg)), LH.train_inputs(cfg)
    got = LH.port_train_outputs(cfg, params, inputs, cuda, mb)
    want = LH.port_train_outputs(cfg, params, inputs, "cpu", mb)
    ratios = LH.train_fixture_ratios(got, LH.train_fixture_subset(want))
    assert max(ratios.values()) <= 1.0, max(ratios, key=ratios.get)
    for k in want:
        if k.startswith("grad/"):
            rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
            assert rel < LH.TRAIN_GRAD_RTOL, (arch, mb, k, rel)
        elif k.startswith("params/"):
            leaf = k.split("/", 1)[1]
            LH.assert_updates_close(got[k], want[k], got[f"grad/{leaf}"], want[f"grad/{leaf}"], want["lr"],
                                    LO.OptConfig().weight_decay, (arch, mb, leaf))


def test_lm_training_entry_points_default_to_cuda(cuda, tmp_path):
    """``launch.train.main`` with no ``--device`` trains on the card, and a
    model built with no device there takes its steps on the card."""
    from repro_torch import configs
    from repro_torch.launch import train as LT
    from repro_torch.models import model as LM
    from repro_torch.train import optimizer as LO
    from repro_torch.train import steps as LS

    read = LT.main(["--steps", "3", "--batch", "4", "--seq", "16", "--hosts", "2", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path)])
    assert read["model"]["embed"].device.type == "cuda" and read["state"]["step"].device.type == "cuda"
    assert int(read["state"]["step"]) == 3 and np.isfinite(read["losses"]).all() and read["checkpoints"] == [2]
    cfg = configs.get_smoke("gemma3-4b")
    model = LM.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    state = LO.init_opt_state(model)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 40), device="cuda") for k in ("tokens", "targets")}
    model, state, m = LS.make_train_step(cfg, LO.OptConfig())(model, state, batch)
    assert m["loss"].device.type == "cuda" and state["m"]["embed"].dtype == torch.float32
    assert model["embed"].dtype == torch.bfloat16 and torch.isfinite(m["loss"])


# ------------------------------------------------------- the LM over ranks
def test_sp_cache_update_in_place_on_cuda(cuda):
    """Rank 1 of a (1, 2) grid holds positions [16, 32): it writes a token it
    owns in place on the card, as the CPU does, and leaves one it does not."""
    from repro_torch.launch import mesh as MM
    from repro_torch.models import dist as D

    group = MM.GraphGroup(size=2, rank=1, device=cuda, backend="gloo", processes=(0, 1))
    dist = D.Distribution(mesh=MM.RankGrid(("data", "model"), (1, 2), group))
    gen = torch.Generator().manual_seed(0)
    for pos, owned in ((20, True), (31, True), (3, False), (15, False)):
        host = torch.randn(2, 3, 16, 8, generator=gen)
        new = torch.randn(2, 3, 1, 8, generator=gen)
        cache = host.to(cuda)
        ptr = cache.data_ptr()
        got = D.sp_cache_update(dist, cache, new.to(cuda), pos)
        want = D.sp_cache_update(dist, host.clone(), new, pos)
        assert got is cache and cache.data_ptr() == ptr
        assert torch.equal(cache.cpu(), want)
        assert torch.equal(cache.cpu(), host) != owned


def test_sp_decode_attention_on_one_rank_on_cuda_equals_cpu(cuda):
    from repro_torch.launch import mesh as MM
    from repro_torch.models import dist as D

    dist = D.Distribution(mesh=MM.make_test_mesh(1, 1))
    gen = torch.Generator().manual_seed(1)
    q, ck, cv = (torch.randn(shape, generator=gen) for shape in ((2, 8, 1, 64), (2, 2, 300, 64), (2, 2, 300, 64)))
    for kw in (dict(window=None, softcap=None), dict(window=64, softcap=20.0)):
        want = D.sp_decode_attention(dist, q, ck, cv, 250, scale=0.125, **kw)
        got = D.sp_decode_attention(dist, q.to(cuda), ck.to(cuda), cv.to(cuda), 250, scale=0.125, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


def test_quantize_and_compressed_allreduce_on_cuda_equal_cpu(cuda):
    """int8 quantization on the card equals the CPU's bit for bit; so does
    the compressed all-reduce of a world of one (reduced value and error)."""
    from repro_torch.launch import mesh as MM
    from repro_torch.train import compression as C

    gen = torch.Generator().manual_seed(2)
    for shape in ((16, 4), (1_000_003,), (3, 5, 7)):
        g = torch.randn(shape, generator=gen) * 3.0
        e = 0.01 * torch.randn(shape, generator=gen)
        q, scale = C.quantize(g)
        qc, sc = C.quantize(g.to(cuda))
        assert qc.dtype == torch.int8 and torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), scale)
        red, err = C.compressed_allreduce({"g": g}, {"g": e}, MM.GraphGroup())
        redc, errc = C.compressed_allreduce({"g": g.to(cuda)}, {"g": e.to(cuda)}, MM.GraphGroup(device=cuda))
        assert torch.equal(redc["g"].cpu(), red["g"]) and torch.equal(errc["g"].cpu(), err["g"])
