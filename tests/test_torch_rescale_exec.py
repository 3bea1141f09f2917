"""The port's ElasticRescaler on packs handed over from the JAX package: the
executed k_old → k_new result is byte-equal to the JAX package's executed
result and to its fresh pack at k_new, with equal RescaleStats; each rank's
migration table covers its new block once, and the migration's plain
version equals the JAX package's jitted ``migrate`` program over 1, 2 and 4
ranks (the exchange done by hand)."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as J_baselines
from repro.core import cep as J_cep
from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.elastic.rescale_exec import ElasticRescaler as J_ElasticRescaler
from repro.graphs import engine as J_E
from repro_torch.core import cep
from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler, plan_segments
from repro_torch.graphs import engine as E
from repro_torch.kernels import rescale_migrate, segment_rf
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import GraphGroup, make_graph_group
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT

PAIRS = [(8, 12), (12, 8), (4, 5), (5, 4), (16, 20), (20, 16), (3, 7), (2, 3)]  # as tests/test_rescale_exec.py
TIMINGS = ("elapsed_s", "recheck_s")


@pytest.fixture(scope="module")
def ordered():
    jg = J_rmat(8, 6, seed=0)
    order = J_ordering.geo_order(jg, seed=0)
    return jg, jg.src[order], jg.dst[order]


def _port_of(jdata):
    return E.engine_data_from_arrays(
        np.asarray(jdata.edges), np.asarray(jdata.mask), np.asarray(jdata.degrees),
        num_vertices=jdata.num_vertices, k=jdata.k, mirrors=jdata.mirrors,
        replication_factor=jdata.replication_factor, num_edges=jdata.num_edges, device="cpu",
    )


def _assert_pack_equals(got, want):
    for name in ("edges", "mask", "degrees"):
        assert np.array_equal(getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))), name
    assert (got.k, got.num_edges, got.num_vertices) == (want.k, want.num_edges, want.num_vertices)
    assert got.mirrors == want.mirrors
    assert got.replication_factor == want.replication_factor


def _stats_without_timings(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats) if f.name not in TIMINGS}


@pytest.mark.parametrize("k_old,k_new", PAIRS)
def test_executed_equals_jax_executed_and_fresh_pack(ordered, k_old, k_new):
    jg, src, dst = ordered
    plan = J_cep.scale_plan(jg.num_edges, k_old, k_new)
    jax_new, jax_stats = J_ElasticRescaler().execute(
        J_E.pack_ordered(src, dst, jg.num_vertices, k_old), plan, verify=True
    )
    data = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, k_old))
    new, stats = ElasticRescaler().execute(data, cep.scale_plan(jg.num_edges, k_old, k_new), verify=True)
    _assert_pack_equals(new, jax_new)
    _assert_pack_equals(new, J_E.pack_ordered(src, dst, jg.num_vertices, k_new))
    assert _stats_without_timings(stats) == _stats_without_timings(jax_stats)
    assert stats.oracle_checked and stats.elapsed_s > 0
    assert stats.migrated_bytes == plan.migrated_bytes(EDGE_BYTES)
    assert stats.copy_ops == len(plan_segments(plan)) <= k_old + k_new


@pytest.mark.parametrize("k_old,k_new", PAIRS)
def test_recheck_off_matches_jax_and_skips_the_kernel(ordered, k_old, k_new):
    jg, src, dst = ordered
    jax_new, jax_stats = J_ElasticRescaler().rescale(
        J_E.pack_ordered(src, dst, jg.num_vertices, k_old), k_new, recheck=False
    )
    data = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, k_old))
    new, stats = ElasticRescaler().rescale(data, k_new, recheck=False)
    assert np.array_equal(new.edges.numpy(), np.asarray(jax_new.edges))
    assert np.array_equal(new.mask.numpy(), np.asarray(jax_new.mask))
    assert new.mirrors == -1 and np.isnan(new.replication_factor)
    assert _stats_without_timings(stats) == _stats_without_timings(jax_stats)


def test_roundtrip_bit_identical_and_input_stays_valid(ordered):
    jg, src, dst = ordered
    d8 = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, 8))
    edges_before = d8.edges.clone()
    r = ElasticRescaler()
    d12, _ = r.rescale(d8, 12, verify=True)
    back, _ = r.rescale(d12, 8, verify=True)
    assert torch.equal(back.edges, d8.edges) and torch.equal(back.mask, d8.mask)
    assert back.mirrors == d8.mirrors and back.replication_factor == d8.replication_factor
    assert torch.equal(d8.edges, edges_before)  # no donation: the input is still readable
    assert back.edges.data_ptr() != d8.edges.data_ptr()


def test_degenerate_more_partitions_than_edges():
    jg = J_rmat(4, 1, seed=2)
    src, dst = jg.src, jg.dst
    k_new = jg.num_edges + 5
    data = E.pack_ordered(src, dst, jg.num_vertices, 2, device="cpu")
    new, _ = ElasticRescaler().rescale(data, k_new, verify=True)
    _assert_pack_equals(new, J_E.pack_ordered(src, dst, jg.num_vertices, k_new))


def test_noop_plan_returns_the_input(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 6, device="cpu")
    same, stats = ElasticRescaler().rescale(data, 6)
    assert same is data and stats.copy_ops == 0 and stats.stay_edges == jg.num_edges


def test_rejects_non_cep_layouts_and_wrong_plans(ordered):
    jg, src, dst = ordered
    part = J_baselines.hash_1d(jg, 8)
    hashed = E.build_engine_data(jg, part, 8, device="cpu")
    r = ElasticRescaler()
    with pytest.raises(ValueError, match="not CEP-chunked"):
        r.rescale(hashed, 12)
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    with pytest.raises(ValueError, match="k_old"):
        r.execute(data, cep.scale_plan(jg.num_edges, 4, 8))
    with pytest.raises(ValueError, match=r"\|E\|"):
        r.execute(data, cep.scale_plan(jg.num_edges + 1, 8, 12))


def test_program_cache_hits_and_lru_bound(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    r = ElasticRescaler(program_cache_size=2)
    for k_new in (12, 12, 9, 10):
        r.rescale(data, k_new, recheck=False)
    c = r._programs.counters["migrate"]
    assert (c["hits"], c["misses"], c["evictions"]) == (1, 3, 1)
    assert len(r._programs) == 2 == r.program_cache_size
    with pytest.raises(ValueError):
        ElasticRescaler(program_cache_size=0)


def test_trace_span_and_metrics_recorded(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    tracer, registry = OT.Tracer(capacity=16), OM.MetricsRegistry()
    r = ElasticRescaler(tracer=tracer, metrics_registry=registry)
    _, stats = r.rescale(data, 12, recheck=False)
    spans = tracer.spans()  # in the order they closed
    assert [s.name for s in spans] == ["rescale.plan", "rescale.layout_check", "rescale.table_build",
                                       "rescale.migrate", "rescale.recheck", "rescale.execute"]
    assert {s.phase for s in spans} == {"rescale"} and all(s.duration_s > 0 for s in spans)
    snap = registry.snapshot()
    assert snap["rescale.migrated_bytes"] == stats.migrated_bytes
    assert "rescale.migrate_s.count" not in snap
    assert snap["rescale.cross_device_bytes"] == 0.0
    assert ElasticRescaler().tracer is OT.get_tracer() and not OT.get_tracer().enabled


def test_recheck_measures_counts_through_the_segment_rf_wrapper(ordered, monkeypatch):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    calls = []
    plain = segment_rf.segment_distinct_counts
    monkeypatch.setattr(segment_rf, "segment_distinct_counts", lambda rows: calls.append(rows.shape) or plain(rows))
    ElasticRescaler().rescale(data, 12)
    ElasticRescaler().rescale(data, 12, recheck=False)
    assert len(calls) == 1 and calls[0][0] == 12


# ------------------------------------------- the migration's segment table
TABLE_PAIRS = [(16, 17), (8, 12), (12, 8), (3, 7), (20, 16), (7, 8)]
SENTINEL = -7  # an int32 no pack holds: what a slot that nothing wrote keeps


def _rank_group(g: int, rank: int):
    """Rank ``rank`` of a world of ``g`` on the CPU, as ``_program`` reads it
    (size, rank, processes); no process group is needed to build a table."""
    if g == 1:
        return make_graph_group("cpu")
    return GraphGroup(size=g, rank=rank, device="cpu", backend="gloo", processes=(0,) * g)


def _programs(n: int, k_old: int, k_new: int, g: int):
    plan = cep.scale_plan(n, k_old, k_new)
    return plan, [ElasticRescaler()._program(n, k_old, k_new, plan, _rank_group(g, me), torch.device("cpu"))
                  for me in range(g)]


def _table_cases():
    cases = [(None, k_old, k_new, g) for k_old, k_new in TABLE_PAIRS for g in (1, 2, 4)]
    return cases + [("past-E", 2, None, g) for g in (1, 2, 4)]  # k_new > |E|: rows that hold no edge


@pytest.mark.parametrize("n,k_old,k_new,g", _table_cases())
def test_segment_table_covers_every_new_slot_once(ordered, n, k_old, k_new, g):
    """Each rank's table tiles its block of new rows exactly: a local plan
    segment, a receive range, a zero tail or a padded row at every slot, each
    as ``plan_segments`` and the chunk bounds place it; the tiles name each
    piece ceil(length / tile) times, in order."""
    jg = ordered[0]
    n = jg.num_edges if n is None else 13
    k_new = n + 5 if k_new is None else k_new
    plan, progs = _programs(n, k_old, k_new, g)
    bo, bn = cep.chunk_bounds(n, k_old), cep.chunk_bounds(n, k_new)
    width = int(np.diff(bn).max())
    m_new = SH.padded_partition_count(k_new, g) // g
    for me, prog in enumerate(progs):
        t = prog.table
        assert (t.rows, t.width) == (m_new, width) and t.pieces.dtype == np.int64
        want = []
        for lo, hi, s, d in plan_segments(plan):
            if d % g != me:
                continue
            kind = s // g if s % g == me else rescale_migrate.RECV
            a_old = lo - int(bo[s]) if s % g == me else 0
            want.append((d // g, lo - int(bn[d]), hi - int(bn[d]), kind, a_old))
        for row in range(m_new):
            p = SH.row_partition(me * m_new + row, k_new, g)
            size = int(bn[p + 1] - bn[p]) if p < k_new else 0
            assert t.sizes[row] == size
            if size < width:
                want.append((row, size, width, rescale_migrate.ZERO, 0))
        assert sorted(map(tuple, t.pieces[:, :5].tolist())) == sorted(want)
        covered = np.zeros((m_new, width), dtype=np.int64)
        for row, a, b, *_ in t.pieces.tolist():
            covered[row, a:b] += 1
        assert (covered == 1).all()
        lengths = t.pieces[:, 2] - t.pieces[:, 1]
        assert np.array_equal(np.bincount(t.tile_piece, minlength=len(lengths)), -(-lengths // t.tile))
        assert np.array_equal(t.pieces[:, 5], np.searchsorted(t.tile_piece, np.arange(len(lengths))))
        assert torch.equal(t.device_pieces, torch.from_numpy(t.pieces))


def _emulated_rescale(old_global, n, k_old, k_new, g):
    """Every rank's plain migration into a block filled with ``SENTINEL``,
    then the exchange done by hand from the senders' old blocks: returns the
    reassembled new buffer before and after the exchange."""
    _, progs = _programs(n, k_old, k_new, g)
    m_old = old_global.shape[0] // g
    blocks = [torch.from_numpy(old_global[me * m_old:(me + 1) * m_old]).contiguous() for me in range(g)]
    outs = []
    for me, prog in enumerate(progs):
        t = prog.table
        out = (torch.full((t.rows, t.width, 2), SENTINEL, dtype=torch.int32),
               torch.full((t.rows, t.width), float(SENTINEL)))
        assert rescale_migrate.migrate(blocks[me], t, out=out)[0] is out[0]
        outs.append(out)
    before = np.concatenate([e.numpy().copy() for e, _ in outs])
    for me, prog in enumerate(progs):
        for owner, r, a, b, tag in prog.recvs:
            (sent,) = [(r_o, a_o, b_o) for dest, r_o, a_o, b_o, tg in progs[owner].sends if (dest, tg) == (me, tag)]
            outs[me][0][r, a:b] = blocks[owner][sent[0], sent[1]:sent[2]]
    return before, np.concatenate([e.numpy() for e, _ in outs]), np.concatenate([m.numpy() for _, m in outs]), progs


@pytest.mark.parametrize("n,k_old,k_new,g", _table_cases())
def test_plain_migrate_equals_the_jax_migrate_program(ordered, n, k_old, k_new, g):
    """The plain version on each rank's table, plus the exchange, equals the
    JAX package's jitted ``migrate`` on the same old edges, edges and mask
    byte for byte; before the exchange the receive ranges, and only they,
    still hold what the block held."""
    jg, src, dst = ordered
    if n is not None:
        jg = J_rmat(4, 1, seed=2)
        src, dst = jg.src, jg.dst
    n = jg.num_edges
    k_new = n + 5 if k_new is None else k_new
    jold = J_E.pack_ordered(src, dst, jg.num_vertices, k_old)
    program, _ = J_ElasticRescaler(donate=False)._program(n, k_old, k_new, J_cep.scale_plan(n, k_old, k_new), None)
    want_edges, want_mask = (np.asarray(a) for a in program(jold.edges))
    old = np.asarray(jold.edges)
    old_global = np.zeros((SH.padded_partition_count(k_old, g),) + old.shape[1:], dtype=np.int32)
    old_global[[SH.partition_row(p, k_old, g) for p in range(k_old)]] = old
    before, edges, mask, progs = _emulated_rescale(old_global, n, k_old, k_new, g)
    rows = [SH.partition_row(p, k_new, g) for p in range(k_new)]
    pad = np.setdiff1d(np.arange(edges.shape[0]), rows)
    assert edges[rows].tobytes() == want_edges.tobytes() and mask[rows].tobytes() == want_mask.tobytes()
    assert not edges[pad].any() and not mask[pad].any()
    m_new = progs[0].table.rows
    left = np.zeros(before.shape[:2], dtype=bool)
    for me, prog in enumerate(progs):
        for _, r, a, b, _ in prog.recvs:
            left[me * m_new + r, a:b] = True
    assert (before[left] == SENTINEL).all() and (before[~left] == edges[~left]).all()
    assert left.any() == (g > 1 and any(p.recvs for p in progs))


def test_migrate_launches_nothing_on_the_cpu(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    before = rescale_migrate.launches
    ElasticRescaler().rescale(data, 12, verify=True)
    assert rescale_migrate.launches == before


def test_migrate_table_rejects_gaps_overlaps_and_unequal_copies():
    with pytest.raises(ValueError, match="do not tile"):
        rescale_migrate.migrate_table([(0, 0, 4, 0, 0, 4), (0, 5, 8, 0, 5, 8)], [], [8], 10)  # a gap at 4
    with pytest.raises(ValueError, match="do not tile"):
        rescale_migrate.migrate_table([(0, 0, 4, 0, 0, 4)], [(0, 3, 6)], [6], 6)  # an overlap at 3
    with pytest.raises(ValueError, match="its size"):
        rescale_migrate.migrate_table([(0, 0, 4, 0, 0, 4)], [], [5], 6)
    with pytest.raises(ValueError, match="a copy of"):
        rescale_migrate.migrate_table([(0, 0, 4, 0, 0, 5)], [], [5], 6)
    with pytest.raises(ValueError, match="do not fit"):
        rescale_migrate.migrate_table([], [], [7], 6)
    t = rescale_migrate.migrate_table([(1, 2, 5, 0, 0, 3)], [(1, 0, 4)], [3, 4], 6, tile=2)
    assert t.pieces[:, :5].tolist() == [[0, 0, 3, 1, 2], [0, 3, 6, -1, 0], [1, 0, 4, -2, 0], [1, 4, 6, -1, 0]]
    assert t.tile_piece.tolist() == [0, 0, 1, 1, 2, 2, 3] and (t.old_rows, t.old_width) == (2, 5)


@pytest.mark.parametrize("bad", ["int64", "2-D", "too-narrow", "too-few-rows", "non-contiguous", "out-shape",
                                 "out-dtype"])
def test_migrate_rejects_bad_shapes_and_dtypes(bad):
    t = rescale_migrate.migrate_table([(1, 2, 5, 0, 0, 3)], [], [3, 0], 6)
    old = torch.zeros((2, 5, 2), dtype=torch.int32)
    out = None
    if bad == "int64":
        old = old.long()
    elif bad == "2-D":
        old = old[:, :, 0]
    elif bad == "too-narrow":
        old = old[:, :4].contiguous()
    elif bad == "too-few-rows":
        old = old[:1]
    elif bad == "non-contiguous":
        old = torch.zeros((2, 5, 2, 2), dtype=torch.int32)[..., 0]
    elif bad == "out-shape":
        out = (torch.zeros((2, 5, 2), dtype=torch.int32), torch.zeros((2, 6)))
    else:
        out = (torch.zeros((2, 6, 2), dtype=torch.int32), torch.zeros((2, 6), dtype=torch.float64))
    with pytest.raises(TypeError if bad in ("int64", "2-D") else ValueError):
        rescale_migrate.migrate(old, t, out=out)
