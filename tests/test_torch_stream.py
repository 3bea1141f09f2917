"""The port's streaming subsystem against the JAX package on the same inputs.

* The numpy-only modules (updates, incremental, workload) are copies: their
  outputs equal the reference's exactly.
* The device twins of kernels/span_reorder.py and kernels/full_reorder.py,
  run on the CPU, equal the JAX twins (the segment_rf Pallas kernel in
  interpret mode) and the port's own host mirrors, byte for byte.
* The port's ``StreamingEngine`` on ``device="cpu"`` stays bit-identical to
  the host ``pack_slots`` oracle after every event, and its host state,
  ladder decisions and rebuild records equal a replay of the same stream
  through the JAX package's orderer and numpy mirrors. The JAX package's own
  ``StreamingEngine`` is not run here: it needs a JAX whose sharded gathers
  accept its mesh-of-one programs.

Tolerance: exact everywhere, except PageRank on the stream pack (rtol 1e-5,
atol 1e-7: f32 scatter-adds in another order, as in tests/test_torch_engine.py).
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.elastic import rescale_exec as J_RX
from repro.graphs import engine as J_E
from repro.kernels import full_reorder as J_FRK
from repro.kernels import span_reorder as J_SRK
from repro.launch import mesh as J_MM
from repro.stream import incremental as J_inc
from repro.stream import updates as J_upd
from repro.stream import workload as J_wl
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic import rescale_exec as RX
from repro_torch.graphs import engine as E
from repro_torch.kernels import full_reorder as FRK
from repro_torch.kernels import segment_rf
from repro_torch.kernels import span_reorder as SRK
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import GraphGroup
from repro_torch.stream import (
    EdgeUpdateBatch,
    IncrementalOrderer,
    StreamConfig,
    StreamingEngine,
    SyntheticStream,
)
from repro_torch.stream import ingest as ingest_mod
from repro_torch.stream import updates as upd
from repro_torch.stream import workload as wl

QUIET = dict(partial_drift=40.0, full_drift=50.0)  # only a forced drift escalates


@pytest.fixture(scope="module")
def ordered():
    g = rmat_graph(7, 6, seed=0)
    order = J_ordering.geo_order(J_rmat(7, 6, seed=0), seed=0)
    return g, g.src[order].astype(np.int64), g.dst[order].astype(np.int64)


def _orderers(ordered, regions=4, **cfg):
    g, src, dst = ordered
    return (
        IncrementalOrderer(src, dst, g.num_vertices, regions=regions, config=StreamConfig(**cfg)),
        J_inc.IncrementalOrderer(src, dst, g.num_vertices, regions=regions, config=J_inc.StreamConfig(**cfg)),
    )


def _same_slots(a, b):
    for name in ("slot_src", "slot_dst", "slot_valid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.regions, a.slots_per_region, a.num_edges) == (b.regions, b.slots_per_region, b.num_edges)
    assert a.drift() == b.drift()


# ------------------------------------------------------------------- copies
def test_update_batch_and_canonical_edges_equal_reference():
    raw = np.array([[3, 1], [1, 3], [2, 2], [4, 5], [9, 7], [7, 9]])
    np.testing.assert_array_equal(upd.canonical_edges(raw), J_upd.canonical_edges(raw))
    b, jb = (m.EdgeUpdateBatch(insert=raw, delete=raw[::-1]) for m in (upd, J_upd))
    np.testing.assert_array_equal(b.insert, jb.insert)
    np.testing.assert_array_equal(b.delete, jb.delete)
    assert b.num_updates == jb.num_updates


@pytest.mark.parametrize("kw", [dict(), dict(delete_frac=0.4, triadic_frac=0.8, burst_every=3)],
                         ids=["default", "bursty"])
def test_synthetic_stream_batches_equal_reference(kw):
    g = rmat_graph(6, 4, seed=1)
    s = SyntheticStream(g, batch_size=48, seed=7, **kw)
    js = J_upd.SyntheticStream(J_rmat(6, 4, seed=1), batch_size=48, seed=7, **kw)
    for _ in range(6):
        b, jb = s.batch(), js.batch()
        np.testing.assert_array_equal(b.insert, jb.insert)
        np.testing.assert_array_equal(b.delete, jb.delete)
    np.testing.assert_array_equal(s.edges(), js.edges())


def test_workload_arrivals_equal_reference():
    kw = dict(num_vertices=256, base_rate=6.0, burst_every=5, burst_len=2, seed=3)
    w, jw = wl.OpenLoopWorkload(**kw), J_wl.OpenLoopWorkload(**kw)
    for t in range(40):
        assert w.rate(t) == jw.rate(t) and w.count(t) == jw.count(t)
        assert [dataclasses.asdict(a) for a in w.arrivals(t)] == [dataclasses.asdict(a) for a in jw.arrivals(t)]


def test_orderer_equals_reference_through_relayouts_and_repairs(ordered):
    """Slot arrays, drift, span bounds and gather maps after the same batches,
    rescale re-layouts, grows, span repairs (host and mirror) and a rebuild."""
    g, _, _ = ordered
    o, jo = _orderers(ordered, regions=4, span_regions=2)
    s, js = SyntheticStream(g, batch_size=40, delete_frac=0.3, seed=5), J_upd.SyntheticStream(
        J_rmat(7, 6, seed=0), batch_size=40, delete_frac=0.3, seed=5)
    for step in range(9):
        assert o.apply(s.batch()) == jo.apply(js.batch())
        a, b = o.drain_ops(), jo.drain_ops()
        assert [vars(x) for x in a[0]] == [vars(x) for x in b[0]] and a[1] == b[1]
        if step == 2:
            o.relayout(6), jo.relayout(6)
            np.testing.assert_array_equal(o.drain_gather_map(), jo.drain_gather_map())
        elif step == 3:
            assert o.partial_reorder_mirror() == jo.partial_reorder_mirror()
        elif step == 4:
            assert o.partial_reorder() == jo.partial_reorder()
        elif step == 5:
            o.grow(), jo.grow()
        elif step == 6:
            o.relayout(3), jo.relayout(3)
            np.testing.assert_array_equal(o.drain_gather_map(), jo.drain_gather_map())
        elif step == 7:
            o.full_rebuild(), jo.full_rebuild()
        assert o.span_bounds() == jo.span_bounds() and o.worst_region() == jo.worst_region()
        assert o.escalation() == jo.escalation()
        _same_slots(o, jo)


# ------------------------------------------------------------- device twins
def _twin_inputs(case: str):
    """(u, v, valid, num_vertices) slot arrays: a drifted RMAT stream with
    dead slots, a star (every priority ties), and a ring with one dead slot
    in every three (ties and gaps)."""
    if case == "drifted":
        g = rmat_graph(7, 6, seed=0)
        order = J_ordering.geo_order(J_rmat(7, 6, seed=0), seed=0)
        o = IncrementalOrderer(g.src[order], g.dst[order], g.num_vertices, regions=4)
        stream = SyntheticStream(g, batch_size=48, delete_frac=0.3, seed=5)
        for _ in range(6):
            o.apply(stream.batch())
        valid = o.slot_valid.copy()
        valid[::7] = False  # every 7th slot dead as well
        return o.slot_src * valid, o.slot_dst * valid, valid, g.num_vertices
    if case == "star":
        n = 60
        u, v = np.zeros(n, np.int64), np.arange(1, n + 1, dtype=np.int64)
        valid = np.ones(n, bool)
        valid[-5:] = False
        return u * valid, v * valid, valid, n + 1
    n = 90  # ring
    u = np.arange(n, dtype=np.int64)
    v = (u + 1) % n
    u, v = np.minimum(u, v), np.maximum(u, v)
    valid = np.arange(n) % 3 != 1
    return u * valid, v * valid, valid, n


CASES = ["drifted", "star", "ring"]


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _greedy_args(u, v, valid, nv):
    n_live = int(valid.sum())
    deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
    alpha, beta, delta = FRK.greedy_params(n_live, 4, 128, int(deg.max()))
    return alpha, beta, delta, FRK.fallback_positions(nv)


@pytest.mark.parametrize("case", CASES)
def test_span_order_device_equals_jax_twin_and_host_mirror(case):
    u, v, valid, nv = _twin_inputs(case)
    got = SRK.span_order_device(_t(u), _t(v), torch.from_numpy(valid), nv).numpy()
    want = np.asarray(jax.jit(lambda a, b, c: J_SRK.span_order_device(a, b, c, nv))(
        jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, SRK.span_order_host(u, v, valid, nv))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["inline", "segment_rf"])
@pytest.mark.parametrize("case", CASES)
def test_span_objective_device_equals_jax_twin_and_host_mirror(case, use_pallas):
    u, v, valid, nv = _twin_inputs(case)
    ks = J_SRK.eval_ks(4, 128)
    n = int(valid.sum())
    orders = [SRK.span_order_host(u, v, valid, nv), SRK.identity_candidate(valid)]
    before = segment_rf.launches
    for order in orders:
        got = SRK.span_objective_device(_t(u), _t(v), torch.from_numpy(valid), _t(order, torch.int64),
                                        torch.tensor(n), ks, use_pallas=use_pallas)
        want = J_SRK.span_objective_device(
            jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32), jnp.asarray(valid),
            jnp.asarray(order, jnp.int32), jnp.int32(n), ks, use_pallas=use_pallas)
        assert int(got) == int(want) == SRK.span_objective_host(u, v, valid, order, ks)
    assert segment_rf.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("case", CASES)
def test_select_span_order_and_splice_targets_equal_jax_twin(case):
    u, v, valid, nv = _twin_inputs(case)
    ks = J_SRK.eval_ks(4, 128)
    for cand in (SRK.identity_candidate(valid), np.argsort(-np.arange(len(u)) * valid, kind="stable")):
        got = SRK.select_span_order_device(_t(u), _t(v), torch.from_numpy(valid), nv, _t(cand, torch.int64), ks,
                                           use_pallas=True).numpy()
        want = np.asarray(J_SRK.select_span_order_device(
            jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32), jnp.asarray(valid), nv,
            jnp.asarray(cand, jnp.int32), ks, use_pallas=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, SRK.select_span_order_host(u, v, valid, nv, cand, ks)[0])
    n, cap = int(valid.sum()), len(u)
    for regions in (1, 2, 3):
        spr = -(-cap // regions)
        got = SRK.splice_targets_device(torch.tensor(n), regions, spr, regions * spr).numpy()
        want = np.asarray(J_SRK.splice_targets_device(jnp.int32(n), regions, spr, regions * spr))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_full_order_device_equals_jax_twin_and_host_mirror(case):
    u, v, valid, nv = _twin_inputs(case)
    alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
    host, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    np.testing.assert_array_equal(host, FRK.full_order_host(u, v, valid, nv, alpha, beta, delta, permpos))
    want = np.asarray(J_FRK.full_order_device(
        u.astype(np.int32), v.astype(np.int32), valid, nv,
        np.int32(alpha), np.int32(beta), np.int32(delta), permpos.astype(np.int32)))
    for kw in (dict(steps=steps), dict(steps=steps + 5)):  # extra steps change nothing
        got = FRK.full_order_device(_t(u), _t(v), torch.from_numpy(valid), nv, alpha, beta, delta,
                                    _t(permpos), **kw).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("case", CASES)
def test_full_objective_and_select_equal_jax_twin_and_host_mirror(case):
    u, v, valid, nv = _twin_inputs(case)
    alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
    ks = FRK.eval_ks_full(4, 128, 4)
    n = int(valid.sum())
    for cand in (FRK.identity_candidate(valid), J_FRK.geo_full_candidate(u, v, valid, nv)):
        got_obj = FRK.full_objective_device(_t(u), _t(v), torch.from_numpy(valid), _t(cand, torch.int64),
                                            torch.tensor(n), ks, use_pallas=True)
        assert int(got_obj) == FRK.full_objective_host(u, v, valid, cand, ks) == int(
            J_FRK.full_objective_device(jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32), jnp.asarray(valid),
                                        jnp.asarray(cand, jnp.int32), jnp.int32(n), ks, use_pallas=True))
        chosen, chose, steps = FRK._select_full_order_host(u, v, valid, nv, cand, ks, alpha, beta, delta, permpos)
        got = FRK.select_full_order_device(_t(u), _t(v), torch.from_numpy(valid), nv, _t(cand, torch.int64), ks,
                                           alpha, beta, delta, _t(permpos), use_pallas=True, steps=steps).numpy()
        want = np.asarray(J_FRK.select_full_order_device(
            jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32), jnp.asarray(valid), nv,
            jnp.asarray(cand, jnp.int32), ks, jnp.int32(alpha), jnp.int32(beta), jnp.int32(delta),
            jnp.asarray(permpos, jnp.int32), use_pallas=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, chosen)
        j_chosen, j_chose = J_FRK.select_full_order_host(u, v, valid, nv, cand, ks, alpha, beta, delta, permpos)
        np.testing.assert_array_equal(chosen, j_chosen)
        assert chose == j_chose


def test_host_mirrors_are_copies_of_the_reference():
    u, v, valid, nv = _twin_inputs("drifted")
    ks = SRK.eval_ks(4, 128)
    assert SRK.eval_ks(4, 128) == J_SRK.eval_ks(4, 128) and SRK.eval_ks(100, 120) == J_SRK.eval_ks(100, 120)
    assert FRK.eval_ks_full(4, 128, 7) == J_FRK.eval_ks_full(4, 128, 7)
    np.testing.assert_array_equal(SRK.identity_candidate(valid), J_SRK.identity_candidate(valid))
    np.testing.assert_array_equal(FRK.fallback_positions(nv, 3), J_FRK.fallback_positions(nv, 3))
    np.testing.assert_array_equal(FRK.geo_full_candidate(u, v, valid, nv), J_FRK.geo_full_candidate(u, v, valid, nv))
    order = SRK.span_order_host(u, v, valid, nv)
    np.testing.assert_array_equal(order, J_SRK.span_order_host(u, v, valid, nv))
    assert SRK.span_objective_host(u, v, valid, order, ks) == J_SRK.span_objective_host(u, v, valid, order, ks)
    # The greedy mirror walks an incidence list where the JAX package's scans
    # every slot: the same permutation.
    alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
    np.testing.assert_array_equal(FRK.full_order_host(u, v, valid, nv, alpha, beta, delta, permpos),
                                  J_FRK.full_order_host(u, v, valid, nv, alpha, beta, delta, permpos))
    for args in ((2**21, 1, 1, 2**10 - 1), (2**21 - 1, 1, 1, 2**10 - 1), (5000, 4, 128, 40)):
        assert FRK.greedy_fits_int32(*args) == J_FRK.greedy_fits_int32(*args)
    assert FRK.greedy_params(5000, 4, 128, 40) == J_FRK.greedy_params(5000, 4, 128, 40)
    with pytest.raises(ValueError, match="overflow int32"):
        FRK.greedy_params(2**28, 2, 64, max_degree=1000)


def test_chunk_keys_raise_where_int32_would_wrap():
    """max(ks)·(2·cap+2) past int32 max: the JAX twin would wrap silently."""
    fits = (2**31 - 1) // 64 // 2 - 1  # the largest cap with 64·(2·cap+2) ≤ 2^31 − 1
    SRK._check_key_range((4, 16, 64), fits)
    with pytest.raises(ValueError, match="overflow int32"):
        SRK._check_key_range((4, 16, 64), fits + 1)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="overflow int32"):  # the objective checks before building keys
        SRK.span_objective_device(z, z, torch.ones(4, dtype=torch.bool), torch.arange(4), torch.tensor(4),
                                  (2**28,), use_pallas=True)


# ----------------------------------------------------------------- engine pack
def test_pack_slots_byte_equal_reference(ordered):
    g, src, dst = ordered
    o, jo = _orderers(ordered, regions=5)
    stream = SyntheticStream(g, batch_size=40, delete_frac=0.3, seed=2)
    for _ in range(3):
        b = stream.batch()
        o.apply(b)
    got = E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, 5, g.num_vertices, device="cpu")
    want = J_E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, 5, g.num_vertices)
    for name in ("edges", "mask", "degrees"):
        t = getattr(got, name)
        w = np.asarray(getattr(want, name))
        assert t.numpy().dtype == w.dtype and t.numpy().tobytes() == w.tobytes(), name
    assert (got.k, got.num_edges, got.mirrors) == (want.k, want.num_edges, want.mirrors)
    with pytest.raises(ValueError, match="not a multiple"):
        E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, 7, g.num_vertices, device="cpu")


def test_shard_unshard_round_trip_at_one_rank_and_more_ranks_raise(ordered):
    g, src, dst = ordered
    data = E.pack_ordered(src, dst, g.num_vertices, 6, device="cpu")
    s = E.shard_engine_data(data)
    assert (s.devices, s.k_pad, s.rows_per_device, s.partition_device(5)) == (1, 6, 6, 0)
    back = E.unshard_engine_data(s)
    for name in ("edges", "mask", "degrees"):
        assert torch.equal(getattr(back, name), getattr(data, name)), name
    assert (back.k, back.mirrors, back.num_edges) == (data.k, data.mirrors, data.num_edges)
    # The GAS apps take the sharded layout of one rank unchanged.
    assert torch.equal(E.pagerank(s), E.pagerank(data))
    # Two ranks: sharding needs no collective, and each rank keeps its row
    # block of the round-robin layout (partition p on rank p % 2) ...
    blocks = [E.shard_engine_data(data, GraphGroup(size=2, rank=r, device="cpu", backend="gloo", processes=(0, 0)))
              for r in (0, 1)]
    assert [b.local_partitions() for b in blocks] == [[0, 2, 4], [1, 3, 5]]
    assert [(b.devices, b.k_pad, b.rows_per_device) for b in blocks] == [(2, 6, 3)] * 2
    whole = torch.cat([b.edges for b in blocks])
    assert torch.equal(whole[[SH.partition_row(p, 6, 2) for p in range(6)]], data.edges)
    # ... while the streaming engine, still a world of one, refuses more ranks.
    o, _ = _orderers(ordered)
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        StreamingEngine(o, device="cpu", group=GraphGroup(size=2, rank=0, device="cpu", backend="gloo",
                                                          processes=(0, 0)))


def test_program_cache_counters_equal_reference():
    keys = [("scatter", 1), ("span_repair", 2), ("scatter", 1), ("compact", 3), ("scatter", 4), "odd", ("splice", 5),
            ("span_repair", 2), ("full_reorder", 6)]
    caches = [RX.ProgramCache(3), J_RX.ProgramCache(3)]
    snaps = [[], []]
    for i, key in enumerate(keys):
        for c, snap in zip(caches, snaps):
            if c.touch(key):
                pass
            elif c.get(key) is None:
                c.put(key, object())
            if i % 3 == 0:
                snap.append(c.counters_snapshot())
            assert c.touch(("never", i)) is False
    assert snaps[0] == snaps[1]
    assert caches[0].counters == caches[1].counters and list(caches[0]) == list(caches[1])
    assert snaps[0][0] != caches[0].counters  # earlier snapshots stay frozen (copy-on-write)


# ------------------------------------------------- engine against host replay
class HostReplay:
    """The stream of a ``StreamingEngine`` replayed with no device: the JAX
    package's orderer and numpy mirrors, driven by the engine's ladder logic
    (resync on re-layout, anticipation, async dispatch → flight → commit,
    abort on rescale). What it computes is what the engine's host state,
    ladder and rebuild log must equal."""

    def __init__(self, src, dst, nv, regions, config, span_repair, full_rebuild, flight):
        self.o = J_inc.IncrementalOrderer(src, dst, nv, regions=regions, config=J_inc.StreamConfig(**config))
        self.span_repair, self.full_rebuild, self.flight_len = span_repair, full_rebuild, flight
        self.flight, self.log, self.last_drift, self.rate = None, [], 1.0, 0.0
        self.rung_counts = {"none": 0, "partial": 0, "full": 0}

    def _resync(self):
        if self.flight is not None:
            self._abort("resync")
        self.o.drain_ops()
        self.o.needs_resync = False

    def _sync(self):
        if self.o.needs_resync:
            self._resync()
        else:
            self.o.drain_ops()

    def ingest(self, batch):
        counts = self.o.apply(batch)
        if self.o.needs_resync:
            self._resync()
            return counts, 0, True
        return counts, len(self.o.drain_ops()[0]), False

    def rescale(self, k):
        self._sync()
        if self.flight is not None:
            self._abort("rescale")
        self.o.relayout(k)
        self.o.drain_gather_map()
        self.o.needs_resync = False

    def _partial(self):
        o = self.o
        if self.span_repair == "host":
            o.partial_reorder()
            self._sync()
            return
        r0, r1 = o.span_bounds()
        u, v, valid = o.span_arrays(r0, r1)
        if int(valid.sum()) < 2:
            return
        cand = J_SRK.identity_candidate(valid) if self.span_repair == "device" else o.geo_span_candidate(u, v, valid)
        if self.span_repair == "oracle":
            o.apply_span_order(r0, r1, cand, emit_ops=False)
        else:
            o.partial_reorder_mirror(region=r0, candidate=cand, emit_ops=False)

    def _full(self):
        o = self.o
        if self.full_rebuild == "host":
            o.full_rebuild()
            self._resync()
            return
        u, v, valid = o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy()
        o.begin_full_rebuild()
        nv, n_live, mode = o.num_vertices, int(valid.sum()), self.full_rebuild
        deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
        if mode != "geo" and not J_FRK.greedy_fits_int32(n_live, o.config.k_min, o.config.k_max, int(deg.max())):
            mode = "geo"
            label = f"{self.full_rebuild}+host-fallback"
        else:
            label = self.full_rebuild
        if mode == "geo":
            chosen = J_FRK.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max)
        else:
            cand = (J_FRK.identity_candidate(valid) if mode == "device"
                    else J_FRK.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max))
            ks = J_FRK.eval_ks_full(o.config.k_min, o.config.k_max, o.regions)
            params = J_FRK.greedy_params(n_live, o.config.k_min, o.config.k_max, int(deg.max()))
            chosen, _ = J_FRK.select_full_order_host(u, v, valid, nv, cand, ks, *params,
                                                     J_FRK.fallback_positions(nv))
        live = np.asarray(chosen[:n_live], dtype=np.int64)
        self.flight = dict(mode=label, countdown=self.flight_len, src=u[live], dst=v[live], snapshot_edges=n_live)

    def _commit(self):
        fl, self.flight = self.flight, None
        replayed = self.o.rebuild_delta_batches
        ok = self.o.commit_full_rebuild(fl["src"], fl["dst"])
        splice_ops = 0
        if not ok:
            self._resync()
        else:
            splice_ops = len(self.o.drain_ops()[0])
        self.log.append(dict(kind="full_rebuild", mode=fl["mode"], committed=bool(ok), aborted=False,
                             snapshot_edges=fl["snapshot_edges"], replayed_batches=replayed,
                             splice_ops=splice_ops, flight_batches=self.flight_len - fl["countdown"]))

    def _abort(self, reason):
        fl, self.flight = self.flight, None
        self.o.abort_full_rebuild()
        self.log.append(dict(kind="full_rebuild", mode=fl["mode"], committed=False, aborted=True,
                             abort_reason=reason, snapshot_edges=fl["snapshot_edges"], replayed_batches=0,
                             splice_ops=0, flight_batches=self.flight_len - fl["countdown"]))

    def monitor(self):
        self._sync()
        d = self.o.drift()
        lookahead = 0.0
        if self.full_rebuild != "host" and self.flight_len > 0:
            self.rate = 0.7 * self.rate + 0.3 * max(0.0, d - self.last_drift)
            lookahead = self.flight_len * self.rate
        self.last_drift = d
        if self.flight is not None:
            self.flight["countdown"] -= 1
            if self.flight["countdown"] <= 0:
                self._commit()
                rung = "full"
            else:
                rung = "none"
        else:
            rung = self.o.maybe_escalate(partial_fn=self._partial, full_fn=self._full,
                                         full_lookahead=lookahead, partial_shadow=2.0 * lookahead)
            if self.flight is not None and self.flight["countdown"] <= 0:
                self._commit()
        self.rung_counts[rung] += 1
        return rung


def _timeless(log):
    return [{k: x for k, x in r.items() if not k.endswith("_s")} for r in log]


def _run_against_replay(ordered, *, span_repair="device", full_rebuild="host", flight=0, config=None,
                        batches=7, rescales=None, force_full=(), seed=13):
    """Drive the engine and the replay with the same stream; after every event
    the engine's pack equals ``pack_slots`` of its slots, its slots equal the
    replay's, and the ladder, stats and rebuild log agree."""
    g, src, dst = ordered
    config = dict(partial_drift=1.0, full_drift=99.0, span_regions=2) if config is None else config
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=4, config=StreamConfig(**config))
    eng = StreamingEngine(o, device="cpu", span_repair=span_repair, full_rebuild=full_rebuild, rebuild_flight=flight)
    rep = HostReplay(src, dst, g.num_vertices, 4, config, span_repair, full_rebuild, flight)
    s1, s2 = SyntheticStream(g, batch_size=32, seed=seed), J_upd.SyntheticStream(J_rmat(7, 6, seed=0),
                                                                                 batch_size=32, seed=seed)
    rungs, log = [], []
    for b in range(batches):
        if rescales and b in rescales:
            rs = eng.rescale(rescales[b], verify=True)
            rep.rescale(rescales[b])
            assert (rs.k_new, rs.cross_device_edges, rs.cross_process_edges) == (rescales[b], 0, 0)
            _same_slots(o, rep.o)
        stats = eng.ingest(s1.batch(), verify=True)
        counts, n_ops, resynced = rep.ingest(s2.batch())
        assert (stats.inserted, stats.deleted, stats.skipped, stats.scatter_ops, stats.resynced, stats.num_edges) == (
            counts["inserted"], counts["deleted"], counts["skipped"], n_ops, resynced, rep.o.num_edges)
        _same_slots(o, rep.o)
        if b in force_full:
            o.drift = rep.o.drift = lambda: 200.0
        rung = eng.monitor()
        assert rung == rep.monitor()
        if b in force_full:
            del o.drift, rep.o.drift
        rungs.append(rung)
        eng.verify_bit_identity()
        _same_slots(o, rep.o)
        log += eng.drain_rebuild_events()
    assert eng.rung_counts == rep.rung_counts
    assert _timeless(log) == rep.log
    return eng, rungs, log


@pytest.mark.parametrize("span_repair", ["device", "host", "oracle", "differential"])
def test_engine_span_modes_bit_identical_and_equal_host_replay(ordered, span_repair):
    eng, rungs, _ = _run_against_replay(ordered, span_repair=span_repair, rescales={3: 6})
    assert rungs.count("partial") >= 5 and eng.last_repair == span_repair
    assert eng.rung_s["partial"] > 0


# The host full rung is synchronous: it has no flight.
@pytest.mark.parametrize("full_rebuild,flight", [("host", 0)] + [(m, f) for m in ("geo", "device", "differential")
                                                                  for f in (0, 2)])
def test_engine_full_modes_bit_identical_and_equal_host_replay(ordered, full_rebuild, flight):
    eng, rungs, log = _run_against_replay(ordered, full_rebuild=full_rebuild, flight=flight, config=QUIET,
                                          batches=6, force_full=(1,), rescales={5: 3})
    assert rungs[1] == "full"
    if full_rebuild == "host":
        assert log == [] and eng.last_repair in ("resync", "")
        return
    (rec,) = log
    assert rec["committed"] and not rec["aborted"] and rec["mode"] == full_rebuild
    assert rec["flight_batches"] == rec["replayed_batches"] == flight
    assert rungs[1 + flight] == "full" and all(r == "none" for r in rungs[2:1 + flight])
    if flight:
        assert rec["splice_ops"] > 0  # the batches ingested in flight landed in the committed pack


@pytest.mark.parametrize("full_rebuild", ["device", "geo"])
def test_engine_rebuild_aborts_on_rescale(ordered, full_rebuild):
    eng, rungs, log = _run_against_replay(ordered, full_rebuild=full_rebuild, flight=3, config=QUIET,
                                          batches=7, force_full=(1, 3), rescales={3: 6})
    aborted, committed = log
    assert aborted["aborted"] and aborted["abort_reason"] == "rescale" and aborted["flight_batches"] == 1
    assert committed["committed"] and committed["flight_batches"] == 3
    assert rungs[1] == rungs[3] == rungs[6] == "full" and rungs[2] == rungs[4] == rungs[5] == "none"


def test_engine_scatter_never_repeats_a_slot(ordered, monkeypatch):
    """Real slot ops name each slot once per scatter; only the padding repeats
    (row 0's scratch column, with zeros)."""
    g, src, dst = ordered
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=4)
    eng = StreamingEngine(o, device="cpu")
    seen = []
    real = eng._slot_op_operands

    def spy(ops, cap, e_cap):
        out = real(ops, cap, e_cap)
        seen.append((len(ops), out[0].numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(eng, "_slot_op_operands", spy)
    stream = SyntheticStream(g, batch_size=64, delete_frac=0.4, seed=1)
    for _ in range(5):
        eng.ingest(stream.batch(), verify=True)
    assert seen
    for n, rows, cols in seen:
        slots = set(zip(rows[:n].tolist(), cols[:n].tolist()))
        assert len(slots) == n and all(c < o.slots_per_region for _, c in slots)
        assert (rows[n:] == 0).all() and (cols[n:] == o.slots_per_region).all()


def test_engine_pagerank_on_stream_pack_close_to_reference(ordered):
    g, src, dst = ordered
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=4)
    eng = StreamingEngine(o, device="cpu")
    stream = SyntheticStream(g, batch_size=48, seed=3)
    for _ in range(3):
        eng.ingest(stream.batch())
    eng.rescale(5)
    got = E.pagerank(eng.data, iterations=20).numpy()
    want = np.asarray(J_E.pagerank(J_E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, g.num_vertices),
                                   J_MM.make_test_mesh(data=1, model=1), iterations=20))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert torch.equal(E.sssp(eng.data, source=1)[0], E.sssp(eng.oracle_pack(), source=1)[0])


def test_engine_device_rebuild_falls_back_on_int32_overflow(caplog):
    """A star past the int32 priority bound: the device full rung applies the
    host order instead (mode ``device+host-fallback``), warns once."""
    n = 26_000
    src, dst = np.zeros(n, dtype=np.int64), np.arange(1, n + 1, dtype=np.int64)
    o = IncrementalOrderer(src, dst, n + 1, regions=4, config=StreamConfig(**QUIET))
    assert not FRK.greedy_fits_int32(n, 4, 128, n)
    eng = StreamingEngine(o, device="cpu", full_rebuild="device", rebuild_flight=0)
    with caplog.at_level(logging.WARNING, logger=ingest_mod.__name__):
        o.drift = lambda: 99.0
        assert eng.monitor() == "full" and eng.monitor() == "full"
        del o.drift
    recs = eng.drain_rebuild_events()
    assert [r["mode"] for r in recs] == ["device+host-fallback"] * 2 and all(r["committed"] for r in recs)
    assert len([r for r in caplog.records if "falling back to host geo_order" in r.message]) == 1
    eng.verify_bit_identity()


def test_engine_rejects_bad_modes_and_needs_a_card_by_default(ordered):
    g, src, dst = ordered
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=2)
    for kw in (dict(span_repair="x"), dict(full_rebuild="x"), dict(rebuild_flight=-1)):
        with pytest.raises(ValueError):
            StreamingEngine(o, device="cpu", **kw)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEngine(o)


def test_engine_skips_tiny_spans():
    o = IncrementalOrderer(np.array([0, 2]), np.array([1, 3]), 8, regions=2)
    eng = StreamingEngine(o, device="cpu")
    o.apply(EdgeUpdateBatch(insert=np.zeros((0, 2)), delete=np.array([[0, 1]])))
    eng._sync_pending()
    o.drift = lambda: 1.05
    assert eng.monitor() == "partial" and eng.last_repair == "skipped"
    eng.verify_bit_identity()
