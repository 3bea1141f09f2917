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
import torch_threads  # noqa: F401  (first: the thread count of this process)

import collections
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
from torch_stream_replay import HostReplay, timeless

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


def test_relayout_gather_map_after_heavy_deletes_equals_reference(ordered):
    """A relayout to the same region count after most edges were deleted: the
    old layout is full of gaps, and the gather map still equals the JAX
    package's, -1 at every free slot of the new layout."""
    g, src, dst = ordered
    o, jo = _orderers(ordered, regions=4)
    rng = np.random.default_rng(11)
    gone = np.stack([src, dst], axis=1)[rng.random(src.shape[0]) < 0.7]
    batch = EdgeUpdateBatch(insert=np.empty((0, 2), np.int64), delete=gone)
    assert o.apply(batch) == jo.apply(J_upd.EdgeUpdateBatch(insert=batch.insert, delete=batch.delete))
    o.drain_ops(), jo.drain_ops()
    o.relayout(4), jo.relayout(4)
    gm, jgm = o.drain_gather_map(), jo.drain_gather_map()
    np.testing.assert_array_equal(gm, jgm)
    assert (gm[~o.slot_valid] == -1).all() and (gm[o.slot_valid] >= 0).all()
    assert o.num_edges == src.shape[0] - gone.shape[0]
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


# ------------------------------------------------------ the greedy's CUDA kernel
def _greedy_features_case():
    """A small graph with what the kernel must get right: triangles (slots
    with both ends in a frontier), a hub of degree 40 whose spokes are also
    joined in pairs, and separate pieces (the permpos fallback starts each),
    plus two dead slots."""
    edges = [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4), (2, 4), (10, 11), (11, 12), (10, 12), (20, 21)]
    edges += [(30, 31 + k) for k in range(40)] + [(31, 32), (33, 34), (35, 36), (50, 51), (60, 61)]
    e = np.array(edges, np.int64)
    valid = np.ones(len(e), bool)
    valid[[10, 25]] = False
    return e[:, 0] * valid, e[:, 1] * valid, valid, 80


EMULATION_CASES = CASES + ["features"]


def _emulation_inputs(case: str):
    return _greedy_features_case() if case == "features" else _twin_inputs(case)


def _kernel_emulation(u, v, valid, nv, alpha, beta, delta, permpos, batch):
    """The per-step algorithm of ``csrc/full_reorder.cu``, step for step, in
    numpy: the packed-key argmin (and the permpos fallback), the one-hop walk
    over v_min's incidence entries, the two-hop walk flattened over prefix
    sums of each frontier batch's list lengths (``batch`` vertices at a time;
    the kernel's is its block size) with a binary search for the owning
    vertex, the "both ends in the frontier: take from the u side" rule, and
    the two-hop's slots collected before any write of M (the kernel's
    barrier). Returns the keys, the step count and what the steps met."""
    ptr, inc = (x.numpy().astype(np.int64) for x in FRK.incidence_device(_t(u), _t(v), torch.from_numpy(valid), nv))
    u, v = np.asarray(u, np.int64), np.asarray(v, np.int64)
    cap = len(u)
    d = np.diff(ptr).copy()
    m = np.zeros(nv, np.int64)
    touched = np.zeros(nv, bool)
    selected = np.zeros(nv, bool)
    fr = np.zeros(nv, bool)
    done = ~valid.copy()
    keys = np.full((4, cap), 2**31 - 1, np.int64)
    e_live = ptr[nv] // 2
    met = dict(ties=0, fallbacks=0, both_in_frontier=0, max_list=0)
    t = i = 0
    while t < nv and i < e_live:
        cand = np.flatnonzero((d > 0) & touched & ~selected)
        if cand.size:
            pri = alpha * d[cand] - beta * m[cand]
            biased = ((pri.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000).astype(np.uint64)
            packed = biased << np.uint64(32) | cand.astype(np.uint64)  # argmin's first index on ties
            vmin = int(cand[np.argmin(packed)])
            met["ties"] += int((pri == pri.min()).sum() > 1)
        else:
            elig = np.flatnonzero((d > 0) & ~selected)
            vmin = int(elig[np.argmin(permpos[elig] << 32 | elig)]) if elig.size else 0
            met["fallbacks"] += 1
        frontier, n1 = [], 0
        for j in range(ptr[vmin], ptr[vmin + 1]):  # one-hop
            s = inc[j]
            if done[s]:
                continue
            n1 += 1
            other = v[s] if u[s] == vmin else u[s]
            keys[:, s] = (t, 0, other, 0)
            d[other] -= 1
            done[s] = True
            if not fr[other]:
                fr[other] = True
                frontier.append(other)
        i1 = i + n1
        m[frontier] = i1
        touched[frontier] = True
        touched[vmin] = selected[vmin] = True
        d[vmin] = 0
        th = []
        if n1 > 0:  # two-hop: collected first, written after the barrier
            for f0 in range(0, len(frontier), batch):
                fb = np.asarray(frontier[f0:f0 + batch])
                lens = ptr[fb + 1] - ptr[fb]
                met["max_list"] = max(met["max_list"], int(lens.max()))
                foff = np.concatenate([[0], np.cumsum(lens)])
                for w in range(foff[-1]):
                    a = int(np.searchsorted(foff, w, side="right")) - 1  # s_foff[a] <= w < s_foff[a + 1]
                    s = inc[ptr[fb[a]] + w - foff[a]]
                    if done[s]:
                        continue
                    u_in = fr[u[s]]
                    met["both_in_frontier"] += int(u_in and fr[v[s]])
                    tu = u[s] if u_in else v[s]
                    if tu != fb[a]:
                        continue  # both ends in the frontier: taken from the u side
                    wo = v[s] if u_in else u[s]
                    if touched[wo] and not selected[wo] and m[wo] > 0 and i1 - m[wo] <= delta and wo != vmin:
                        th.append((s, tu, wo))
        i2 = i1 + len(th)
        for s, tu, wo in th:
            keys[:, s] = (t, 1, tu, wo)
            d[tu] -= 1
            d[wo] -= 1
            m[tu] = m[wo] = i2
            done[s] = True
        fr[frontier] = False
        i, t = i2, t + 1
    return keys, t, met


@pytest.mark.parametrize("case", EMULATION_CASES)
def test_incidence_device_equals_host_incidence(case):
    u, v, valid, nv = _emulation_inputs(case)
    ptr, slots = FRK._incidence(np.asarray(u, np.int64), np.asarray(v, np.int64), valid, nv)
    got_ptr, got_slots = FRK.incidence_device(_t(u), _t(v), torch.from_numpy(valid), nv)
    assert got_ptr.dtype == got_slots.dtype == torch.int32 and got_slots.shape == (2 * len(u),)
    np.testing.assert_array_equal(got_ptr.numpy(), ptr)
    np.testing.assert_array_equal(got_slots.numpy()[: ptr[nv]], slots)
    assert set(got_slots.numpy()[ptr[nv]:].tolist()) <= set(np.flatnonzero(~valid).tolist())  # dead slots last


@pytest.mark.parametrize("batch", [2, 1024], ids=["batch2", "batch1024"])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_kernel_emulation_equals_host_mirror(case, batch):
    u, v, valid, nv = _emulation_inputs(case)
    alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
    host, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    keys, kernel_steps, _ = _kernel_emulation(u, v, valid, nv, alpha, beta, delta, permpos, batch)
    assert kernel_steps == steps
    np.testing.assert_array_equal(np.lexsort((np.arange(len(u)), *keys[::-1])), host)


def test_kernel_emulation_cases_cover_ties_fallbacks_hubs_and_shared_frontier_slots():
    """Across the cases the emulated steps meet a priority tie, more than one
    fallback start (separate pieces), a hub's long list in a frontier and a
    slot with both ends in the frontier."""
    met = collections.Counter()
    for case in EMULATION_CASES:
        u, v, valid, nv = _emulation_inputs(case)
        alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
        one = _kernel_emulation(u, v, valid, nv, alpha, beta, delta, permpos, 1024)[2]
        met.update({k: x for k, x in one.items() if k != "max_list"})
        met["max_list"] = max(met["max_list"], one["max_list"])
    assert met["ties"] > 0 and met["fallbacks"] > 1 and met["both_in_frontier"] > 0 and met["max_list"] >= 30


@pytest.mark.parametrize("case", CASES)
def test_full_order_device_on_cpu_launches_nothing(case):
    u, v, valid, nv = _twin_inputs(case)
    alpha, beta, delta, permpos = _greedy_args(u, v, valid, nv)
    host, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    want = np.asarray(J_FRK.full_order_device(
        u.astype(np.int32), v.astype(np.int32), valid, nv,
        np.int32(alpha), np.int32(beta), np.int32(delta), permpos.astype(np.int32)))
    before = FRK.launches
    got = FRK.full_order_device(_t(u), _t(v), torch.from_numpy(valid), nv, alpha, beta, delta, _t(permpos),
                                steps=steps).numpy()
    assert FRK.launches == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


def test_greedy_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel route never runs the plain version: on CPU tensors it raises."""
    u, v, valid, nv = _twin_inputs("ring")
    with pytest.raises(ValueError, match="CUDA"):
        FRK.greedy_keys(_t(u), _t(v), torch.from_numpy(valid), nv, 3, 1, 2, _t(FRK.fallback_positions(nv)))


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
    # ... and a streaming engine of each rank commits exactly that rank's
    # block of the slot pack, with no process group behind the stand-in.
    o, _ = _orderers(ordered)
    slots = E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, g.num_vertices, device="cpu")
    for r in (0, 1):
        group = GraphGroup(size=2, rank=r, device="cpu", backend="gloo", processes=(0, 0))
        eng = StreamingEngine(o, group=group, commit="pack")
        want = E.shard_engine_data(slots, group)
        assert torch.equal(eng.data.edges, want.edges)
        assert torch.equal(eng.data.mask, want.mask) and torch.equal(eng.data.degrees, slots.degrees)
        assert eng.data.local_partitions() == want.local_partitions() and eng.g == 2


def test_from_restored_and_stream_commit_equal_the_pack_commit(ordered):
    o, _ = _orderers(ordered, regions=5)
    stream = SyntheticStream(ordered[0], batch_size=40, delete_frac=0.3, seed=4)
    for _ in range(3):
        o.apply(stream.batch())
    o.drain_ops()
    want = StreamingEngine(o, device="cpu").data
    for eng in (StreamingEngine.from_restored(o, device="cpu"), StreamingEngine(o, device="cpu", commit="stream")):
        for name in ("edges", "mask", "degrees"):
            got, ref = getattr(eng.data, name), getattr(want, name)
            assert got.dtype == ref.dtype and got.numpy().tobytes() == ref.numpy().tobytes(), name
        assert (eng.data.k, eng.data.num_edges) == (want.k, want.num_edges)
        eng.verify_bit_identity()
    with pytest.raises(ValueError, match="commit"):
        StreamingEngine(o, device="cpu", commit="other")


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
# HostReplay (tests/torch_stream_replay.py) replays the stream with the JAX
# package's orderer and numpy mirrors.
def _run_against_replay(ordered, *, span_repair="device", full_rebuild="host", flight=0, config=None,
                        batches=7, rescales=None, force_full=(), seed=13):
    """Drive the engine and the replay with the same stream; after every event
    the engine's pack equals ``pack_slots`` of its slots, its slots equal the
    replay's, and the ladder, stats and rebuild log agree."""
    g, src, dst = ordered
    config = dict(partial_drift=1.0, full_drift=99.0, span_regions=2) if config is None else config
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=4, config=StreamConfig(**config))
    eng = StreamingEngine(o, device="cpu", span_repair=span_repair, full_rebuild=full_rebuild, rebuild_flight=flight)
    rep = HostReplay((J_inc, J_SRK, J_FRK), src, dst, g.num_vertices, 4, config, span_repair, full_rebuild, flight)
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
    assert timeless(log) == rep.log
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
