"""The port's out-of-core pipeline against the JAX package on the same inputs.

* ``data/shards.py``, ``data/pipeline.py``, ``stream/spill.py`` and the host
  and mirror chunk modes of ``core/hier_order.py`` are numpy copies: their
  outputs equal the reference's exactly, and the properties the reference's
  ``tests/test_outofcore.py`` asserts hold for them too (the elastic
  controller's test waits for the port's controller).
* ``chunk_mode="device"`` with ``device="cpu"`` runs the greedy's plain
  version and equals the JAX package's mirror; a block past the greedy's
  int32 bound is ordered by host ``geo_order`` in both, without the greedy.
* One module-scoped cluster of 2 processes × 2 gloo ranks runs
  ``tests/torch_outofcore_harness.py`` (no JAX there) at the reference
  harness's configuration; the parent holds its commit, rescales and stream
  phase against the JAX package's in-core oracle (``hier_order_edges`` +
  ``pack_slots``), byte for byte.

Tolerance: exact everywhere; the RF gates are the reference's 1.10.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch
from conftest import hypothesis_or_stub

import torch_outofcore_harness as OH
from repro.core import hier_order as J_HO
from repro.core.baselines import mix_hash as J_mix_hash
from repro.core.graph import Graph as J_Graph
from repro.core.graph import rmat_graph as J_rmat
from repro.core.ordering import geo_order as J_geo_order
from repro.data import pipeline as J_dp
from repro.data import shards as J_DS
from repro.graphs import engine as J_E
from repro.stream import spill as J_spill
from repro.stream import updates as J_upd
from repro_torch.core import cep
from repro_torch.core import hier_order as HO
from repro_torch.core.baselines import mix_hash, splitmix64
from repro_torch.core.graph import grid_graph, powerlaw_graph, rmat_graph
from repro_torch.core.metrics import replication_factor_ordered
from repro_torch.core.ordering import geo_order
from repro_torch.data import pipeline as dp
from repro_torch.data import shards as DS
from repro_torch.graphs import engine as E
from repro_torch.kernels import full_reorder as FRK
from repro_torch.launch import multihost as MH
from repro_torch.launch import sharding as SH
from repro_torch.stream import EdgeUpdateBatch, OutOfCoreIngestor, SpillConfig, SpillStore

given, settings, st = hypothesis_or_stub()

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_PROCS, DEVS_PER_PROC = 2, 2
G = N_PROCS * DEVS_PER_PROC
CLUSTER_TIMEOUT_S = 150.0  # the whole cluster, start-up included


def _edges(g) -> np.ndarray:
    return np.stack([g.src, g.dst], axis=1).astype(np.int64)


def _jcfg(cfg: HO.HierConfig) -> J_HO.HierConfig:
    return J_HO.HierConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------- stateless draws (shards)
def test_mix_hash_scalar_vector_agree_and_equal_reference():
    for seed in (0, 1, 2**31 - 1):
        for major in (0, 17, 2**40):
            vec = mix_hash(seed, np.asarray([major, major + 1]), 5, 3)
            assert int(vec[0]) == int(mix_hash(seed, major, 5, 3))
            np.testing.assert_array_equal(vec, J_mix_hash(seed, np.asarray([major, major + 1]), 5, 3))
            vec2 = mix_hash(seed, major, np.arange(5, 8), 3)
            assert int(vec2[0]) == int(mix_hash(seed, major, 5, 3))
            np.testing.assert_array_equal(vec2, J_mix_hash(seed, major, np.arange(5, 8), 3))


@given(seed=st.integers(0, 2**31 - 1), major=st.integers(0, 2**40), minor=st.integers(0, 2**20),
       salt=st.integers(0, 255))
@settings(max_examples=40, deadline=None)
def test_mix_hash_property_equals_reference(seed, major, minor, salt):
    scalar = int(mix_hash(seed, major, minor, salt))
    assert scalar == int(J_mix_hash(seed, major, minor, salt))
    assert int(mix_hash(seed, np.asarray([major, major + 1]), minor, salt)[0]) == scalar


def test_stream_edges_are_raw_mix_hash_draws_and_equal_reference():
    plan, jplan = DS.RmatShardPlan(scale=8, edge_factor=4, seed=9), J_DS.RmatShardPlan(scale=8, edge_factor=4, seed=9)
    got = DS.stream_edges(plan, batch=5, size=64, salt=2)
    pos = np.arange(64, dtype=np.uint64)
    u = mix_hash(9, 5, pos, DS._SALT_STREAM + 4) % np.uint64(plan.num_vertices)
    v = mix_hash(9, 5, pos, DS._SALT_STREAM + 5) % np.uint64(plan.num_vertices)
    lo, hi = np.minimum(u, v).astype(np.int64), np.maximum(u, v).astype(np.int64)
    np.testing.assert_array_equal(got, np.stack([lo[lo != hi], hi[lo != hi]], axis=1))
    for batch in range(4):
        np.testing.assert_array_equal(DS.stream_edges(plan, batch, 300), J_DS.stream_edges(jplan, batch, 300))


@given(seed=st.integers(0, 2**16), start=st.integers(0, 2**12), n=st.integers(1, 64))
@settings(max_examples=20, deadline=None)
def test_candidate_edges_stateless_in_index_and_equal_reference(seed, start, n):
    plan = DS.RmatShardPlan(scale=7, edge_factor=8, seed=seed)
    idx = np.arange(start % plan.num_candidates, plan.num_candidates, 7)[:n]
    subset = DS.candidate_edges(plan, idx)
    np.testing.assert_array_equal(subset, np.concatenate([DS.candidate_edges(plan, np.asarray([i])) for i in idx]))
    np.testing.assert_array_equal(subset, J_DS.candidate_edges(J_DS.RmatShardPlan(scale=7, edge_factor=8, seed=seed),
                                                               idx))


@pytest.mark.parametrize("num_shards", [1, 3, 5])
def test_shards_partition_the_candidates_and_equal_reference(num_shards):
    kw = dict(scale=8, edge_factor=8, seed=1, num_shards=num_shards)
    plan, jplan = DS.RmatShardPlan(**kw), J_DS.RmatShardPlan(**kw)
    np.testing.assert_array_equal(plan.shard_bounds(), jplan.shard_bounds())
    shards = [DS.shard_edges(plan, s) for s in range(num_shards)]
    for s, got in enumerate(shards):
        np.testing.assert_array_equal(got, J_DS.shard_edges(jplan, s))
    np.testing.assert_array_equal(np.concatenate(shards), DS.candidate_edges(plan, np.arange(plan.num_candidates)))
    with pytest.raises(ValueError):
        DS.shard_edges(plan, num_shards)


@pytest.mark.parametrize("dedup", [True, False])
def test_sample_and_dedup_equal_reference(dedup):
    kw = dict(scale=9, edge_factor=8, seed=4)
    plan, jplan = DS.RmatShardPlan(**kw), J_DS.RmatShardPlan(**kw)
    got = DS.sample_edges(plan, stride=4, dedup=dedup)
    np.testing.assert_array_equal(got, J_DS.sample_edges(jplan, stride=4, dedup=dedup))
    if not dedup:
        np.testing.assert_array_equal(got, DS.candidate_edges(plan, np.arange(0, plan.num_candidates, 4)))
    idx = np.arange(0, plan.num_candidates, 3)
    np.testing.assert_array_equal(DS.candidate_edges(plan, idx, dedup=True),
                                  J_DS.candidate_edges(jplan, idx, dedup=True))


# ------------------------------------------------------ content addressing
def test_region_of_symmetric_and_equal_reference():
    ing, jing = OutOfCoreIngestor(2**20, 7, 4), J_spill.OutOfCoreIngestor(2**20, 7, 4)
    for u, v in np.random.default_rng(0).integers(0, 2**20, size=(50, 2)).tolist():
        key = np.uint64(min(u, v)) * np.uint64(2**20) + np.uint64(max(u, v))
        assert ing.region_of(u, v) == ing.region_of(v, u) == jing.region_of(u, v)
        assert ing.region_of(u, v) == int(splitmix64(key) % np.uint64(7))


@given(u=st.integers(0, 2**20 - 1), v=st.integers(0, 2**20 - 1))
@settings(max_examples=30, deadline=None)
def test_region_of_property_equals_reference(u, v):
    ing = OutOfCoreIngestor(2**20, regions=7, slots_per_region=4)
    assert ing.region_of(u, v) == ing.region_of(v, u) == J_spill.OutOfCoreIngestor(2**20, 7, 4).region_of(u, v)


# ----------------------------------------------------- hierarchical order
@pytest.fixture(scope="module")
def rmat12():
    g = rmat_graph(12, 16, seed=0)
    return g, _edges(g)


@pytest.mark.parametrize("mode", ["geo", "bfs"])
def test_locality_rank_equals_reference(rmat12, mode):
    g, edges = rmat12
    sample = edges[::3]
    np.testing.assert_array_equal(HO.locality_rank(sample, g.num_vertices, 1, mode=mode),
                                  J_HO.locality_rank(sample, g.num_vertices, 1, mode=mode))


def test_chunk_load_additive_across_shards_and_equal_reference():
    plan = DS.RmatShardPlan(scale=9, edge_factor=8, seed=0, num_shards=4)
    edges = np.concatenate([DS.shard_edges(plan, s) for s in range(4)])
    rank = HO.locality_rank(edges, plan.num_vertices, seed=0)
    whole = HO.chunk_load(rank, edges)
    np.testing.assert_array_equal(whole, sum(HO.chunk_load(rank, DS.shard_edges(plan, s)) for s in range(4)))
    np.testing.assert_array_equal(whole, J_HO.chunk_load(rank, edges))
    np.testing.assert_array_equal(HO.edge_chunk_key(rank, edges), J_HO.edge_chunk_key(rank, edges))


@pytest.mark.parametrize("cfg", [HO.HierConfig(num_chunks=6), HO.HierConfig(num_chunks=2, max_chunk_edges=4096)],
                         ids=["six-chunks", "edge-bound"])
def test_chunk_splits_and_membership_equal_reference(rmat12, cfg):
    g, edges = rmat12
    rank = HO.locality_rank(edges, g.num_vertices, seed=0)
    load = HO.chunk_load(rank, edges)
    splits = HO.chunk_splits(load, cfg)
    np.testing.assert_array_equal(splits, J_HO.chunk_splits(load, _jcfg(cfg)))
    assert splits[0] == 0 and splits[-1] == g.num_vertices and (np.diff(splits) > 0).all()
    cid = HO.chunk_of_edges(splits, rank, edges)
    np.testing.assert_array_equal(cid, J_HO.chunk_of_edges(splits, rank, edges))
    counts = np.bincount(cid, minlength=splits.shape[0] - 1)
    assert (np.abs(counts - edges.shape[0] / (splits.shape[0] - 1)) <= load.max() + 1).all()
    assert counts.max() <= max(cfg.max_chunk_edges, edges.shape[0] // cfg.num_chunks + 1) + load.max()


def _dup_block():
    g = rmat_graph(7, 6, seed=2)
    edges = _edges(g)
    dup = np.concatenate([edges, edges[:40], edges[:10]])
    return dup[np.random.default_rng(0).permutation(dup.shape[0])], g.num_vertices


@pytest.mark.parametrize("mode", ["host", "mirror"])
def test_order_edge_block_equals_reference_and_duplicates_ride_adjacent(mode):
    dup, nv = _dup_block()
    cfg = HO.HierConfig(chunk_mode=mode)
    perm = HO.order_edge_block(dup, cfg, seed=0)
    np.testing.assert_array_equal(perm, J_HO.order_edge_block(dup, _jcfg(cfg), seed=0))
    key = dup[perm, 0] * np.int64(nv) + dup[perm, 1]
    assert sorted(perm.tolist()) == list(range(dup.shape[0]))
    assert np.flatnonzero(np.diff(key) != 0).shape[0] + 1 == np.unique(key).shape[0]  # copies contiguous


@pytest.mark.parametrize("block", ["rmat7", "duplicates"])
def test_device_chunk_mode_on_the_cpu_equals_reference_mirror(block):
    """``chunk_mode="device"`` with ``device="cpu"``: the greedy's plain
    version, for the mirror's step count, equals the JAX package's mirror."""
    edges = _edges(J_rmat(7, 6, seed=0)) if block == "rmat7" else _dup_block()[0]
    got = HO.order_edge_block(edges, HO.HierConfig(chunk_mode="device"), seed=3, device="cpu")
    np.testing.assert_array_equal(got, J_HO.order_edge_block(edges, J_HO.HierConfig(chunk_mode="mirror"), seed=3))
    for n in (0, 1):  # nothing to order
        np.testing.assert_array_equal(HO.order_edge_block(edges[:n], HO.HierConfig(chunk_mode="device"),
                                                          device="cpu"), np.arange(n))


def test_block_past_the_int32_bound_is_ordered_on_the_host(monkeypatch):
    """Out-of-core chunks never abort: where ``greedy_fits_int32`` fails, the
    device and mirror modes order by host ``geo_order``, as the reference's,
    and the greedy is not called."""
    edges = _edges(rmat_graph(7, 6, seed=0))
    cfg = HO.HierConfig(chunk_mode="device", k_max=1 << 23)
    assert not FRK.greedy_fits_int32(edges.shape[0], cfg.k_min, cfg.k_max, 1)

    def no_greedy(*a, **k):
        raise AssertionError("the greedy ran past its int32 bound")

    monkeypatch.setattr(FRK, "full_order_device", no_greedy)
    monkeypatch.setattr(FRK, "full_order_host", no_greedy)
    got = HO.order_edge_block(edges, cfg, seed=1, device="cpu")
    np.testing.assert_array_equal(got, J_HO.order_edge_block(edges, _jcfg(cfg), seed=1))
    np.testing.assert_array_equal(got, HO.order_edge_block(edges, dataclasses.replace(cfg, chunk_mode="host"), seed=1))


def test_device_mode_reads_device_and_raises_without_a_card(monkeypatch):
    """``device=None`` means CUDA: with no CUDA device the device chunk mode
    raises, at every entry point, before any work; the other modes never read
    ``device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat_graph(6, 4, seed=0)
    dev_cfg = HO.HierConfig(chunk_mode="device", num_chunks=2)
    for call in (lambda: HO.order_edge_block(_edges(g), dev_cfg), lambda: HO.hier_order(g, dev_cfg),
                 lambda: HO.hier_order_edges(_edges(g), g.num_vertices, dev_cfg),
                 lambda: HO.repair_seams(_edges(g), [100, 100], dev_cfg),
                 lambda: HO.order_edge_block(_edges(g)[:1], dev_cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    HO.hier_order(g, HO.HierConfig(chunk_mode="mirror", num_chunks=2), device="cuda")


def test_seam_spans_equal_reference_and_never_overlap():
    for sizes, w in (([100, 30, 8, 200], 2048), ([5, 0, 7], 16), ([64, 64, 64], 10), ([1, 9, 1], 4)):
        spans = HO.seam_spans(sizes, w)
        assert spans == J_HO.seam_spans(sizes, w)
        assert all(lo < hi for lo, hi in spans) and all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert HO.seam_spans([5, 0, 7], seam_window=16) == []


@pytest.mark.parametrize("mode", ["host", "mirror"])
def test_repair_seams_equals_reference(rmat12, mode):
    _, edges = rmat12
    cfg = HO.HierConfig(chunk_mode=mode, seam_window=96)
    sizes = [9000, 12000, 20000, edges.shape[0] - 41000]
    got = HO.repair_seams(edges, sizes, cfg, base_seed=5)
    np.testing.assert_array_equal(got, J_HO.repair_seams(edges, sizes, _jcfg(cfg), base_seed=5))
    assert not np.array_equal(got, edges) and np.array_equal(got[:8000], edges[:8000])


@pytest.mark.parametrize("cfg", [HO.HierConfig(num_chunks=4), HO.HierConfig(num_chunks=3, chunk_mode="mirror",
                                                                            seam_window=64),
                                 HO.HierConfig(num_chunks=4, rank_mode="bfs", seam_window=32)],
                         ids=["host", "mirror-seams", "bfs-seams"])
def test_hier_order_equals_reference(cfg):
    g = rmat_graph(9, 8, seed=0)
    perm, info = HO.hier_order(g, cfg)
    jperm, jinfo = J_HO.hier_order(J_rmat(9, 8, seed=0), _jcfg(cfg))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(info["splits"], jinfo["splits"])
    assert info["chunk_sizes"] == jinfo["chunk_sizes"] and sum(info["chunk_sizes"]) == g.num_edges
    assert sorted(perm.tolist()) == list(range(g.num_edges))
    np.testing.assert_array_equal(perm, HO.hier_order(g, cfg)[0])  # deterministic


def test_hier_order_device_on_the_cpu_equals_reference_mirror():
    """The whole pipeline with every chunk and seam on the greedy's plain
    version equals the JAX package's mirror mode, duplicates and a sample
    included."""
    plan = DS.RmatShardPlan(scale=9, edge_factor=6, seed=2, num_shards=3)
    edges = np.concatenate([DS.shard_edges(plan, s) for s in range(3)])
    sample = DS.sample_edges(plan, 2)
    cfg = HO.HierConfig(num_chunks=3, max_chunk_edges=1 << 12, seam_window=48, chunk_mode="device")
    got, info = HO.hier_order_edges(edges, plan.num_vertices, cfg, sample=sample, device="cpu")
    want, jinfo = J_HO.hier_order_edges(edges, plan.num_vertices, _jcfg(dataclasses.replace(cfg, chunk_mode="mirror")),
                                        sample=sample)
    np.testing.assert_array_equal(got, want)
    assert info["chunk_sizes"] == jinfo["chunk_sizes"] and info["num_chunks"] >= 3


def _worst_ratio(g, cfg) -> float:
    ordered, _ = HO.hier_order_edges(_edges(g), g.num_vertices, cfg)
    o = geo_order(g, seed=0)
    return max(replication_factor_ordered(ordered[:, 0], ordered[:, 1], k, g.num_vertices)
               / replication_factor_ordered(g.src[o], g.dst[o], k, g.num_vertices) for k in (4, 8, 16, 32, 64, 128))


@pytest.mark.parametrize("name,make,cfg", [
    ("grid128", lambda: grid_graph(128), HO.HierConfig(num_chunks=8, rank_mode="bfs")),
    ("powerlaw60k", lambda: powerlaw_graph(60_000, seed=0), HO.HierConfig(num_chunks=8)),
    ("rmat14", lambda: rmat_graph(14, 16, seed=0), HO.HierConfig(num_chunks=4)),
])
def test_hier_rf_within_margin_of_incore_oracle(name, make, cfg):
    """The reference's acceptance differential on the port: the hierarchical
    order's RF within 1.10× of sequential ``geo_order``'s at every k."""
    worst = _worst_ratio(make(), cfg)
    assert worst <= 1.10, f"{name}: worst RF ratio {worst:.4f} > 1.10"


# -------------------------------------------- shard-streamed commit, one rank
def test_pack_slots_sharded_stream_at_one_rank_equals_jax_pack_slots():
    g = rmat_graph(8, 6, seed=0)
    k, spr = 4, -(-g.num_edges // 4)
    order = geo_order(g, seed=0)
    slots = [np.zeros(k * spr, dtype=np.int64), np.zeros(k * spr, dtype=np.int64), np.zeros(k * spr, dtype=bool)]
    slots[0][: g.num_edges], slots[1][: g.num_edges], slots[2][: g.num_edges] = g.src[order], g.dst[order], True
    want = J_E.pack_slots(*slots, k, g.num_vertices)
    got = E.pack_slots_sharded_stream(lambda p: [a[p * spr:(p + 1) * spr] for a in slots], k, g.num_vertices, None,
                                      spr, device="cpu")
    for name in ("edges", "mask", "degrees"):
        assert getattr(got, name).numpy().tobytes() == np.asarray(getattr(want, name)).tobytes(), name
    assert (got.num_edges, got.k) == (g.num_edges, k)
    assert sorted(E.local_slot_partitions(5)) == list(range(5))


# -------------------------------------------------------------- spill layer
def _store_state(store) -> dict:
    return dict(hot={p: [a.tolist() for a in blk] for p, blk in store._hot.items()}, cold=sorted(store._cold),
                counters=dict(store.counters), clock=store._clock, touch=dict(store._last_touch),
                resident=store.resident)


def _fill_and_fault(store, regions: int):
    """Write one slot of every region with a spill after each, then fault
    every region back; the values read back."""
    out = []
    for p in range(regions):
        src, dst, valid = store.get(p)
        src[1], dst[1], valid[1] = 7 * p + 1, 7 * p + 2, True
        store.evict_to_budget()
    for p in range(regions):
        src, dst, valid = store.get(p)
        out.append((int(src[1]), int(dst[1]), bool(valid[1])))
        store.evict_to_budget()
    return out


def test_spill_store_bounds_residency_faults_exact_and_equals_reference():
    stores = [m(regions=10, slots_per_region=8, config=c(max_resident=3))
              for m, c in ((SpillStore, SpillConfig), (J_spill.SpillStore, J_spill.SpillConfig))]
    reads = [_fill_and_fault(s, 10) for s in stores]
    assert reads[0] == reads[1] == [(7 * p + 1, 7 * p + 2, True) for p in range(10)]
    assert _store_state(stores[0]) == _store_state(stores[1])
    c = stores[0].counters
    assert stores[0].resident <= 3 and c["spills"] >= 7 and c["faults"] >= 7 and c["bytes_faulted"] > 0


def test_spill_store_lru_and_empty_blocks_equal_reference():
    for m, cfg in ((SpillStore, SpillConfig), (J_spill.SpillStore, J_spill.SpillConfig)):
        store = m(regions=4, slots_per_region=4, config=cfg(max_resident=2))
        for p in range(3):
            store.get(p)[2][0] = True
        store.touch(0)  # 0 is now the most recent; 1 the least recently touched
        store.evict_to_budget()
        assert set(store._hot) == {0, 2}
        empty = m(regions=6, slots_per_region=4, config=cfg(max_resident=1))
        for p in range(6):
            empty.get(p)  # created zeroed, never written: dropped, not serialized
        empty.evict_to_budget()
        assert empty.counters["spills"] == empty.counters["bytes_spilled"] == 0 and empty.resident == 1
    with pytest.raises(ValueError):
        SpillConfig(max_resident=0)
    with pytest.raises(IndexError):
        SpillStore(2, 2, SpillConfig()).get(2)


def test_spill_store_disk_mode_equals_reference(tmp_path):
    stores = [m(regions=3, slots_per_region=4, config=c(max_resident=1, directory=str(tmp_path / name)))
              for m, c, name in ((SpillStore, SpillConfig, "port"), (J_spill.SpillStore, J_spill.SpillConfig, "ref"))]
    for s in stores:
        for p in range(3):
            src, dst, valid = s.get(p)
            src[1], dst[1], valid[1] = 7 * p + 1, 7 * p + 2, True
            s.evict_to_budget()
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert len(list((tmp_path / "port").iterdir())) == 2  # two spilled region files
    reads = [[tuple(int(x[1]) for x in s.get(p)) for p in range(3)] for s in stores]
    assert reads[0] == reads[1] == [(7 * p + 1, 7 * p + 2, 1) for p in range(3)]
    for s in stores:
        s.evict_to_budget()
    assert _store_state(stores[0]) == _store_state(stores[1])
    assert len(list((tmp_path / "port").iterdir())) <= 2  # faulted files are consumed


def _stats(s) -> dict:
    return {k: x for k, x in dataclasses.asdict(s).items() if k != "elapsed_s"}


def test_outofcore_ingestor_equals_reference_and_a_set_oracle_under_spill():
    """A random insert/delete script through both ingestors: the same stats,
    store state and live set after every batch, equal to a Python set."""
    V, regions = 500, 16
    ing = OutOfCoreIngestor(V, regions, 256, config=SpillConfig(max_resident=4))
    jing = J_spill.OutOfCoreIngestor(V, regions, 256, config=J_spill.SpillConfig(max_resident=4))
    oracle: set = set()
    rng = np.random.default_rng(7)
    for _ in range(12):
        ins = rng.integers(0, V, size=(60, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        live = np.asarray(sorted(oracle), dtype=np.int64).reshape(-1, 2)
        dele = live[rng.permutation(live.shape[0])[: live.shape[0] // 4]]
        st_ = ing.ingest(EdgeUpdateBatch(insert=ins, delete=dele))
        assert _stats(st_) == _stats(jing.ingest(J_upd.EdgeUpdateBatch(insert=ins, delete=dele)))
        oracle -= {(min(u, v), max(u, v)) for u, v in dele.tolist()}
        oracle |= {(min(u, v), max(u, v)) for u, v in ins.tolist()}
        assert _store_state(ing.store) == _store_state(jing.store) and ing.store.resident <= 4
        assert ing.spill_counters == jing.spill_counters
    src, dst = ing.snapshot()
    jsrc, jdst = jing.snapshot()
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    assert set(zip(src.tolist(), dst.tolist())) == oracle and ing.num_edges == len(oracle)
    assert ing.store.counters["spills"] > 0 and ing.store.counters["faults"] > 0
    assert (ing.k, ing.monitor()) == (regions, "none")


def test_outofcore_ingestor_duplicate_absent_and_full_region_are_skips():
    ing = OutOfCoreIngestor(100, regions=1, slots_per_region=2)
    none = np.empty((0, 2), np.int64)
    assert ing.ingest(EdgeUpdateBatch(insert=np.asarray([[2, 1]]), delete=none)).inserted == 1
    s1 = ing.ingest(EdgeUpdateBatch(insert=np.asarray([[1, 2]]), delete=none))
    assert (s1.inserted, s1.skipped) == (0, 1)  # the same canonical edge again
    s2 = ing.ingest(EdgeUpdateBatch(insert=none, delete=np.asarray([[5, 6]])))
    assert (s2.deleted, s2.skipped) == (0, 1)  # an absent delete is idempotent
    s3 = ing.ingest(EdgeUpdateBatch(insert=np.asarray([[3, 4], [5, 6]]), delete=none))
    assert (s3.inserted, s3.skipped, ing.num_edges) == (1, 1, 2)  # the region is full after one more


# ------------------------------------------------------------ data pipeline
def test_data_pipeline_batches_equal_reference():
    dc, jdc = dp.DataConfig(vocab_size=1000, seq_len=16, global_batch=64), J_dp.DataConfig(1000, 16, 64)
    gb = dp.global_batch(dc, step=7)
    assert gb["tokens"].shape == (64, 16) and gb["tokens"].dtype == np.int32
    for name in ("tokens", "targets"):
        np.testing.assert_array_equal(gb[name], J_dp.global_batch(jdc, 7)[name])
    for k in (4, 5):
        rows = [dp.host_batch(dc, 7, k, h) for h in range(k)]
        np.testing.assert_array_equal(np.concatenate([r["tokens"] for r in rows]), gb["tokens"])
        for h, r in enumerate(rows):
            for name, x in J_dp.host_batch(jdc, 7, k, h).items():
                np.testing.assert_array_equal(r[name], x)
    plan, jplan = dp.rescale_moves(dc, 4, 5), J_dp.rescale_moves(jdc, 4, 5)
    assert (plan.moves, plan.stay, plan.migrated_edges) == (jplan.moves, jplan.stay, jplan.migrated_edges)
    assert plan.migrated_edges <= 64 * 0.6


def test_controller_ingest_event_carries_spill_counters():
    """An ``OutOfCoreIngestor`` behind the port's elastic controller: every
    IngestEvent's ``spill`` dict carries the store counters and the resident
    size, and the log equals the reference controller's over the reference
    ingestor on the same batches (timings dropped)."""
    from repro.elastic import controller as J_ec
    from repro_torch.elastic import controller as ec

    ctls = []
    for C, I, Cfg, Batch in ((ec, OutOfCoreIngestor, SpillConfig, EdgeUpdateBatch),
                             (J_ec, J_spill.OutOfCoreIngestor, J_spill.SpillConfig, J_upd.EdgeUpdateBatch)):
        ing = I(1000, regions=12, slots_per_region=16, config=Cfg(max_resident=2))
        ctl = C.ElasticController(4)
        ctl.attach_stream(ing)
        rng = np.random.default_rng(3)
        for b in range(4):
            ins = rng.integers(0, 1000, size=(40, 2))
            ev = ctl.ingest(Batch(insert=ins[ins[:, 0] != ins[:, 1]], delete=np.empty((0, 2), np.int64)))
        assert ev.kind == "ingest" and ev.escalation == "none"
        assert set(ev.spill) == {"spills", "faults", "bytes_spilled", "bytes_faulted", "resident"}
        assert ev.spill["resident"] <= 2 and ev.spill["spills"] > 0
        assert [e.seq for e in ctl.events] == list(range(len(ctl.events)))
        ctls.append(ctl)
    assert ctls[0].events_jsonl(drop_timings=True) == ctls[1].events_jsonl(drop_timings=True)


@pytest.mark.parametrize("cfg", [
    HO.HierConfig(num_chunks=4, max_chunk_edges=1 << 10, seam_window=0, seed=0, chunk_mode="mirror"),
    HO.HierConfig(num_chunks=3, max_chunk_edges=1 << 11, seam_window=64, seed=2, chunk_mode="mirror"),
    HO.HierConfig(num_chunks=4, max_chunk_edges=1 << 10, seam_window=0, seed=1, chunk_mode="host"),
], ids=["mirror", "mirror-seams", "host"])
def test_pooled_mirror_order_equals_the_serial_composition(cfg):
    """``pooled_mirror_order`` (chunks in a spawned process pool, as
    ``chip_smoke.py``'s path 7 computes its oracle) is byte-equal to the
    serial ``hier_order_edges`` on the same edges and sample."""
    import concurrent.futures
    import multiprocessing

    plan = DS.RmatShardPlan(scale=11, edge_factor=8, seed=0, num_shards=4)
    edges = np.concatenate([DS.shard_edges(plan, s) for s in range(plan.num_shards)])
    sample = DS.sample_edges(plan, 2)
    want, winfo = HO.hier_order_edges(edges, plan.num_vertices, cfg, sample=sample)
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        got, info = OH.pooled_mirror_order(edges, plan.num_vertices, cfg, sample, pool)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert info["chunk_sizes"] == winfo["chunk_sizes"] and np.array_equal(info["splits"], winfo["splits"])
    assert info["num_chunks"] == winfo["num_chunks"] > 1


def test_pooled_mirror_order_refuses_the_device_chunk_mode():
    with pytest.raises(ValueError, match="device"):
        OH.pooled_mirror_order(np.zeros((4, 2), np.int64), 8, HO.HierConfig(chunk_mode="device"),
                               np.zeros((4, 2), np.int64), None)


# =================================================== 2 × 2 gloo cluster
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_outofcore")
    res = MH.spawn_local_cluster(
        N_PROCS, DEVS_PER_PROC, [str(ROOT / "tests" / "torch_outofcore_harness.py"), str(out)],
        backend="gloo", devices=["cpu"] * G, timeout=CLUSTER_TIMEOUT_S,
        env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert res.ok, res.format_logs()
    return [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text())) for r in range(G)]


@pytest.fixture(scope="module")
def oracle():
    """The JAX package's in-core composition: the same plan and configuration
    in one process, the whole edge list in memory."""
    kw = dict(scale=OH.PLAN.scale, edge_factor=OH.PLAN.edge_factor, seed=OH.PLAN.seed,
              num_shards=OH.PLAN.num_shards)
    jplan = J_DS.RmatShardPlan(**kw)
    edges = np.concatenate([J_DS.shard_edges(jplan, s) for s in range(jplan.num_shards)])
    sample = J_DS.sample_edges(jplan, OH.SAMPLE_STRIDE)
    ordered, info = J_HO.hier_order_edges(edges, jplan.num_vertices, _jcfg(OH.CFG), sample=sample)
    total = int(ordered.shape[0])
    bounds = cep.chunk_bounds(total, OH.K_PACK)
    spr = int(np.diff(bounds).max())
    slots = [np.zeros(OH.K_PACK * spr, dtype=np.int64), np.zeros(OH.K_PACK * spr, dtype=np.int64),
             np.zeros(OH.K_PACK * spr, dtype=bool)]
    for p in range(OH.K_PACK):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        at = slice(p * spr, p * spr + hi - lo)
        slots[0][at], slots[1][at], slots[2][at] = ordered[lo:hi, 0], ordered[lo:hi, 1], True
    pack = J_E.pack_slots(*slots, OH.K_PACK, jplan.num_vertices)
    return types.SimpleNamespace(edges=edges, ordered=ordered, info=info, pack=pack, v=jplan.num_vertices)


def _reassembled(cluster, name: str, k: int):
    """Partition-major rows of the ranks' blocks, and the padding rows apart."""
    edges = np.concatenate([a[f"{name}_edges"] for a, _ in cluster])
    mask = np.concatenate([a[f"{name}_mask"] for a, _ in cluster])
    rows = [SH.partition_row(p, k, G) for p in range(k)]
    pad = np.setdiff1d(np.arange(edges.shape[0]), rows)
    return edges[rows], mask[rows], edges[pad], mask[pad]


def test_workers_ran_as_a_gloo_group_without_jax(cluster):
    for r, (_, meta) in enumerate(cluster):
        assert meta["rank"] == r and meta["group"] == [G, "gloo", [0, 0, 1, 1]]
        assert meta["jax_loaded"] is False and meta["peak_rss"][1] > 0


def test_ranks_agree_on_the_plan_and_equal_the_oracle_splits(cluster, oracle):
    """Phase A takes no coordination beyond one sum: every rank derived the
    identical splits and chunk sizes from its own shards' histogram."""
    first = cluster[0][1]
    for _, meta in cluster:
        assert (meta["splits"], meta["chunk_sizes"], meta["num_edges"]) == (
            first["splits"], first["chunk_sizes"], first["num_edges"])
    assert first["splits"] == oracle.info["splits"].tolist() and first["chunk_sizes"] == oracle.info["chunk_sizes"]
    assert first["num_edges"] == oracle.ordered.shape[0]


def test_each_rank_orders_only_the_chunks_its_partitions_touch(cluster):
    bounds = np.concatenate([[0], np.cumsum(cluster[0][1]["chunk_sizes"])])
    cep_b = cep.chunk_bounds(int(bounds[-1]), OH.K_PACK)
    for _, meta in cluster:
        want = sorted({c for p in meta["parts"] if p < OH.K_PACK
                       for c in range(int(np.searchsorted(bounds, cep_b[p], side="right") - 1),
                                      int(np.searchsorted(bounds, cep_b[p + 1], side="left")))})
        assert meta["ordered_chunks"] == want  # one chunk cached, so each is ordered once, in order


def test_commit_is_byte_identical_to_jax_incore_oracle(cluster, oracle):
    """The shard-streamed commit, in which no rank held the full edge list,
    equals the JAX package's in-core ``pack_slots`` byte for byte."""
    edges, mask, pad_e, pad_m = _reassembled(cluster, "commit", OH.K_PACK)
    assert edges.tobytes() == np.asarray(oracle.pack.edges).tobytes()
    assert mask.tobytes() == np.asarray(oracle.pack.mask).tobytes()
    assert not pad_e.any() and not pad_m.any()
    for arrays, _ in cluster:
        assert arrays["commit_degrees"].tobytes() == np.asarray(oracle.pack.degrees).tobytes()


def test_rescale_roundtrip_returns_to_the_commit(cluster, oracle):
    """8 → 12 → 8 across the ranks lands on the committed pack: the same
    live prefix in every partition."""
    want_e, want_m = np.asarray(oracle.pack.edges), np.asarray(oracle.pack.mask)
    back_e, back_m, pad_e, _ = _reassembled(cluster, "rescale_back", OH.K_PACK)
    for p in range(OH.K_PACK):
        n = int((want_m[p] > 0).sum())
        assert int((back_m[p] > 0).sum()) == n and (back_m[p][:n] > 0).all()
        np.testing.assert_array_equal(back_e[p][:n], want_e[p][want_m[p] > 0])
    assert not pad_e.any()


def test_rescale_up_keeps_the_ordered_sequence(cluster, oracle):
    """At k = 12 the partition prefixes concatenate to the oracle's ordered
    sequence, each partition holding its CEP chunk."""
    k_pad = SH.padded_partition_count(OH.K_UP, G)
    assert all(meta["k_pad_up"] == k_pad for _, meta in cluster)
    up_e, up_m, pad_e, pad_m = _reassembled(cluster, "rescale_up", OH.K_UP)
    sizes = np.diff(cep.chunk_bounds(oracle.ordered.shape[0], OH.K_UP))
    assert [int((m > 0).sum()) for m in up_m] == sizes.tolist()
    flat = np.concatenate([e[m > 0] for e, m in zip(up_e, up_m)])
    np.testing.assert_array_equal(flat, oracle.ordered.astype(np.int32))
    assert not pad_e.any() and not pad_m.any()


def test_rechecked_rescales_measure_the_oracle_rf_through_segment_rf(cluster, oracle):
    """Each re-checked rescale's RF equals ``replication_factor_ordered`` of
    the oracle's order at its k, on every rank, counted through the
    ``segment_rf`` entry point (its plain version on the CPU)."""
    o = oracle.ordered
    want = [replication_factor_ordered(o[:, 0], o[:, 1], k, oracle.v) for k in (OH.K_UP, OH.K_PACK)]
    for _, meta in cluster:
        assert [r["k_new"] for r in meta["rescale"]] == [OH.K_UP, OH.K_PACK]
        assert [r["rf"] for r in meta["rescale"]] == want
        assert meta["segment_rf_launches"] == 0  # no kernel on the CPU


def test_hier_order_quality_within_margin_of_geo_oracle(oracle):
    """The reference's RF gate on the order the ranks committed (byte-equal to
    this oracle): within 1.10× of sequential ``geo_order`` at every k."""
    V, edges = oracle.v, oracle.edges
    key = edges[:, 0] * np.int64(V) + edges[:, 1]
    _, first = np.unique(key, return_index=True)
    g = J_Graph.from_edges(edges[np.sort(first)], V)
    o = J_geo_order(g, seed=0)
    worst = max(replication_factor_ordered(oracle.ordered[:, 0], oracle.ordered[:, 1], k, V)
                / replication_factor_ordered(g.src[o], g.dst[o], k, V) for k in (4, 8, 16, 32, 64, 128))
    assert worst <= 1.10, f"worst RF ratio {worst:.4f} > 1.10"


def test_stream_phase_deterministic_and_spill_bounded(cluster):
    """The spill-bounded ingest tail: every rank's stateless replay lands the
    same state, residency stayed within budget, and spills happened."""
    streams = [meta["stream"] for _, meta in cluster]
    assert all(s == streams[0] for s in streams)
    s = streams[0]
    assert s["num_edges"] == s["inserted"] > 0 and s["batches"] == OH.STREAM_BATCHES
    assert s["peak_resident"] <= OH.SPILL_RESIDENT and s["resident"] <= OH.SPILL_RESIDENT
    assert s["spill"]["spills"] > 0 and set(s["spill"]) == {"spills", "faults", "bytes_spilled", "bytes_faulted",
                                                             "resident"}
    assert s["seqs"] == list(range(OH.STREAM_BATCHES))  # one IngestEvent a batch, through the controller
    ing = OutOfCoreIngestor(OH.PLAN.num_vertices, OH.SPILL_REGIONS, OH.SPILL_SPR,
                            config=SpillConfig(max_resident=OH.SPILL_RESIDENT))
    for b in range(OH.STREAM_BATCHES):  # the same script in this process
        ing.ingest(EdgeUpdateBatch(insert=DS.stream_edges(OH.PLAN, b, OH.STREAM_BATCH_SIZE),
                                   delete=np.empty((0, 2), np.int64)))
    assert ing.num_edges == s["num_edges"] and ing.spill_counters == s["spill"]
