"""The port's streaming engine over several torch.distributed ranks, on the CPU.

One module-scoped cluster of 2 processes × 2 ranks over gloo, started through
the port's ``launch_local_cluster``, runs this file as its worker
(``python tests/test_torch_stream_multirank.py worker <dir>``). The worker
imports no JAX. Each rank runs one ``StreamingEngine`` over the group through
the scripts below, every event checked with ``verify=True``, and writes its
row blocks and readings:

* A: rescale under ingest with a span repair at every monitor (the drift
  baseline pinned as in ``tests/multihost_harness.py``), 8 → 12 → 7;
* B: one async ``geo`` rebuild, dispatched on batch 2 and committed a batch
  later;
* C: ``differential`` span and full rungs, one rebuild committed and one
  aborted by a rescale 8 → 10, with every distinct count through
  ``segment_distinct_counts`` counted;
* D: after A, ``StreamingEngine.from_restored`` on an orderer that replayed
  A, then one more batch.

The parent replays each script on the host with the JAX package's orderer and
numpy mirrors (``tests/torch_stream_replay.py``) and holds every rank's
blocks, reassembled, byte-equal to the JAX package's ``pack_slots`` of the
replay, the ladder and rebuild logs equal, the rescale counts equal to the
replay's gather map, and PageRank within rtol 1e-5 of the JAX replicated
engine. Every group and every wait has a timeout.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses
import json
import os
import pathlib
import sys
import types

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.graph import rmat_graph  # noqa: E402
from repro_torch.elastic.rescale_exec import EDGE_BYTES  # noqa: E402
from repro_torch.graphs import engine as E  # noqa: E402
from repro_torch.kernels import full_reorder as FRK  # noqa: E402
from repro_torch.kernels import segment_rf  # noqa: E402
from repro_torch.kernels import span_reorder as SRK  # noqa: E402
from repro_torch.launch import multihost as MH  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.obs import metrics as OM  # noqa: E402
from repro_torch.stream import StreamingEngine, SyntheticStream  # noqa: E402
from repro_torch.stream import incremental as inc  # noqa: E402
from torch_stream_replay import HostReplay, timeless  # noqa: E402

N_PROCS, DEVS_PER_PROC = 2, 2
G = N_PROCS * DEVS_PER_PROC
GROUP_TIMEOUT_S = 45.0  # every collective of the worker's group
CLUSTER_TIMEOUT_S = 180.0  # the whole cluster, start-up included
GRAPH = dict(scale=8, edge_factor=6, seed=0)  # as tests/multihost_harness.py
BATCH = 64
FORCED_DRIFT = 200.0  # over every full_drift below: the full rung fires
# Steps: "batch" is an ingest and a monitor, "force" the same with the full
# rung forced at the monitor, an int a rescale to that many regions.
SCRIPTS = {
    "A": dict(config=dict(full_drift=99.0, span_regions=2), pin=True, span_repair="device", full_rebuild="host",
              flight=0, seed=1, steps=["batch", "batch", 12, "batch", 7, "batch", "batch"]),
    "B": dict(config=dict(partial_drift=40.0, full_drift=50.0), pin=False, span_repair="device", full_rebuild="geo",
              flight=1, seed=2, steps=["batch", "batch", "force", "batch", "batch"]),
    "C": dict(config=dict(partial_drift=1.0, full_drift=99.0, span_regions=2), pin=False,
              span_repair="differential", full_rebuild="differential", flight=1, seed=3,
              steps=["batch", "force", "batch", "force", 10, "batch", "batch"]),
}
REGIONS = 8
RESCALED = {"A": [(8, 12), (12, 7)], "C": [(8, 10)]}


def pin_partial_baseline(orderer) -> None:
    """Drift ≈ 1.5 (over partial_drift, under full_drift): every monitor
    fires the partial rung (``tests/multihost_harness.py``)."""
    orderer._baseline_kappa = orderer._kappa() / 1.5


def new_replay(modules, name: str, src, dst, nv) -> HostReplay:
    sc = SCRIPTS[name]
    rep = HostReplay(modules, src, dst, nv, REGIONS, sc["config"], sc["span_repair"], sc["full_rebuild"],
                     sc["flight"])
    if sc["pin"]:
        pin_partial_baseline(rep.o)
    return rep


def replay_script(rep: HostReplay, name: str, stream) -> dict:
    """Drive a host replay through script ``name``: its rungs and the
    (gather map, old slots per region) of each rescale, and the slots per
    region at each monitor."""
    rungs, maps, sprs = [], [], []
    for step in SCRIPTS[name]["steps"]:
        if isinstance(step, int):
            maps.append(rep.rescale(step))
            continue
        rep.ingest(stream.batch())
        if step == "force":
            rep.o.drift = lambda: FORCED_DRIFT
        sprs.append(rep.o.slots_per_region)
        rungs.append(rep.monitor())
        if step == "force":
            del rep.o.drift
    return dict(rungs=rungs, maps=maps, sprs=sprs)


# ------------------------------------------------------------------ worker
def worker(out_dir: pathlib.Path) -> None:
    """One rank's engines through scripts A–D on the device and backend the
    launcher gave the rank (the card tests in ``tests/test_torch_cuda.py``
    run it on the H100); writes ``rank{r}.npz`` and ``rank{r}.json``."""
    import torch.distributed as dist

    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    r = group.rank
    inp = np.load(out_dir / "inputs.npz")
    src, dst = inp["src"].astype(np.int64), inp["dst"].astype(np.int64)
    graph = rmat_graph(**GRAPH)
    nv = graph.num_vertices
    arrays, meta = {}, {"rank": r, "group": [group.size, group.rank, group.backend, list(group.processes)],
                        "device": str(group.torch_device)}
    # Every distinct count of the rungs' objectives goes through
    # span_reorder.segment_distinct_counts: count the calls.
    kernel, calls = SRK.segment_distinct_counts, [0]

    def tap(rows):
        calls[0] += 1
        return kernel(rows)

    SRK.segment_distinct_counts = tap

    def keep(name, eng):
        d = eng.data
        arrays[f"{name}_edges"], arrays[f"{name}_mask"] = d.edges.cpu().numpy(), d.mask.cpu().numpy()
        arrays[f"{name}_degrees"] = d.degrees.cpu().numpy()
        meta[name] = dict(k=d.k, parts=d.local_partitions(), num_edges=d.num_edges)

    engines = {}
    for name, sc in SCRIPTS.items():
        calls[0], launches0 = 0, segment_rf.launches
        o = inc.IncrementalOrderer(src, dst, nv, regions=REGIONS, config=inc.StreamConfig(**sc["config"]))
        if sc["pin"]:
            pin_partial_baseline(o)
        reg = OM.MetricsRegistry()
        eng = StreamingEngine(o, group=group, span_repair=sc["span_repair"], full_rebuild=sc["full_rebuild"],
                              rebuild_flight=sc["flight"], metrics_registry=reg)
        stream = SyntheticStream(graph, batch_size=BATCH, seed=sc["seed"])
        eng.verify_bit_identity()
        rungs, states, repairs, rescales, span_selections = [], [], [], [], 0
        for step in sc["steps"]:
            if isinstance(step, int):
                rescales.append(dataclasses.asdict(eng.rescale(step, verify=True)))
                continue
            eng.ingest(stream.batch(), verify=True)
            if step == "force":
                o.drift = lambda: FORCED_DRIFT
            rungs.append(eng.monitor())
            if step == "force":
                del o.drift
            eng.verify_bit_identity()
            states.append(eng.rebuild_state)
            repairs.append(eng.last_repair)
            span_selections += rungs[-1] == "partial" and eng.last_repair == "differential"
        log = eng.drain_rebuild_events()
        keep(name, eng)
        meta[name].update(rungs=rungs, states=states, repairs=repairs, rescales=rescales, log=timeless(log),
                          rung_counts=eng.rung_counts, span_selections=int(span_selections),
                          full_selections=sum(rec["mode"] == "differential" for rec in log),
                          objective_calls=calls[0], segment_rf_launches=segment_rf.launches - launches0,
                          bytes={k: reg.counter(f"stream.{k}_bytes").value for k in (
                              "scatter.upload", "span.gather", "rebuild.gather", "rescale.sent",
                              "rescale.received")})
        engines[name] = (eng, stream)

    # D: an orderer that replayed A on the host (the port's copies of the
    # numpy mirrors), committed shard by shard, then one more batch.
    eng_a, stream_a = engines["A"]
    rep = new_replay((inc, SRK, FRK), "A", src, dst, nv)
    replay_script(rep, "A", SyntheticStream(graph, batch_size=BATCH, seed=SCRIPTS["A"]["seed"]))
    restored = StreamingEngine.from_restored(rep.o, group=group, span_repair="device")
    meta["D_equal_to_A"] = {n: bool(torch.equal(getattr(restored.data, n), getattr(eng_a.data, n)))
                            for n in ("edges", "mask", "degrees")}
    restored.ingest(stream_a.batch(), verify=True)
    keep("D", restored)
    arrays["pagerank"] = E.pagerank(restored.data, iterations=20).cpu().numpy()

    SRK.segment_distinct_counts = kernel
    meta["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules)
    dist.destroy_process_group()
    np.savez(out_dir / f"rank{r}.npz", **arrays)
    (out_dir / f"rank{r}.json").write_text(json.dumps(meta))


# ------------------------------------------------------------------ parent
def _reference():
    """The JAX package's modules, imported in the parent only."""
    from repro.core import ordering as J_ordering
    from repro.core.graph import rmat_graph as J_rmat
    from repro.graphs import engine as J_E
    from repro.kernels import full_reorder as J_FRK
    from repro.kernels import span_reorder as J_SRK
    from repro.launch import mesh as J_MM
    from repro.stream import incremental as J_inc
    from repro.stream import updates as J_upd

    return types.SimpleNamespace(ordering=J_ordering, rmat=J_rmat, E=J_E, FRK=J_FRK, SRK=J_SRK, MM=J_MM,
                                 inc=J_inc, upd=J_upd)


@pytest.fixture(scope="module")
def J():
    return _reference()


@pytest.fixture(scope="module")
def cluster(J, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_stream_multirank")
    jg = J.rmat(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"])
    order = J.ordering.geo_order(jg, seed=0)
    src, dst = jg.src[order].astype(np.int64), jg.dst[order].astype(np.int64)
    np.savez(out / "inputs.npz", src=src, dst=dst)
    res = MH.spawn_local_cluster(
        N_PROCS, DEVS_PER_PROC, [str(pathlib.Path(__file__).resolve()), "worker", str(out)],
        backend="gloo", devices=["cpu"] * G, timeout=CLUSTER_TIMEOUT_S,
        env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert res.ok, res.format_logs()
    ranks = [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text()))
             for r in range(G)]
    return types.SimpleNamespace(jg=jg, src=src, dst=dst, ranks=ranks, result=res)


@pytest.fixture(scope="module")
def replays(J, cluster):
    """Each script replayed on the host with the JAX package's orderer and
    mirrors; D is A's replay with one more batch."""
    modules = (J.inc, J.SRK, J.FRK)
    out = {}
    for name, sc in SCRIPTS.items():
        rep = new_replay(modules, name, cluster.src, cluster.dst, cluster.jg.num_vertices)
        stream = J.upd.SyntheticStream(cluster.jg, batch_size=BATCH, seed=sc["seed"])
        out[name] = (rep, replay_script(rep, name, stream))
        if name == "A":
            rep_d = new_replay(modules, name, cluster.src, cluster.dst, cluster.jg.num_vertices)
            stream_d = J.upd.SyntheticStream(cluster.jg, batch_size=BATCH, seed=sc["seed"])
            replay_script(rep_d, name, stream_d)
            rep_d.ingest(stream_d.batch())
            out["D"] = (rep_d, None)
    return out


def _reassembled(cluster, name: str, k: int):
    """The partition-major pack from every rank's block, and the padding rows."""
    edges = np.concatenate([a[f"{name}_edges"] for a, _ in cluster.ranks])
    mask = np.concatenate([a[f"{name}_mask"] for a, _ in cluster.ranks])
    rows = [SH.partition_row(p, k, G) for p in range(k)]
    pad = np.setdiff1d(np.arange(edges.shape[0]), rows)
    return edges[rows], mask[rows], edges[pad], mask[pad]


def test_workers_ran_as_a_gloo_group_without_jax(cluster):
    for r, (_, meta) in enumerate(cluster.ranks):
        assert meta["group"] == [G, r, "gloo", [0, 0, 1, 1]] and meta["device"] == "cpu"
        assert meta["jax_loaded"] is False
    assert [(p.process_id, p.rank) for p in cluster.result.procs] == [(r // 2, r) for r in range(G)]


@pytest.mark.parametrize("name", ["A", "B", "C", "D"])
def test_blocks_byte_equal_to_jax_pack_slots_of_the_replay(cluster, J, replays, name):
    o = replays[name][0].o
    want = J.E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, cluster.jg.num_vertices)
    edges, mask, pad_e, pad_m = _reassembled(cluster, name, o.regions)
    assert edges.dtype == np.int32 and mask.dtype == np.float32
    assert edges.tobytes() == np.asarray(want.edges).tobytes()
    assert mask.tobytes() == np.asarray(want.mask).tobytes()
    assert not pad_e.any() and not pad_m.any()
    for d, (arrays, meta) in enumerate(cluster.ranks):
        assert arrays[f"{name}_degrees"].tobytes() == np.asarray(want.degrees).tobytes()
        assert meta[name]["k"] == o.regions and meta[name]["num_edges"] == want.num_edges
        assert all(p % G == d for p in meta[name]["parts"] if p < o.regions)


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_ladder_and_rebuild_log_equal_on_every_rank_and_to_the_replay(cluster, replays, name):
    rep, read = replays[name]
    for _, meta in cluster.ranks:
        assert meta[name]["rungs"] == read["rungs"]
        assert meta[name]["log"] == rep.log
        assert meta[name]["rung_counts"] == rep.rung_counts
        assert meta[name]["repairs"] == cluster.ranks[0][1][name]["repairs"]
    if name == "A":  # the pinned baseline: a device span repair at every monitor
        assert read["rungs"] == ["partial"] * len(read["rungs"])
        assert set(cluster.ranks[0][1]["A"]["repairs"]) == {"device"}


@pytest.mark.parametrize("name", ["A", "C"])
def test_rescale_counts_equal_the_replay_gather_map(cluster, replays, name):
    procs = np.asarray([r // DEVS_PER_PROC for r in range(G)])
    for i, ((gm, spr_old), (k_old, k_new)) in enumerate(zip(replays[name][1]["maps"], RESCALED[name])):
        spr_new = gm.shape[0] // k_new
        new_slots = np.flatnonzero(gm >= 0)
        new_r, old_r = new_slots // spr_new, gm[new_slots] // spr_old
        moved = new_r != old_r
        cross = int(np.count_nonzero(moved & (new_r % G != old_r % G)))
        xproc = int(np.count_nonzero(moved & (procs[new_r % G] != procs[old_r % G])))
        for _, meta in cluster.ranks:
            st = meta[name]["rescales"][i]
            assert (st["k_old"], st["k_new"]) == (k_old, k_new)
            assert (st["moved_edges"], st["cross_device_edges"], st["cross_process_edges"]) == (
                int(np.count_nonzero(moved)), cross, xproc)
            assert (st["cross_device_bytes"], st["cross_process_bytes"]) == (cross * EDGE_BYTES, xproc * EDGE_BYTES)
        assert cross > 0 and xproc > 0
    # Each rank counts the bytes it sent and received: over the ranks, both
    # sum to the cross-rank bytes of the script's rescales.
    cross_bytes = sum(st["cross_device_bytes"] for st in cluster.ranks[0][1][name]["rescales"])
    for side in ("sent", "received"):
        assert sum(meta[name]["bytes"][f"rescale.{side}"] for _, meta in cluster.ranks) == cross_bytes
    assert all(meta[name]["bytes"]["rescale.sent"] > 0 for _, meta in cluster.ranks)


def test_rebuild_dispatched_then_committed_over_the_ranks(cluster):
    for _, meta in cluster.ranks:
        assert meta["B"]["states"] == ["", "", "dispatch", "commit", ""]
        (rec,) = meta["B"]["log"]
        assert rec["committed"] and rec["mode"] == "geo" and rec["flight_batches"] == rec["replayed_batches"] == 1
        assert rec["splice_ops"] > 0  # the batch ingested in flight landed in the committed pack
        assert meta["B"]["bytes"]["rebuild.gather"] > 0


def test_rungs_count_distinct_ids_twice_a_selection_on_every_rank(cluster):
    """Script C: every rank runs both objectives of each span and full
    selection through ``segment_distinct_counts`` (the plain version here,
    the CUDA kernel on a card); A and B select nothing."""
    for _, meta in cluster.ranks:
        c = meta["C"]
        selections = c["span_selections"] + c["full_selections"]
        assert c["span_selections"] > 0 and c["full_selections"] == 2
        assert c["objective_calls"] == 2 * selections
        assert c["segment_rf_launches"] == 0  # CPU tensors take the plain version
        assert [(r["committed"], r["aborted"]) for r in c["log"]] == [(True, False), (False, True)]
        assert c["log"][1]["abort_reason"] == "rescale"
        assert meta["A"]["objective_calls"] == meta["B"]["objective_calls"] == 0


def test_span_gather_brings_every_rank_one_block_from_each_rank(cluster, replays):
    """Each span repair of two regions gathers a block of ⌈2/g⌉ = 1 row
    (edges and mask: 12 bytes a slot) from every rank, also from the ranks
    that hold none of the span: g·(spr + 1)·12 bytes a rank a repair."""
    want = sum(G * (spr + 1) * 12 for spr in replays["A"][1]["sprs"])
    for _, meta in cluster.ranks:
        assert meta["A"]["bytes"]["span.gather"] == want


def test_restored_engine_equals_the_live_engine_rank_by_rank(cluster):
    for _, meta in cluster.ranks:
        assert meta["D_equal_to_A"] == {"edges": True, "mask": True, "degrees": True}


def test_pagerank_on_the_final_pack_matches_jax_replicated_engine(cluster, J, replays):
    src, dst = replays["D"][0].o.snapshot()
    jdata = J.E.pack_ordered(src, dst, cluster.jg.num_vertices, replays["D"][0].o.regions)
    want = np.asarray(J.E.pagerank(jdata, J.MM.make_test_mesh(data=1, model=1), iterations=20))
    for arrays, _ in cluster.ranks:
        np.testing.assert_allclose(arrays["pagerank"], want, rtol=1e-5, atol=1e-7)
    assert all(np.array_equal(a["pagerank"], cluster.ranks[0][0]["pagerank"]) for a, _ in cluster.ranks)


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit(f"usage: {sys.argv[0]} worker <dir>")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    worker(pathlib.Path(sys.argv[2]))
