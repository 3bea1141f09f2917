"""The port's failure drill: one rank's worker, and the parent that drives it.

The counterpart of the JAX package's ``tests/faults_harness.py``, over the
port's ``launch_local_cluster`` (one OS process a rank). It imports no JAX.

* ``--mode live`` — a cluster of 2 processes × 2 ranks streams update
  batches through ``ElasticController.ingest`` on a ``StreamingEngine`` over
  the group, and checks the pack bit-identical after every batch (a
  collective: a rank whose peer died is stranded there, as a real one would
  be). The first rank of each process stamps its process's ``LeaseBoard``
  lease after each batch; rank 0 also runs a ``SlotCheckpoint``, so every
  batch is durable (a WAL record or an interval snapshot). The parent
  SIGKILLs process 1's ranks mid-stream, waits for the lease board to call
  process 1 dead, and then abandons the stranded survivors. The checkpoint
  directory and the frozen leases are all that survive.
* ``--mode recover`` — a fresh group of 2 ranks (one process) restores the
  orderer from the checkpoint on every rank (snapshot chunks + the WAL tail),
  commits it through ``StreamingEngine.from_restored``, reports the failure
  through ``ElasticController.report_failure`` (a ``FailureEvent``, then the
  re-plan 8 → 4 executed as a rescale across the ranks) and continues the
  stream by batch index (``SyntheticStream.batch(b)`` is a pure function of
  its seed and b). Each rank writes the restore-point and final slot arrays,
  its final row blocks and its event log.

``--device`` names the device type the ranks must be on (``cpu`` in the
tests, ``cuda`` in ``chip_smoke.py``): a rank on another device stops.
Escalation is parked (``drill_config``), so the slot state is a pure function
of the applied batches and the re-plan, and the oracle is a plain ``apply``
loop with the same re-plan (``drill_oracle``).

``run_drill`` is the parent: live cluster, kill, lease-expiry detection,
recovery cluster; ``reassemble`` puts the ranks' final row blocks back in
partition order.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import ordering  # noqa: E402
from repro_torch.core.graph import rmat_graph  # noqa: E402
from repro_torch.stream.incremental import IncrementalOrderer, StreamConfig  # noqa: E402
from repro_torch.stream.updates import SyntheticStream  # noqa: E402

# The JAX package's drill (tests/faults_harness.py), but for the stream's
# length, the kill and the snapshot interval: every batch here ends in a
# collective, so the survivors stop one batch after the kill, and a snapshot
# every 4 batches leaves a WAL tail to replay after a kill at batch 5.
GRAPH_SCALE = 7
GRAPH_EDGE_FACTOR = 6
GRAPH_SEED = 0
STREAM_SEED = 3
STREAM_BATCH = 64
REGIONS = 8
K_RECOVER = 4
BATCHES, KILL_STEP = 12, 5
CKPT_INTERVAL = 4
LEASE_S = 2.0
# Per-batch throttle in live mode: the parent must win the race between
# "victim reaches the kill step" and "stream runs out of batches".
THROTTLE_S = 0.25
LIVE_PROCS, LIVE_DEVS = 2, 2  # 4 ranks; process 1 (ranks 2 and 3) is the victim
RECOVER_PROCS, RECOVER_DEVS = 1, 2
GROUP_TIMEOUT_S = 60.0
CLUSTER_TIMEOUT_S = 300.0


def drill_config() -> StreamConfig:
    """Escalation parked out of the way: the drill's slot state must be a
    pure function of the applied batches + rescales so the parent's host
    oracle replay is a plain ``apply`` loop."""
    return StreamConfig(partial_drift=99.0, full_drift=999.0)


def log(rank: int, msg: str) -> None:
    """A line of the rank's log, stamped with ``time.monotonic()`` (one clock
    for every process of the host), so the parent can place it on its own
    timeline."""
    print(f"[rank {rank} t={time.monotonic():.3f}] {msg}", flush=True)


def build_ordered(graph: str | None = None):
    """``(base graph, ordered src, ordered dst)``: the drill's RMAT graph and
    its GEO order, or those saved in the npz ``graph`` (``src``, ``dst`` in
    GEO order, ``base_src``, ``base_dst`` and ``num_vertices``)."""
    if graph is not None:
        z = np.load(graph)
        v = int(z["num_vertices"])
        base = types.SimpleNamespace(src=z["base_src"], dst=z["base_dst"], num_vertices=v)
        return base, z["src"].astype(np.int64), z["dst"].astype(np.int64)
    g = rmat_graph(GRAPH_SCALE, GRAPH_EDGE_FACTOR, seed=GRAPH_SEED)
    order = ordering.geo_order(g, seed=0)
    return g, g.src[order].astype(np.int64), g.dst[order].astype(np.int64)


def _group(device: str):
    from repro_torch.launch import multihost as MH

    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    if group.torch_device.type != device:
        raise SystemExit(f"rank {group.rank} is on {group.torch_device}, the drill asked for {device}")
    return group


def _first_rank_of_its_process(group) -> bool:
    procs = list(group.processes)
    return procs.index(procs[group.rank]) == group.rank


def run_live(args) -> None:
    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.launch import multihost as MH
    from repro_torch.obs import metrics as OM
    from repro_torch.stream import StreamingEngine

    group = _group(args.device)
    r, process = group.rank, int(group.processes[group.rank])
    g, src, dst = build_ordered(args.graph)
    board = MH.LeaseBoard(os.path.join(args.dir, "leases"), lease_s=LEASE_S)
    registry = OM.MetricsRegistry()
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=REGIONS, config=drill_config())
    eng = StreamingEngine(o, group=group, metrics_registry=registry)
    ctl = ElasticController(REGIONS, metrics_registry=registry)
    ctl.attach_stream(eng)
    if r == 0:
        # One durability writer: every rank's orderer is a full replica, so
        # rank 0's checkpoint covers the whole slot array.
        ctl.attach_checkpoint(SlotCheckpoint(os.path.join(args.dir, "ckpt"), interval=CKPT_INTERVAL,
                                             metrics_registry=registry))
    stamps = _first_rank_of_its_process(group)
    stream = SyntheticStream(g, batch_size=args.batch, seed=STREAM_SEED)
    log(r, f"live: {group.size} ranks over {group.backend} on {group.torch_device}, process {process}")
    for step in range(BATCHES):
        ctl.ingest(stream.batch())
        eng.verify_bit_identity()  # a collective: stranded here once a peer is gone
        if stamps:
            board.stamp(process, step)
        log(r, f"live: batch {step} done, |E|={o.num_edges}")
        time.sleep(THROTTLE_S)
    # Reaching here means the parent never killed anyone: the drill failed upstream.
    log(r, "live: DONE (never killed)")


def run_recover(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.obs import metrics as OM
    from repro_torch.stream import StreamingEngine

    group = _group(args.device)
    r = group.rank
    g, _, _ = build_ordered(args.graph)
    registry = OM.MetricsRegistry()
    lost = [int(h) for h in args.lost_hosts.split(",") if h != ""]
    ck = SlotCheckpoint(os.path.join(args.dir, "ckpt"), interval=CKPT_INTERVAL, metrics_registry=registry)
    t0 = time.perf_counter()
    o, info = ck.restore(config=drill_config())
    restore_s = time.perf_counter() - t0
    last_durable = info["step"]
    log(r, f"recover: restored to batch {last_durable} (manifest {info['manifest_step']}, replayed "
           f"{info['replayed']} WAL records, {info['bytes_read']} bytes) in {restore_s:.3f} s")
    arrays = dict(restore_src=o.slot_src.copy(), restore_dst=o.slot_dst.copy(), restore_valid=o.slot_valid.copy())

    t0 = time.perf_counter()
    eng = StreamingEngine.from_restored(o, group=group, metrics_registry=registry)
    if group.torch_device.type == "cuda":
        torch.cuda.synchronize(group.torch_device)
    commit_s = time.perf_counter() - t0
    ctl = ElasticController(REGIONS, metrics_registry=registry)
    ctl.attach_stream(eng)
    # One durability writer, as in the live cluster. Every rank has read the
    # checkpoint by now: the commit above ends in a collective.
    if r == 0:
        ctl.attach_checkpoint(ck)
        ctl._batch_step = last_durable  # continue the durable step numbering
    fev, sev = ctl.report_failure(
        lost, detect_s=args.detect_s, reason="process lease expired (drill)",
        restored_bytes=info["bytes_read"], restore_s=restore_s, replayed_records=info["replayed"],
    )
    eng.verify_bit_identity()
    log(r, f"recover: failure shrink k {fev.k_old} -> {fev.k_new} executed={sev.executed}, "
           f"{sev.cross_device_bytes} B across ranks in {ctl.rescale_stats[-1].elapsed_s * 1e3:.3f} ms")

    stream = SyntheticStream(g, batch_size=args.batch, seed=STREAM_SEED)
    for b in range(last_durable + 1):
        stream.batch()  # regenerate (and discard) the already-durable prefix: batches come in order
    t0 = time.perf_counter()
    for b in range(last_durable + 1, BATCHES):
        ctl.ingest(stream.batch(b))
        eng.verify_bit_identity()
    continue_s = time.perf_counter() - t0
    log(r, f"recover: continued through batch {BATCHES - 1}, k={eng.k}")

    arrays.update(final_src=o.slot_src.copy(), final_dst=o.slot_dst.copy(), final_valid=o.slot_valid.copy(),
                  final_edges=eng.data.edges.cpu().numpy(), final_mask=eng.data.mask.cpu().numpy())
    record = {
        "rank": r,
        "group": [group.size, group.backend, str(group.torch_device)],
        "restore": dict(info),
        "restore_s": restore_s,
        "commit_s": commit_s,
        "continue_s": continue_s,
        "k_final": eng.k,
        "num_edges": o.num_edges,
        "parts": eng.data.local_partitions(),
        "failure_event": {
            "lost_hosts": list(fev.lost_hosts), "k_old": fev.k_old, "k_new": fev.k_new, "detect_s": fev.detect_s,
            "restored_bytes": fev.restored_bytes, "replayed_records": fev.replayed_records, "seq": fev.seq,
        },
        "scale_event": {"executed": sev.executed, "cross_device_bytes": sev.cross_device_bytes,
                        "cross_process_bytes": sev.cross_process_bytes,
                        "ms": ctl.rescale_stats[-1].elapsed_s * 1e3,
                        "sent_bytes": registry.counter("stream.rescale.sent_bytes").value,
                        "received_bytes": registry.counter("stream.rescale.received_bytes").value},
        "event_seqs": [ev.seq for ev in ctl.events],
        "event_kinds": [ev.kind for ev in ctl.events],
        "events_jsonl": ctl.events_jsonl(drop_timings=True),
        "checkpoint": {name: registry.counter(f"checkpoint.{name}").value
                       for name in ("snapshots", "wal_records", "restore_bytes")},
        "peak_rss_mb": OM.read_peak_rss()[1],
        "jax_loaded": any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules),
    }
    dist.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"recover{r}.npz"), **arrays)
    with open(os.path.join(args.out, f"recover{r}.json"), "w") as fh:
        json.dump(record, fh)
    log(r, "recover: DONE")


# ------------------------------------------------------------------ parent
def run_drill(shared, out, *, device: str, backend: str, live_devices: list, recover_devices: list,
              batch: int = STREAM_BATCH, graph: str | None = None) -> dict:
    """The drill end to end: the live cluster (4 ranks on ``live_devices``),
    SIGKILL of process 1's ranks once its lease shows batch ``KILL_STEP``, the
    lease board's detection, the survivors abandoned, then the recovery
    cluster (2 ranks on ``recover_devices``), ``batch`` updates a batch over
    the drill's graph or ``graph``. Returns the clusters' results,
    ``detect_s``, the seconds of each part, each rank's seconds from its
    cluster's launch to its first log line, and each recovery rank's record
    and arrays. Raises when a cluster fails."""
    from repro_torch.launch import multihost as MH

    shared, out = pathlib.Path(shared), pathlib.Path(out)
    me = str(pathlib.Path(__file__).resolve())
    common = ["--dir", str(shared), "--out", str(out), "--batch", str(batch), "--device", device] + (
        ["--graph", str(graph)] if graph is not None else [])
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    t0, launched = time.perf_counter(), {"live": time.monotonic()}
    cluster = MH.launch_local_cluster(LIVE_PROCS, LIVE_DEVS, [me, "--mode", "live"] + common, backend=backend,
                                      devices=live_devices, env_extra=env, cwd=str(ROOT))
    board = MH.LeaseBoard(shared / "leases", lease_s=LEASE_S)
    victims = [i for i in range(LIVE_PROCS * LIVE_DEVS) if i // LIVE_DEVS == 1]
    deadline = time.monotonic() + CLUSTER_TIMEOUT_S
    try:
        while board.step(1) < KILL_STEP:
            if any(cluster.poll(i) is not None for i in range(LIVE_PROCS * LIVE_DEVS)):
                raise RuntimeError(f"the live cluster died before the kill step:\n{cluster.wait(10.0).format_logs()}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"process 1 never reached batch {KILL_STEP}:\n{cluster.wait(5.0).format_logs()}")
            time.sleep(0.02)
        t_kill = time.monotonic()
        for i in victims:
            cluster.kill(i, reason="drill preemption")
        while 1 not in board.dead(LIVE_PROCS):
            if time.monotonic() - t_kill > 60.0:
                raise RuntimeError("the lease of the killed process never expired")
            time.sleep(0.02)
        detect_s = time.monotonic() - t_kill
        # The survivors are stranded in their next collective: abandon them.
        for i in range(LIVE_PROCS * LIVE_DEVS):
            if i not in victims:
                cluster.kill(i, reason="stranded survivor abandoned with the group")
    finally:
        live = cluster.wait(30.0)
    live_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launched["recover"] = time.monotonic()
    recover = MH.spawn_local_cluster(
        RECOVER_PROCS, RECOVER_DEVS,
        [me, "--mode", "recover"] + common + ["--detect-s", f"{detect_s:.6f}",
                                              "--lost-hosts", ",".join(str(h) for h in range(K_RECOVER, REGIONS))],
        backend=backend, devices=recover_devices, timeout=CLUSTER_TIMEOUT_S, env_extra=env, cwd=str(ROOT))
    if not recover.ok:
        raise RuntimeError(f"the recovery cluster failed:\n{recover.format_logs()}")
    n = RECOVER_PROCS * RECOVER_DEVS
    records = [json.loads((out / f"recover{r}.json").read_text()) for r in range(n)]
    arrays = [dict(np.load(out / f"recover{r}.npz")) for r in range(n)]
    return dict(live=live, recover=recover, detect_s=detect_s, live_s=live_s, recover_s=time.perf_counter() - t0,
                records=records, arrays=arrays, startup_s={mode: _first_stamp(res, t) for mode, (res, t) in (
                    ("live", (live, launched["live"])), ("recover", (recover, launched["recover"])))})


def _first_stamp(res, launched: float) -> list:
    """Seconds from a cluster's launch to each rank's first log line."""
    out = []
    for p in res.procs:
        stamps = [float(line.split(" t=")[1].split("]")[0]) for line in p.stdout.splitlines() if " t=" in line]
        out.append(round(min(stamps) - launched, 3) if stamps else None)
    return out


def drill_oracle(last_durable: int, *, batch: int = STREAM_BATCH, graph: str | None = None):
    """Host replay of the drill WITHOUT the failure: the same batches, the
    same re-plan (8 → 4 after the last durable batch), state never lost.
    Returns (final orderer, restore-point slot triple)."""
    g, src, dst = build_ordered(graph)
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=REGIONS, config=drill_config())
    stream = SyntheticStream(g, batch_size=batch, seed=STREAM_SEED)
    snap = None
    for b in range(BATCHES):
        o.apply(stream.batch(b))
        o.needs_resync = False
        o.drain_ops()
        if b == last_durable:
            snap = (o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy())
            o.relayout(K_RECOVER)
            o.drain_gather_map()
            o.needs_resync = False
    if snap is None:
        raise ValueError(f"last durable batch {last_durable} is not in [0, {BATCHES})")
    return o, snap


def reassemble(records: list, arrays: list, name: str = "final"):
    """The ranks' ``{name}_edges`` / ``{name}_mask`` row blocks back in
    partition order (padding rows dropped)."""
    rows_e, rows_m = {}, {}
    for rec, arr in zip(records, arrays):
        for i, p in enumerate(rec["parts"]):
            if p < rec["k_final"]:
                rows_e[p], rows_m[p] = arr[f"{name}_edges"][i], arr[f"{name}_mask"][i]
    return np.stack([rows_e[p] for p in sorted(rows_e)]), np.stack([rows_m[p] for p in sorted(rows_m)])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True, choices=["live", "recover"])
    ap.add_argument("--dir", required=True, help="shared checkpoint + lease directory")
    ap.add_argument("--out", required=True, help="directory for result artifacts")
    ap.add_argument("--device", required=True, choices=["cpu", "cuda"])
    ap.add_argument("--batch", type=int, default=STREAM_BATCH)
    ap.add_argument("--graph", default=None, help="npz of a GEO-ordered graph (default: the drill's RMAT graph)")
    ap.add_argument("--detect-s", type=float, default=0.0)
    ap.add_argument("--lost-hosts", default="")
    args = ap.parse_args()
    if args.mode == "live":
        run_live(args)
    else:
        run_recover(args)


if __name__ == "__main__":
    main()
