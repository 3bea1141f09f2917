"""Graph-query serving scenarios for the port: the reference's serving
benchmark (``benchmarks/bench_serve.py:66-125`` at its defaults) built over
either package's control plane, its trajectory, and a multi-rank worker.

The scenario is ``chip_smoke.py`` path 9 (b): RMAT scale 9, edge factor 8,
K0 = 4 regions, two days of 96 ticks with an ingest batch of 32 updates every
tick, the reference's autoscaler settings and open-loop workload, and
``ServeConfig()`` (a probe every 8 ticks). The engine runs both re-order
rungs on the device (span ``differential``, full ``device``), and the drifts
of ``STREAM`` make both fire: span repairs on most batches, 8 full rebuilds.
(``tests/test_serve.py:80``'s full drift of 1.02 fires the full rung on 41
batches and the span rung on 4.)

* ``build_loop`` wires a port ``StreamingEngine`` under a controller,
  autoscaler, workload and ``ServeLoop`` from the modules in ``pkg``: the
  port's by default, or the JAX package's (the tests pass them; this file
  imports no JAX).
* ``trajectory`` is what a run must reproduce on any machine: decisions,
  served / shed / SLO counts, modeled percentiles and every record's
  ``(tick, arrival_tick, kind, latency_s)``. A scale-in's reason quotes the
  measured p99 of the ingest wall, so reasons are compared masked.
* ``python tests/torch_serve_harness.py --out DIR`` is one rank of a
  ``launch_local_cluster`` group: it runs the scenario over the group and
  writes its trajectory and probe answers; ``run_cluster`` is the parent.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

SCENARIO = dict(scale=9, edge_factor=8, k0=4, day_ticks=96, days=2, ingest_batch=32, seed=0)
AUTOSCALE = dict(k_min=2, k_max=16, step_out=2, step_in=2, queue_high_per_host=3.0, queue_low=0.5, ema=0.6,
                 out_cooldown_s=8.0, in_cooldown_s=16.0)
STREAM = dict(partial_drift=1.01, full_drift=1.1)
ENGINE = dict(span_repair="differential", full_rebuild="device")
FLAP_GAP_TICKS = 6  # opposite-direction decisions closer than this are a flap (bench_serve.py)
TRAJECTORY_FILE = ROOT / "tests" / "torch_serve_trajectory.json"
GROUP_TIMEOUT_S = 120.0
_P99 = re.compile(r"p99 [0-9.]+ms")


def port_modules():
    """The port's control-plane modules, as ``build_loop``'s ``pkg``."""
    from repro_torch.elastic import autoscale, controller
    from repro_torch.launch import serve
    from repro_torch.obs import metrics
    from repro_torch.stream import workload

    return types.SimpleNamespace(controller=controller, autoscale=autoscale, serve=serve, metrics=metrics,
                                 workload=workload)


def build_ordered(*, scale: int, edge_factor: int, seed: int, **_):
    """``(graph, ordered src, ordered dst)``: the RMAT graph and its GEO order."""
    from repro_torch.core import ordering
    from repro_torch.core.graph import rmat_graph

    g = rmat_graph(scale, edge_factor, seed=seed)
    order = ordering.geo_order(g, seed=0)
    return g, g.src[order].astype(np.int64), g.dst[order].astype(np.int64)


def build_loop(ordered, *, pkg=None, device=None, group=None, k0: int, day_ticks: int, ingest_batch: int,
               seed: int, probe_every: int = 8, stream=STREAM, engine=ENGINE, **_):
    """The scenario's serve loop over a port ``StreamingEngine`` on ``device``
    (or over ``group``), the controller, autoscaler, workload and loop taken
    from ``pkg``. Returns ``(loop, controller, policy, engine)``."""
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    pkg = pkg or port_modules()
    g, src, dst = ordered
    registry = pkg.metrics.MetricsRegistry()
    orderer = IncrementalOrderer(src, dst, g.num_vertices, regions=k0, config=StreamConfig(**stream))
    eng = StreamingEngine(orderer, device=device, group=group, metrics_registry=registry, **engine)
    # The serve loop owns the virtual clock; the controller reads it through
    # this indirection (the loop is constructed after the controller).
    loop_ref: list = []
    ctl = pkg.controller.ElasticController(k0, clock=lambda: loop_ref[0].now if loop_ref else 0.0,
                                           metrics_registry=registry)
    ctl.attach_stream(eng)
    policy = pkg.autoscale.AutoscalePolicy(pkg.autoscale.AutoscaleConfig(**AUTOSCALE))
    ctl.attach_autoscaler(policy)
    workload = pkg.workload.OpenLoopWorkload(
        num_vertices=g.num_vertices, base_rate=k0 * 2.0, day_ticks=day_ticks, diurnal_amp=0.8,
        burst_every=day_ticks // 4, burst_factor=3.0, seed=seed)
    updates = SyntheticStream(g, batch_size=ingest_batch, seed=seed)
    loop = pkg.serve.ServeLoop(ctl, workload, updates=updates, registry=registry,
                               config=pkg.serve.ServeConfig(probe_every=probe_every))
    loop_ref.append(loop)
    return loop, ctl, policy, eng


def run_scenario(loop, *, day_ticks: int, days: int, **_) -> None:
    loop.run(day_ticks * days)
    loop.drain()


def mask_p99(text: str) -> str:
    """A scale-in reason quotes the measured p99 of the ingest wall: masked."""
    return _P99.sub("p99 <measured>", text)


def flap_pairs(policy, tick_s: float) -> int:
    """Opposite-direction decision pairs closer than the flap window, from
    the policy's own signal log (``bench_serve.py:_flap_pairs``)."""
    decisions = [s for s in policy.log if s.decision]
    return sum(1 for a, b in zip(decisions, decisions[1:])
               if a.decision != b.decision and (b.now - a.now) < FLAP_GAP_TICKS * tick_s)


def trajectory(loop, policy) -> dict:
    """What the run must reproduce on any machine (JSON-ready)."""
    s = loop.summary()
    return {
        "k_path": s["k_path"],
        "decisions": [dict(seq=ev.seq, kind=ev.kind, k_old=ev.k_old, k_new=ev.k_new, executed=ev.executed,
                           moved_edges=s["moved_edges_per_decision"][i], reason=mask_p99(ev.reason))
                      for i, ev in enumerate(loop.scale_events)],
        "served": s["served"], "shed": s["shed"], "slo_violations": s["slo_violations"],
        "latency_p50_s": s["latency_p50_s"], "latency_p99_s": s["latency_p99_s"],
        "scale_outs": s["scale_outs"], "scale_ins": s["scale_ins"],
        "flap_pairs": flap_pairs(policy, loop.config.tick_s),
        "records": [[r.tick, r.arrival_tick, r.kind, r.latency_s] for r in loop.records],
    }


def record_probes(loop) -> list:
    """Wrap ``loop.queries.query`` so every probe's answer is kept on the host:
    ``(tick, kind, source, answer, iterations)``, iterations -1 for PageRank."""
    probes: list = []
    query = loop.queries.query

    def recorded(kind, source=0):
        out, elapsed = query(kind, source)
        answer, iters = (out, -1) if kind == "pagerank" else out
        probes.append((loop.tick_index, kind, source, answer.cpu().numpy(), iters))
        return out, elapsed

    loop.queries.query = recorded
    return probes


# ------------------------------------------------------------------ worker
def worker(args) -> None:
    import torch

    from repro_torch.kernels import full_reorder, min_sweep, segment_rf
    from repro_torch.launch import multihost as MH

    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    scenario = json.loads(args.scenario)
    t0 = time.perf_counter()
    loop, ctl, policy, eng = build_loop(build_ordered(**scenario), group=group, **scenario)
    probes = record_probes(loop)
    loop.queries.warm()
    warm_sweeps = sum(iters for _, kind, _, _, iters in probes if kind != "pagerank")
    del probes[:]  # the warm-up's answers are not probes of the run
    run_scenario(loop, **scenario)
    if group.torch_device.type == "cuda":
        torch.cuda.synchronize(group.torch_device)
    wall = time.perf_counter() - t0
    eng.verify_bit_identity()
    out = pathlib.Path(args.out)
    record = dict(rank=group.rank, size=group.size, backend=group.backend, device=str(group.torch_device),
                  trajectory=trajectory(loop, policy), wall_s=wall,
                  probes=[[tick, kind, source, iters] for tick, kind, source, _, iters in probes],
                  probe_s=[r.measured_s for r in loop.records if r.measured_s > 0],
                  launches=dict(segment_rf=segment_rf.launches, full_reorder=full_reorder.launches,
                                min_sweep=min_sweep.launches),
                  sweeps=warm_sweeps + sum(iters for _, kind, _, _, iters in probes if kind != "pagerank"),
                  events_jsonl=mask_p99(ctl.events_jsonl(drop_timings=True)))
    (out / f"rank{group.rank}.json").write_text(json.dumps(record))
    np.savez(out / f"rank{group.rank}.npz", *[answer for _, _, _, answer, _ in probes])
    print(f"[rank {group.rank}] {len(loop.records)} served, k path {record['trajectory']['k_path']}, "
          f"{len(probes)} probes, {wall:.3f} s", flush=True)


def run_cluster(out, *, backend: str, n_procs: int, devs_per_proc: int, devices: list, scenario: dict,
                timeout: float = 600.0) -> list:
    """The scenario over ``n_procs × devs_per_proc`` ranks on ``devices``;
    returns each rank's record with its probe answers under ``"answers"``.
    Raises when the cluster fails."""
    from repro_torch.launch import multihost as MH

    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    me = str(pathlib.Path(__file__).resolve())
    res = MH.spawn_local_cluster(n_procs, devs_per_proc, [me, "--out", str(out), "--scenario", json.dumps(scenario)],
                                 backend=backend, devices=devices, timeout=timeout,
                                 env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}, cwd=str(ROOT))
    if not res.ok:
        raise RuntimeError(f"the serving cluster failed:\n{res.format_logs()}")
    records = []
    for r in range(n_procs * devs_per_proc):
        rec = json.loads((out / f"rank{r}.json").read_text())
        with np.load(out / f"rank{r}.npz") as z:
            rec["answers"] = [z[f"arr_{i}"] for i in range(len(rec["probes"]))]
        records.append(rec)
    return records


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="directory for each rank's record")
    ap.add_argument("--scenario", default=json.dumps(SCENARIO), help="the scenario's keywords as JSON")
    worker(ap.parse_args())


if __name__ == "__main__":
    main()
