"""One run of one cell: set-up, warm-up, the measured window, the check, the metrics.

Set-up makes the configuration's graph on the device, copies
the ordered list to the host, and hands it to the program: ``pack_ordered``
at the first k of the mix's schedule, then the mix's warm-up. ``setup_s`` runs
from the process's start to the window's first item. The device's memory
peak is counted from the pack on (the generator's own buffers are the
benchmark's) to the window's close. With ``trace`` the window runs under
``torch.profiler`` and the run reports the per-layer metrics; without, the
end-to-end ones. The check runs after the window, once the peak is read and
the program is dropped, on the answers the window kept.
"""
from __future__ import annotations

import time
import types

import torch

from . import devtrace, judge, spec as specmod

HELD_PACKS = 3  # rescale events whose pack the check compares slot by slot, besides the last


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced(play, dev: torch.device, stamps: list):
    """``play()`` under the profiler; returns its result and the ``DeviceTrace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = play()
        _sync(dev)
        stamps.append(("window", time.perf_counter()))
    stamps.append(("profiler stop", time.perf_counter()))
    trace = devtrace.DeviceTrace.from_profiler(prof)
    stamps.append(("trace read", time.perf_counter()))
    return out, trace


def run(cell_name: str, seed: int, seconds: float, trace: bool, device, *, t_start: float,
        spec: specmod.Spec | None = None, config: dict | None = None, mix: dict | None = None, system_cls=None,
        log=None) -> dict:
    """The result of one run, as ``run.py`` prints it."""
    if system_cls is None:
        from . import sut

        system_cls = sut.System
    spec = spec or specmod.Spec()
    cell = spec.cell(cell_name)
    config = config or spec.config(cell["config"])
    mix = mix or specmod.mix(cell["traffic"])
    driver = specmod.load_module("drivers", mix["driver"])
    generator = specmod.load_module("generators", config["generator"]["module"])
    dev = torch.device(device)

    stamps = [("start", time.perf_counter())]
    src, dst, num_vertices, present = generator.generate(config["generator"], dev)
    _sync(dev)
    stamps.append(("generate", time.perf_counter()))
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    stamps.append(("readback", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    system = system_cls(num_vertices=num_vertices, device=dev, queries=mix["queries"], traced=trace)
    k0 = driver.first_k(config["k_range"], mix)
    data = system.pack(src_h, dst_h, k0)
    stamps.append(("pack", time.perf_counter()))
    player = driver.Player(system, mix, config, seed=seed, present=present, annotate=trace, hold=HELD_PACKS)
    data = player.warm(data, k0)
    counters_before = system.cache_counters()

    setup_s = time.perf_counter() - t_start
    stamps.append(("warm-up", time.perf_counter()))
    if trace:
        (data, events, lateness, window_s), dtrace = _traced(lambda: player.play(data, seconds), dev, stamps)
    else:
        (data, events, lateness, window_s), dtrace = player.play(data, seconds), None
        stamps.append(("window", time.perf_counter()))
    counters_after = system.cache_counters()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    edges, mask, _, _ = system.view(data)
    packs = player.held + [(edges, mask, player.k)]
    warm_items = player.warm_items
    system.close()
    del system, player, data, edges, mask

    checks = judge.judge(src_h, dst_h, num_vertices, events, packs, mix["queries"], config["limits"], dev)
    stamps.append(("check", time.perf_counter()))
    for e in events:
        e.pop("answer", None)  # the answers are judged: free them before the metrics
    del packs
    failed = sum(1 for e in events + warm_items if not e.get("ok"))

    facts = types.SimpleNamespace(events=events, setup_s=setup_s, counters_before=counters_before,
                                  counters_after=counters_after, trace=dtrace, num_edges=int(src_h.shape[0]))
    metrics = {}
    for m in spec.metrics_of(cell_name, trace):
        value = specmod.reader(m["name"])(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    stamps.append(("metrics", time.perf_counter()))
    if log is not None:
        log(f"graph: {src_h.shape[0]} edges, {present.shape[0]} vertices with an edge, {num_vertices} ids")
        rf = {e["k_new"]: (e["mirrors"] + present.shape[0]) / present.shape[0]
              for e in warm_items + events if e.get("kind") == "rescale" and e.get("ok") and e["mirrors"] >= 0}
        log("RF over the vertices with an edge, by k: " + ", ".join(
            f"{k}: {rf[k]:.4f}" for k in (4, 8, 16, 32, 64, 128) if k in rf))
        log(f"setup {setup_s:.3f} s: before the graph {stamps[0][1] - t_start:.3f} s, " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(stamps, stamps[1:])))
        late = sorted(lateness)
        log(f"window {window_s:.3f} s, {len(events)} items, {failed} failed; generator late by "
            f"p50 {1e3 * late[len(late) // 2]:.3f} ms, max {1e3 * late[-1]:.3f} ms over {len(late)} waits"
            if late else f"window {window_s:.3f} s, {len(events)} items, {failed} failed; no wait for a due time")
        for kind in sorted({e["kind"] for e in events if e.get("ok")}):
            ms = [1e3 * (e["end"] - e["start"]) for e in events if e["kind"] == kind and e.get("ok")]
            log(f"{kind}: {len(ms)} served, service mean {sum(ms) / len(ms):.3f} ms, max {max(ms):.3f} ms")
        for e in warm_items + events:
            if not e.get("ok"):
                log(f"failed {e.get('kind')} at {e.get('start', 0):.3f} s: {e.get('error')}")
                break

    result = {
        "correct": failed == 0 and len(events) > 0 and judge.passed(checks),
        "attempted": len(events),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if dtrace is not None:
        result["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": dtrace.top_ops(10), "idle_gaps": dtrace.idle_by_host(10)}
    result["checks"] = checks
    return result
