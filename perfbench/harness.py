"""One run of one cell: set-up, warm-up, the measured window, the check, the metrics.

Set-up makes the configuration's graph on the device, copies
the ordered list to the host, and hands it to the system under test that the
configuration names (``spec.system``): its pack at the first k of the mix's
schedule, then the mix's warm-up. ``setup_s`` runs
from the process's start to the window's first item. The device's memory
peak is counted from the pack on (the generator's own buffers are the
benchmark's) to the window's close. With ``trace`` the window runs under
``torch.profiler`` and the run reports the per-layer metrics; without, the
end-to-end ones. The check runs after the window, once the peak is read and
the program's state is freed, on the answers and packs the window kept.

Over several ranks (``ranks.World``, one process a device) every rank runs
this same function in step, as ``ranks.py`` sets out; rank 0 alone judges,
reads the metrics and returns a result.
"""
from __future__ import annotations

import collections
import time
import types

import torch

from . import devtrace, judge, ranks, spec as specmod

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


def _whole(system, data, k: int):
    """``(edges, mask, k)`` of one held pack, whole."""
    edges, mask, _, _ = system.view(data)
    return edges, mask, k


def run(cell_name: str, seed: int, seconds: float, trace: bool, device, *, t_start: float,
        spec: specmod.Spec | None = None, config: dict | None = None, mix: dict | None = None, system_cls=None,
        world: ranks.World | None = None, log=None) -> dict | None:
    """The result of one run, as ``run.py`` prints it; ``None`` on a rank
    other than 0."""
    world = world or ranks.World()
    spec = spec or specmod.Spec()
    cell = spec.cell(cell_name)
    config = config or spec.config(cell["config"])
    mix = mix or specmod.mix(cell["traffic"])
    system_cls = system_cls or specmod.system(config)
    driver = specmod.load_module("drivers", mix["driver"])
    generator = specmod.load_module("generators", config["generator"]["module"])
    dev = torch.device(device)

    stamps = [("start", time.perf_counter())]
    src, dst, num_vertices, present = generator.generate(config["generator"], dev)
    world.same_graph(src, dst, num_vertices)
    _sync(dev)
    stamps.append(("generate", time.perf_counter()))
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    stamps.append(("readback", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    system = system_cls(num_vertices=num_vertices, device=dev, queries=mix["queries"], traced=trace, world=world)
    k0 = driver.first_k(config["k_range"], mix)
    data = system.pack(src_h, dst_h, k0)
    if world.rank != 0:
        src_h = dst_h = None  # rank 0 alone judges; the player reads only ``present``
    stamps.append(("pack", time.perf_counter()))
    player = driver.Player(system, mix, config, seed=seed, present=present, annotate=trace, hold=HELD_PACKS,
                           world=world)
    data = player.warm(data, k0)
    counters_before = system.cache_counters()
    sent_before = system.sent_bytes() if world.ranked else 0

    world.barrier()
    setup_s = time.perf_counter() - t_start
    stamps.append(("warm-up", time.perf_counter()))
    world.phase("window")
    if trace:
        (data, events, lateness, window_s), dtrace = _traced(lambda: player.play(data, seconds), dev, stamps)
    else:
        (data, events, lateness, window_s), dtrace = player.play(data, seconds), None
        stamps.append(("window", time.perf_counter()))
    world.phase("check")
    counters_after = system.cache_counters()
    memory_peak = world.max_int(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    traces = world.gather(None if dtrace is None else dtrace.device_events())
    sent = world.sum_int(system.sent_bytes() - sent_before) if world.ranked else 0
    held = player.held + [(data, player.k)]
    warm_items = player.warm_items
    del player, data

    def packs():
        """``(edges, mask, k asked for)`` of each pack the check compares,
        whole: over ranks, gathered from every rank one at a time. Each held
        pack is dropped as it is handed over, and nothing here keeps the
        whole one once the next is asked for."""
        while held:
            yield _whole(system, *held.pop(0))

    system.close()  # frees the program's state; its packs stay readable
    if world.rank != 0:
        collections.deque(packs(), maxlen=0)  # takes part in each gather, keeps nothing
        return None
    checks = judge.judge(src_h, dst_h, num_vertices, events, packs(), mix["queries"], config["limits"], dev)
    del system, held
    stamps.append(("check", time.perf_counter()))
    for e in events:
        e.pop("answer", None)  # the answers are judged: free them before the metrics
    failed = sum(1 for e in events + warm_items if not e.get("ok"))

    traces = None if dtrace is None else [dtrace] + [devtrace.DeviceTrace(t) for t in traces[1:]]
    facts = types.SimpleNamespace(events=events, setup_s=setup_s, counters_before=counters_before,
                                  counters_after=counters_after, trace=dtrace, traces=traces,
                                  num_edges=int(src_h.shape[0]))
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
        if world.ranked:
            planned = sum(e["cross_bytes"] for e in events if e.get("kind") == "rescale" and e.get("ok"))
            log(f"ranks: {world.size}; the window's rescales sent {sent} B between ranks, the plans "
                f"{planned} B; memory peak over the ranks {memory_peak} B")
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
            "count": world.size,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if dtrace is not None:
        result["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": dtrace.top_ops(10), "idle_gaps": dtrace.idle_by_host(10)}
    result["checks"] = checks
    return result
