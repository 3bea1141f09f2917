"""What the device did in a traced window, from ``torch.profiler``'s trace.

The events are the profiler's own, read in memory, in the shape of the
Chrome trace it can export (``cat``, ``name``, ``ts`` and ``dur`` in
microseconds, ``pid``, ``tid``); nothing is written to disk, where a traced
window of back-to-back rescales exports over a gigabyte.
Device work is every kernel, copy and fill
(``kernel``, ``gpu_memcpy``, ``gpu_memset``); the window is the host range
``perfbench.window``. Busy time is the length of the union of the device
intervals inside the window, so kernels that overlap count once.
"""
from __future__ import annotations

import collections

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW = "perfbench.window"


def union(intervals):
    """Merged, sorted ``[(start, end)]`` of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """The traced window's device work. Times in the trace are microseconds;
    every figure this class gives is in seconds."""

    def __init__(self, events: list):
        windows = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not windows:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        w = self.window = windows[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.host_thread = (w.get("pid"), w.get("tid"))
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                       and self.w0 <= float(e["ts"]) < self.w1]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and (e.get("pid"), e.get("tid")) == self.host_thread]
        clipped = [(max(float(e["ts"]), self.w0), min(float(e["ts"]) + float(e["dur"]), self.w1)) for e in self.device]
        self.busy = union(clipped)

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        """From a stopped ``torch.profiler.profile``'s raw events, in memory: a
        device event not marked as an annotation is a kernel, copy or fill,
        a host event a range (annotation) or an operator."""
        events = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():
                    continue  # the device-side shadow of a host range
                cat = "gpu_memcpy" if name.startswith("Memcpy") else (
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            else:
                cat = "user_annotation" if e.is_user_annotation() else "cpu_op"
            events.append({"ph": "X", "cat": cat, "name": name, "ts": e.start_ns() / 1e3,
                           "dur": e.duration_ns() / 1e3, "pid": 0, "tid": e.start_thread_id()})
        return cls(events)

    def device_events(self) -> list:
        """The window's range and the device's work, without the host's
        events: what another rank sends rank 0, from which ``DeviceTrace``
        makes this trace again (its idle gaps then carry no host label)."""
        return [self.window] + self.device

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel(self, name: str):
        """``(launches, seconds)`` of the kernels whose name contains ``name``."""
        hits = [float(e["dur"]) for e in self.device if e["cat"] == "kernel" and name in e["name"]]
        return len(hits), sum(hits) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds]]`` of the device operations that took most time."""
        total = collections.Counter()
        for e in self.device:
            total[e["name"][:160]] += float(e["dur"]) * 1e-6
        return [[name, s] for name, s in total.most_common(n)]

    def idle_by_host(self, n: int = 10) -> list:
        """``[[host activity, seconds]]``: the device's idle time inside the
        window, summed by what the host's thread was doing at each gap's
        midpoint (the innermost range and operator open there)."""
        gaps, at = [], self.w0
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.w1:
            gaps.append((at, self.w1))
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"], e["name"]) for e in self.host),
                       key=lambda s: (s[0], -s[1]))
        total = collections.Counter()
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while i < len(spans) and spans[i][0] <= mid:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            ranges = [s[3] for s in stack if s[2] == "user_annotation" and s[1] >= mid]
            ops = [s[3] for s in stack if s[2] == "cpu_op" and s[1] >= mid]
            label = "/".join(x for x in (ranges[-1] if ranges else "", ops[-1] if ops else "") if x) or "host idle"
            total[label] += (b - a) * 1e-6
        return [[name, s] for name, s in total.most_common(n)]


def pooled_kernel_seconds(traces, name: str, launches: int):
    """Seconds of the kernels whose name contains ``name``, summed over every
    rank's trace; ``None`` unless every rank launched it ``launches`` times,
    at least once."""
    if not traces or launches <= 0:
        return None
    seconds = 0.0
    for trace in traces:
        n, s = trace.kernel(name)
        if n != launches:
            return None
        seconds += s
    return seconds
