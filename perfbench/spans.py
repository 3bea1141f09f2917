"""The program's own spans in a traced window, read from the device trace.

In a traced run ``sut.System`` installs the port's tracer with profiler
ranges on, so each span of the program is a ``user_annotation`` range on the
window's host thread, on the same clock as the device's kernels. Times here
are the trace's microseconds unless a name says otherwise.
"""
from __future__ import annotations

import bisect

from perfbench import stats


def ranges(trace, name: str) -> list:
    """``[(start, end)]`` of the ranges called ``name`` that start inside the
    window, in time order; empty without a trace."""
    if trace is None:
        return []
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.host
                  if e["cat"] == "user_annotation" and e["name"] == name and trace.w0 <= float(e["ts"]) < trace.w1)


def median_ms(trace, name: str):
    """Median duration of the ``name`` ranges in milliseconds; ``None`` for none."""
    found = ranges(trace, name)
    return stats.median([(b - a) / 1e3 for a, b in found]) if found else None


def kernel_starts(trace, name: str) -> list:
    """Sorted start times of the window's kernels whose name contains ``name``."""
    return sorted(float(e["ts"]) for e in trace.device if e["cat"] == "kernel" and name in e["name"])


def first_at_or_after(starts: list, a: float, b: float):
    """The first of the sorted ``starts`` in ``[a, b]``, ``None`` if none is."""
    i = bisect.bisect_left(starts, a)
    return starts[i] if i < len(starts) and starts[i] <= b else None


def busy_in(trace, intervals) -> list:
    """For each ``(a, b)`` of ``intervals``, the microseconds in it in which
    some kernel, copy or fill ran."""
    busy = trace.busy  # merged and sorted, so the intervals' ends ascend too
    ends = [end for _, end in busy]
    out = []
    for a, b in intervals:
        i, total = bisect.bisect_right(ends, a), 0.0
        while i < len(busy) and busy[i][0] < b:
            total += min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
        out.append(total)
    return out
