"""Median over the window's re-checks of the device's busy time from the
start of the span ``rescale.recheck`` to the start of the first
``segment_rf`` kernel inside it: ``packed_rows``' where and sort. The card
is idle as the span opens, since ``rescale.migrate`` ends at a synchronize.
A re-check that launched no ``segment_rf`` kernel (its plain version, on a
CPU) ends the interval where its ``rescale.recheck.count`` span starts; one
with neither, the re-check off, is left out (device trace)."""
from perfbench import spans, stats
from perfbench.sut import KERNELS


def read(run):
    if run.trace is None:
        return None
    launches = spans.kernel_starts(run.trace, KERNELS["segment_rf"])
    counts = [a for a, _ in spans.ranges(run.trace, "rescale.recheck.count")]
    before = []
    for a, b in spans.ranges(run.trace, "rescale.recheck"):
        end = spans.first_at_or_after(launches, a, b)
        if end is None:
            end = spans.first_at_or_after(counts, a, b)
        if end is not None:
            before.append((a, end))
    return stats.median([us / 1e3 for us in spans.busy_in(run.trace, before)]) if before else None
