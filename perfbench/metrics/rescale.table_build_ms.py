"""Mean a scale event of the span ``rescale.table_build``, the migration
table built and uploaded on a program-cache miss: its summed time over the
count of ``rescale.execute`` spans, so a hit counts 0 (program span, from
the device trace's host ranges)."""
from perfbench import spans


def read(run):
    events = spans.ranges(run.trace, "rescale.execute")
    if not events:
        return None
    return sum(b - a for a, b in spans.ranges(run.trace, "rescale.table_build")) / 1e3 / len(events)
