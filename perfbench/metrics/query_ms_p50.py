"""Median over every query due in the window: from when it was due to its
answer on the card after a synchronize, its wait in the queue included
(host clock)."""
from perfbench import stats

KINDS = ("pagerank", "sssp", "wcc")


def read(run):
    ms = [1e3 * (e["end"] - e["due"]) for e in run.events if e["kind"] in KINDS and e.get("ok")]
    return stats.percentile(ms, 50) if ms else None
