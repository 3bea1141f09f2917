"""Median over every scale event of the window: its start to the new pack's
re-check on the card, after a synchronize (host clock)."""
from perfbench import stats


def read(run):
    ms = [1e3 * (e["end"] - e["start"]) for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    return stats.percentile(ms, 50) if ms else None
