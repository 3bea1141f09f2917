"""95th percentile over every scale event of the window, timed as for
``rescale_ms_p50`` (host clock)."""
from perfbench import stats


def read(run):
    ms = [1e3 * (e["end"] - e["start"]) for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    return stats.percentile(ms, 95) if ms else None
