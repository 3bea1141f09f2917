"""95th percentile over every query due in the window, timed as for
``query_ms_p50`` (host clock)."""
from perfbench import stats

KINDS = ("pagerank", "sssp", "wcc")


def read(run):
    ms = [1e3 * (e["end"] - e["due"]) for e in run.events if e["kind"] in KINDS and e.get("ok")]
    return stats.percentile(ms, 95) if ms else None
