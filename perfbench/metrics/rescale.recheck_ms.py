"""Median over the window's scale events of the program's own time of the
re-check of mirrors and RF (``RescaleStats.recheck_s``: ``packed_rows``'
sort, ``segment_rf`` and the readback)."""
from perfbench import stats


def read(run):
    ms = [1e3 * e["recheck_s"] for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    return stats.median(ms) if ms else None
