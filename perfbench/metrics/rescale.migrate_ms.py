"""Median over the window's scale events of the program's own time of the
migration and the exchange (``RescaleStats.elapsed_s``, the span
``rescale.migrate``, ending at a synchronize)."""
from perfbench import stats


def read(run):
    ms = [1e3 * e["migrate_s"] for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    return stats.median(ms) if ms else None
