"""Median over the window's SSSP and WCC queries' sweeps of the span
``query.sweep``: one ``min_sweep`` launch and the stop flag's readback, so
it holds the sweep's device time (program span, from the device trace's
host ranges)."""
from perfbench import spans


def read(run):
    return spans.median_ms(run.trace, "query.sweep")
