"""Median over the window's scale events of the span
``rescale.layout_check``: the per-row edge count on the card, its readback
and the verdict, so it holds the device's count (program span, from the
device trace's host ranges)."""
from perfbench import spans


def read(run):
    return spans.median_ms(run.trace, "rescale.layout_check")
