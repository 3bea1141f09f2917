"""Median over the window's scale events of the span ``rescale.plan``:
``cep.scale_plan`` on the host (program span, from the device trace's host
ranges)."""
from perfbench import spans


def read(run):
    return spans.median_ms(run.trace, "rescale.plan")
