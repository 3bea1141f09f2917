"""The ``segment_rf`` kernel's share of its byte roofline over the traced
window: the bytes of every re-check's count (``peaks``) over the kernel's
time in the device trace. Nothing where the trace's launches do not match
the window's re-checks one to one."""
from perfbench import peaks
from perfbench.sut import KERNELS


def read(run):
    if run.trace is None:
        return None
    done = [e for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    launches, seconds = run.trace.kernel(KERNELS["segment_rf"])
    if not done or launches != len(done):
        return None
    return peaks.roofline_pct(sum(peaks.segment_rf_bytes(run.num_edges, e["k_new"]) for e in done), seconds)
