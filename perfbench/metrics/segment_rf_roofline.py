"""The ``segment_rf`` kernel's share of its byte roofline over the traced
window, pooled over the ranks: the bytes of every rank's re-check counts
(``peaks.segment_rf_rank_bytes``) over the kernel's time summed over every
rank's device trace (one trace on one card). Nothing where any rank's
launches do not match the window's re-checks one to one."""
from perfbench import devtrace, peaks
from perfbench.sut import KERNELS


def read(run):
    done = [e for e in run.events if e["kind"] == "rescale" and e.get("ok")]
    seconds = devtrace.pooled_kernel_seconds(run.traces, KERNELS["segment_rf"], len(done))
    if seconds is None:
        return None
    g = len(run.traces)
    return peaks.roofline_pct(sum(g * peaks.segment_rf_rank_bytes(run.num_edges, e["k_new"], g) for e in done),
                              seconds)
