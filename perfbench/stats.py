"""Order statistics over all the samples of a window (no tail from pieces)."""
from __future__ import annotations

import math


def percentile(values, q: float):
    """The q-th percentile (0–100) by linear interpolation between the two
    nearest ranks, as numpy's default; ``None`` for no samples."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values):
    return percentile(values, 50.0)
