"""CEP chunk arithmetic, frozen for the benchmark (the paper's §3.3, Theorem 1).

Partition p of k over an ordered list of n edges owns the ordered ids
``[start(p), start(p + 1))`` with ``start(p) = p·⌊n/k⌋ + max(0, p − k + n mod k)``:
the first ``k − n mod k`` chunks hold ``⌊n/k⌋`` edges, the others one more.
The reference and the byte counts use this copy, never the program's.
"""
from __future__ import annotations

import numpy as np
import torch


def chunk_bounds(n: int, k: int) -> np.ndarray:
    """``(k + 1,)`` int64: partition p owns ordered ids ``[b[p], b[p + 1])``."""
    p = np.arange(k + 1, dtype=np.int64)
    return p * (n // k) + np.maximum(p - k + n % k, 0)


def chunk_max(n: int, k: int) -> int:
    """The largest chunk, ⌈n/k⌉: the width of a row of the pack."""
    return -(-n // k)


def chunk_of(pos: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The partition that owns each ordered id in ``pos`` (an int64 tensor)."""
    f, r = n // k, n % k
    cut = (k - r) * f  # the first id of a chunk of f + 1
    small = pos // max(f, 1)
    large = (k - r) + (pos - cut) // (f + 1)
    return torch.where(pos < cut, small, large)
