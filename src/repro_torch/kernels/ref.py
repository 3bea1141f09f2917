"""Numpy oracle for the ``segment_rf`` kernel (the correctness ground truth)."""
from __future__ import annotations

import numpy as np


def segment_distinct_counts_ref(ids_sorted: np.ndarray, pad_id: int) -> np.ndarray:
    """Distinct non-pad values per row (rows need not even be sorted here)."""
    out = np.zeros(ids_sorted.shape[0], dtype=np.int32)
    for i, row in enumerate(np.asarray(ids_sorted)):
        out[i] = np.unique(row[row != pad_id]).shape[0]
    return out
