"""The chip's peaks and the bytes each kernel on the timed path must move.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit. A
kernel's roofline share is the least time the chip could take for its
bytes, over the time the trace gives it. Each input byte is counted once as
read and each output byte once as written, whatever the kernel reads again.
"""
from __future__ import annotations

from . import cep

HBM_BYTES_PER_S = 3.35e12


def rescale_migrate_bytes(n: int, k_new: int) -> int:
    """One rank's migration to k_new: 8 bytes read for each edge copied (every
    edge, on one rank) and 12 bytes written for each slot of the new block
    (8 of edge, 4 of mask), k_new rows of ⌈n/k_new⌉."""
    return 8 * n + 12 * k_new * cep.chunk_max(n, k_new)


def segment_rf_bytes(n: int, k: int) -> int:
    """The re-check's count at k: C·W·4 bytes of sorted ids read and C·4 of
    counts written, C = k rows of W = 2·⌈n/k⌉ ids."""
    rows, width = k, 2 * cep.chunk_max(n, k)
    return rows * width * 4 + rows * 4


def roofline_pct(bytes_moved: int, seconds: float):
    """The share of the byte roofline in percent; ``None`` without a time."""
    if seconds <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / seconds
