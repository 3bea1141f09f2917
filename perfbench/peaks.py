"""The chip's peaks and the bytes each kernel on the timed path must move.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit. A
kernel's roofline share is the least time the chip could take for its
bytes, over the time the trace gives it. Each input byte is counted once as
read and each output byte once as written, whatever the kernel reads again.

Over g ranks each rank launches each kernel on its own rows, partition p on
rank p mod g at local row p div g, every rank a block of ⌈k/g⌉ rows (the
padding rows past k included). ``*_rank_bytes`` count what rank r's own
launch moves; g = 1 is one card.
"""
from __future__ import annotations

import numpy as np

from . import cep

HBM_BYTES_PER_S = 3.35e12


def rescale_migrate_rank_bytes(n: int, k_old: int, k_new: int, g: int, r: int) -> int:
    """Rank r's migration from k_old to k_new over g ranks, as
    ``rescale_migrate.cu`` moves it. Its block holds ⌈k_new/g⌉ rows of
    ⌈n/k_new⌉ slots; the launch writes each slot's 4 bytes of mask and,
    except in the ranges that another rank sends (the exchange writes those
    edges), its 8 bytes of edge; it reads the 8 bytes of each edge it copies.
    An ordered id of one of rank r's new partitions is copied where its old
    partition is rank r's too and received where it is another's:
    ``8·copied + 12·slots − 8·received``. At g = 1 every edge is copied:
    8·n + 12·k_new·⌈n/k_new⌉."""
    b_old, b_new = cep.chunk_bounds(n, k_old), cep.chunk_bounds(n, k_new)
    cuts = np.union1d(b_old, b_new)  # each piece between two cuts lies in one old and one new chunk
    starts, lengths = cuts[:-1], np.diff(cuts)
    p_old = np.searchsorted(b_old, starts, side="right") - 1
    p_new = np.searchsorted(b_new, starts, side="right") - 1
    mine = p_new % g == r
    copied = int(lengths[mine & (p_old % g == r)].sum())
    received = int(lengths[mine & (p_old % g != r)].sum())
    slots = -(-k_new // g) * cep.chunk_max(n, k_new)
    return 8 * copied + 12 * slots - 8 * received


def segment_rf_rank_bytes(n: int, k: int, g: int) -> int:
    """Each rank's re-check count at k over g ranks: its ⌈k/g⌉ rows of
    W = 2·⌈n/k⌉ sorted ids read (a padding row, all pad ids, is read as
    any other) and a count a row written. At g = 1: k rows, k·(W·4 + 4)."""
    rows, width = -(-k // g), 2 * cep.chunk_max(n, k)
    return rows * width * 4 + rows * 4


def roofline_pct(bytes_moved: int, seconds: float):
    """The share of the byte roofline in percent; ``None`` without a time."""
    if seconds <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / seconds
