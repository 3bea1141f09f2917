"""Per-row distinct-id counting: the replication-factor measure, as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/segment_rf.py``
(``segment_distinct_counts``, body ``_segment_rf_kernel``) with the
hand-written CUDA kernel ``csrc/segment_rf.cu``, built for ``sm_90a`` and
called through ``ctypes``.

Input: a ``(C, W)`` int32 tensor, each row sorted ascending and padded at the
tail with ``PAD_ID`` (int32 max). Output: ``(C,)`` int32, the number of
positions with ``ids[i] != ids[i-1]`` and ``ids[i] != PAD_ID`` (``ids[-1]``
taken as -1) — each row's distinct-id count.

The kernel is bound by memory: it reads ``C·W·4`` bytes once and writes
``C·4``, so ``(C·W·4 + C·4) / 3.35e12`` s is the least time an H100 could
take for the same work. It is one launch a call with 16-byte loads; a row is
split among several CTAs, whose partials the row's last CTA sums, and every
count is written with a plain store, so the output needs no zero-fill (see
the source's note). The rows' counters that find the last CTA are zeroed
once for each CUDA stream and left zero by every launch.

Dispatch: a tensor on the CPU goes to the plain version
``segment_distinct_counts_torch``; a CUDA tensor launches the kernel or
raises. ``launches`` counts kernel launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..compat import PAD_ID
from . import _build

__all__ = ["PAD_ID", "ctas_per_row", "launches", "segment_distinct_counts", "segment_distinct_counts_torch"]

launches = 0  # kernel launches by segment_distinct_counts since import (or a reset)
CTAS_PER_SM = 4  # CTAs a launch aims for, per SM: the fastest of 2 to 32 (tools/segment_rf_variants.py)
_lib = None  # (segment_rf_counts with its ctypes signature set once, ids a CTA reads an iteration)
_sms: dict = {}  # device index -> SM count
_tickets: dict = {}  # (device index, stream handle) -> zeroed row counters, left zero by every launch


def _kernel():
    """``(segment_rf_counts, chunk ids)`` of the built library, the entry
    point's ``argtypes`` and ``restype`` set where it is first loaded."""
    global _lib
    if _lib is None:
        lib = _build.load("segment_rf")
        fn = lib.segment_rf_counts
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.segment_rf_chunk_ids.restype = ctypes.c_longlong
        _lib = fn, int(lib.segment_rf_chunk_ids())
    return _lib


def ctas_per_row(rows: int, width: int, sms: int, chunk_ids: int) -> int:
    """CTAs a row gets: enough for ``CTAS_PER_SM`` CTAs an SM over the
    launch, no more than the row has chunks of ``chunk_ids`` ids, at least 1."""
    chunks = max(1, -(-width // chunk_ids))
    return max(1, min(-(-CTAS_PER_SM * sms // rows), chunks))


def segment_distinct_counts_torch(ids_sorted: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the boundary count with tensor ops."""
    prev = torch.nn.functional.pad(ids_sorted[:, :-1], (1, 0), value=-1)
    is_new = (ids_sorted != prev) & (ids_sorted != PAD_ID)
    return is_new.sum(dim=1, dtype=torch.int32)


def segment_distinct_counts(ids_sorted: torch.Tensor) -> torch.Tensor:
    """ids_sorted: ``(C, W)`` int32 rows sorted ascending, PAD_ID padded → ``(C,)`` int32 counts."""
    global launches
    if ids_sorted.dtype != torch.int32 or ids_sorted.dim() != 2:
        raise TypeError(
            f"segment_distinct_counts takes a 2-D int32 tensor, got {ids_sorted.dim()}-D {ids_sorted.dtype}"
        )
    if not ids_sorted.is_contiguous():
        raise ValueError("segment_distinct_counts takes a contiguous tensor")
    if ids_sorted.device.type == "cpu":
        return segment_distinct_counts_torch(ids_sorted)
    if ids_sorted.device.type != "cuda":
        raise ValueError(f"segment_distinct_counts runs on CUDA or CPU tensors, got {ids_sorted.device}")
    c, w = ids_sorted.shape
    if c >= 2**31:
        raise ValueError(f"segment_distinct_counts takes fewer than 2**31 rows, got {c}")
    if c == 0 or w == 0:  # no ids: every count is 0 and there is nothing to launch
        return torch.zeros(c, dtype=torch.int32, device=ids_sorted.device)
    index = ids_sorted.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return segment_distinct_counts(ids_sorted)
    fn, chunk_ids = _kernel()
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    bpr = ctas_per_row(c, w, sms, chunk_ids)  # > 1 only below CTAS_PER_SM · sms rows: c · bpr fits the grid
    stream = torch.cuda.current_stream(index).cuda_stream
    # One allocation: the counts (every one written by the kernel) and, with
    # several CTAs a row, the partials after them.
    buf = torch.empty(c * (1 + bpr) if bpr > 1 else c, dtype=torch.int32, device=ids_sorted.device)
    out, partials, tickets = buf[:c], None, None
    if bpr > 1:
        partials = buf[c:]
        tickets = _tickets.get((index, stream))
        if tickets is None or tickets.numel() < c:  # zeroed on this stream, before the launch
            tickets = _tickets[(index, stream)] = torch.zeros(max(c, 1024), dtype=torch.int32, device=ids_sorted.device)
    err = fn(ids_sorted.data_ptr(), out.data_ptr(), c, w, bpr, None if partials is None else partials.data_ptr(),
             None if tickets is None else tickets.data_ptr(), stream)
    _build.check_launch("segment_rf", err)
    launches += 1
    return out
