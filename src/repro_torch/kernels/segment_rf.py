"""Per-row distinct-id counting: the replication-factor measure, as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/segment_rf.py``
(``segment_distinct_counts``, body ``_segment_rf_kernel``) with the
hand-written CUDA kernel ``csrc/segment_rf.cu``, built for ``sm_90a`` and
called through ``ctypes``.

Input: a ``(C, W)`` int32 tensor, each row sorted ascending and padded at the
tail with ``PAD_ID`` (int32 max). Output: ``(C,)`` int32, the number of
positions with ``ids[i] != ids[i-1]`` and ``ids[i] != PAD_ID`` (``ids[-1]``
taken as -1) — each row's distinct-id count.

The kernel is bound by memory: it reads ``C·W·4`` bytes once, so
``C·W·4 / 3.35e12`` s is the least time an H100 could take for the same work.

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

__all__ = ["PAD_ID", "launches", "segment_distinct_counts", "segment_distinct_counts_torch"]

launches = 0  # kernel launches by segment_distinct_counts since import (or a reset)


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
    out = torch.zeros(c, dtype=torch.int32, device=ids_sorted.device)
    if c == 0 or w == 0:
        return out  # no ids: every count is 0 and there is nothing to launch
    fn = _build.load("segment_rf").segment_rf_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(ids_sorted.device):
        stream = torch.cuda.current_stream(ids_sorted.device).cuda_stream
        err = fn(ids_sorted.data_ptr(), out.data_ptr(), c, w, stream)
    _build.check_launch("segment_rf", err)
    launches += 1
    return out
