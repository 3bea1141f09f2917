"""Blocked edge-centric gather-reduce (vertex-cut SpMV), as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/edge_spmv.py``
(``spmv_blocked``, body ``_spmv_kernel``) with the hand-written CUDA kernel
``csrc/edge_spmv.cu``, built for ``sm_90a`` and called through ``ctypes``.

Per chunk ``c``: ``y_win[c, v] = Σ_e [dst_l[c, e] == v] · w[c, e] ·
x_win[c, src_l[c, e]]``. An edge whose local ids are not both in
``[0, W_V)`` adds exactly 0; the caller pads empty slots with ``W_V``.

Inputs: ``src_local``/``dst_local`` ``(C, W_E)`` int32, ``weights`` ``(C, W_E)``
f32, ``x_windows`` ``(C, W_V)`` f32. Output ``(C, W_V)`` f32. The kernel walks
the chunks one after another (so that the rows it scatters into stay in L2)
and adds each run of equal dst within a warp's slots with one atomic, so its
f32 sums run in an order that changes from run to run.

Dispatch: a tensor on the CPU goes to the plain version ``spmv_blocked_torch``;
CUDA tensors launch the kernel or raise. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["launches", "spmv_blocked", "spmv_blocked_torch"]

launches = 0  # kernel launches by spmv_blocked since import (or a reset)


def spmv_blocked_torch(src_local, dst_local, weights, x_windows) -> torch.Tensor:
    """Plain PyTorch version: a gather, then ``index_add_`` on the flat output."""
    c, w_v = x_windows.shape
    valid = (src_local >= 0) & (src_local < w_v) & (dst_local >= 0) & (dst_local < w_v)
    rows = torch.arange(c, device=x_windows.device, dtype=torch.int64)[:, None].expand_as(src_local)[valid]
    vals = weights[valid] * x_windows[rows, src_local[valid].long()]
    out = torch.zeros(c * w_v, dtype=torch.float32, device=x_windows.device)
    out.index_add_(0, rows * w_v + dst_local[valid].long(), vals)
    return out.reshape(c, w_v)


def _check(src_local, dst_local, weights, x_windows) -> None:
    for name, t, dtype in (("src_local", src_local, torch.int32), ("dst_local", dst_local, torch.int32),
                           ("weights", weights, torch.float32), ("x_windows", x_windows, torch.float32)):
        if t.dtype != dtype or t.dim() != 2:
            raise TypeError(f"spmv_blocked: {name} must be a 2-D {dtype} tensor, got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spmv_blocked: {name} must be contiguous")
        if t.device != x_windows.device:
            raise ValueError(f"spmv_blocked: {name} is on {t.device}, x_windows on {x_windows.device}")
    if not (src_local.shape == dst_local.shape == weights.shape) or src_local.shape[0] != x_windows.shape[0]:
        raise ValueError(
            "spmv_blocked takes src_local, dst_local, weights of one shape (C, W_E) and x_windows (C, W_V); got "
            f"{tuple(src_local.shape)}, {tuple(dst_local.shape)}, {tuple(weights.shape)}, {tuple(x_windows.shape)}"
        )


def spmv_blocked(src_local, dst_local, weights, x_windows) -> torch.Tensor:
    """Per-chunk gather-reduce → ``(C, W_V)`` f32 partial y windows."""
    global launches
    _check(src_local, dst_local, weights, x_windows)
    dev = x_windows.device
    if dev.type == "cpu":
        return spmv_blocked_torch(src_local, dst_local, weights, x_windows)
    if dev.type != "cuda":
        raise ValueError(f"spmv_blocked runs on CUDA or CPU tensors, got {dev}")
    c, w_e = src_local.shape
    w_v = x_windows.shape[1]
    if c >= 2**31 or w_v >= 2**31:
        raise ValueError(f"spmv_blocked takes fewer than 2**31 chunks and window ids, got C={c}, W_V={w_v}")
    out = torch.zeros((c, w_v), dtype=torch.float32, device=dev)
    if c == 0 or w_e == 0 or w_v == 0:
        return out  # no edges or no window: every sum is 0 and there is nothing to launch
    with torch.cuda.device(dev):
        _launch(src_local, dst_local, weights, x_windows, out, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


def _launch(src_local, dst_local, weights, x_windows, out, stream: int) -> None:
    """One launch of the CUDA kernel on ``stream``; raises if it was refused."""
    fn = _build.load("edge_spmv").edge_spmv_blocked
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    (c, w_e), w_v = src_local.shape, x_windows.shape[1]
    err = fn(src_local.data_ptr(), dst_local.data_ptr(), weights.data_ptr(), x_windows.data_ptr(), out.data_ptr(),
             c, w_e, w_v, stream)
    _build.check_launch("edge_spmv", err)
