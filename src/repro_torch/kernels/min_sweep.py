"""One Jacobi min-sweep of SSSP or WCC over the edge pack, as one CUDA kernel.

Replaces no ``pl.pallas_call``. It is the port's counterpart of the JAX
package's per-sweep scatters ``cand.at[e[:, 1]].min(...)`` and
``cand.at[e[:, 0]].min(...)`` (``repro/graphs/engine.py`` lines 434-435 for
SSSP, 466-467 for WCC), as the hand-written CUDA kernel ``csrc/min_sweep.cu``,
built for ``sm_90a`` and called through ``ctypes``.

``min_sweep(edges, mask, x, step)`` gives ``(nx, flags)``: ``nx = min(x,
min over the neighbours of x[nbr] + step)`` over the slots with ``mask > 0``
of the ``(k, E_max, 2)`` int32 pack, each edge both ways, and a 0-d int32
``flags`` on x's device whose bit 0 says that some candidate fell below its
target's x. ``changed(flags)`` reads it on the host. x must hold no NaN.

The kernel is bound by bytes: 12 bytes a slot (8 of endpoints, 4 of mask)
read once, x read and nx written once, so ``(12·S + 8·V) / 3.35e12`` s is the
least time an H100 could take for S slots and V vertices: 0.24 ms at
graph500-22. It reads the int32 pack in place with 16-byte streaming loads
(on a card, ``edges`` must start on a 16-byte and ``mask`` on an 8-byte
boundary, as every fresh allocation does), gathers x for the valid slots
only, drops every candidate not below its target's x, and then every one not
below nx[target] as read from L2, before any atomic, and lowers nx with the
native integer atomic min on the float's bits, not a compare-and-swap loop
(see the source's note).

Dispatch: a pack on the CPU goes to the plain version ``min_sweep_torch`` (two
gathers and two ``scatter_reduce_`` amin); a CUDA pack launches the kernel or
raises. ``launches`` counts kernel launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["BYTES_PER_SLOT", "changed", "launches", "min_sweep", "min_sweep_torch", "sweep_bytes"]

launches = 0  # kernel launches by min_sweep since import (or a reset)
BYTES_PER_SLOT = 12  # 8 B of int32 endpoints and 4 B of f32 mask, read once
CHANGED, BAD_ID = 1, 2  # bits of the flags word (csrc/min_sweep.cu kChanged, kBadId)
_fn = None  # min_sweep with its ctypes signature set once


def sweep_bytes(slots: int, num_vertices: int) -> int:
    """The bytes one sweep must move: every slot read once, x read and nx written once."""
    return BYTES_PER_SLOT * int(slots) + 8 * int(num_vertices)


def min_sweep_torch(edges: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, step: float) -> tuple:
    """Plain PyTorch version: both directions' candidates gathered, masked to
    +inf where the slot is empty, and scattered with ``scatter_reduce_`` amin."""
    e = edges.reshape(-1, 2).long()
    src, dst = e[:, 0], e[:, 1]
    valid = mask.reshape(-1) > 0
    inf = float("inf")
    cand = torch.full_like(x, inf)
    cand.scatter_reduce_(0, dst, torch.where(valid, x[src] + step, inf), "amin")
    cand.scatter_reduce_(0, src, torch.where(valid, x[dst] + step, inf), "amin")
    nx = torch.minimum(x, cand)
    return nx, (nx < x).any().to(torch.int32)


def _check(edges: torch.Tensor, mask: torch.Tensor, x: torch.Tensor) -> None:
    for name, t, dtype, dim in (("edges", edges, torch.int32, 3), ("mask", mask, torch.float32, 2),
                                ("x", x, torch.float32, 1)):
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"min_sweep: {name} must be a {dim}-D {dtype} tensor, got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"min_sweep: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"min_sweep: {name} is on {t.device}, x on {x.device}")
    if x.device.type == "cuda" and (edges.data_ptr() % 16 or mask.data_ptr() % 8):
        raise ValueError("min_sweep: on a card, edges must start on a 16-byte and mask on an 8-byte boundary")
    if edges.shape[2] != 2 or tuple(mask.shape) != tuple(edges.shape[:2]):
        raise ValueError(f"min_sweep takes edges (k, E_max, 2) and mask (k, E_max); got {tuple(edges.shape)}, "
                         f"{tuple(mask.shape)}")


def changed(flags: torch.Tensor) -> bool:
    """The stop flag read on the host: whether some candidate fell below its
    target's x. Raises where a slot with mask > 0 held an id outside [0, V)."""
    f = int(flags)
    if f & BAD_ID:
        raise ValueError("min_sweep: a slot with mask > 0 holds a vertex id outside [0, num_vertices)")
    return bool(f & CHANGED)


def min_sweep(edges: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, step: float) -> tuple:
    """One sweep over the pack → ``(nx, flags)``, both on x's device."""
    global launches
    _check(edges, mask, x)
    dev = x.device
    if dev.type == "cpu":
        return min_sweep_torch(edges, mask, x, step)
    if dev.type != "cuda":
        raise ValueError(f"min_sweep runs on CUDA or CPU tensors, got {dev}")
    v, slots = x.numel(), edges.shape[0] * edges.shape[1]
    if v >= 2**31:
        raise ValueError(f"min_sweep takes fewer than 2**31 vertices, got {v}")
    if slots == 0:  # no edge: nothing can lower x, and there is nothing to launch
        return x.clone(), torch.zeros((), dtype=torch.int32, device=dev)
    nx = torch.empty_like(x)
    flags = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(edges, mask, x, nx, flags, step, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return nx, flags


def _launch(edges, mask, x, nx, flags, step: float, stream: int) -> None:
    """Copy x to nx, zero the flags and launch the sweep on ``stream``; raises
    if the launch was refused."""
    global _fn
    if _fn is None:
        fn = _build.load("min_sweep").min_sweep
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    err = _fn(edges.data_ptr(), mask.data_ptr(), x.data_ptr(), nx.data_ptr(), flags.data_ptr(),
              edges.shape[0] * edges.shape[1], x.numel(), float(step), stream)
    _build.check_launch("min_sweep", err)
