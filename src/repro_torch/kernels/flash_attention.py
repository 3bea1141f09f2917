"""Flash attention (online softmax) with causal masking, sliding windows and
logit soft-capping, as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``) with the hand-written CUDA
kernel ``csrc/flash_attention.cu``, built for ``sm_90a`` and called through
``ctypes``. q, k and v are ``(B, H, S, D)`` of one type, f32 or bf16, with k
and v already repeated to H heads by the caller (GQA); the math is f32 and the
output has the input's type. Masked logits are ``-1e30``, as in the TPU kernel.

The CUDA kernel picks its own tiles (64 query rows, 32 keys) and takes any
sequence length; the JAX kernel's ``block_q``/``block_kv`` have no
counterpart.

Dispatch: tensors on the CPU go to the plain version ``flash_attention_torch``;
CUDA tensors launch the kernel or raise. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_torch", "launches"]

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by flash_attention since import (or a reset)


def flash_attention_torch(q, k, v, *, scale=None, causal=True, window=None, softcap=None) -> torch.Tensor:
    """Plain PyTorch version: dense attention in f32, as the numpy oracle."""
    s, d = q.shape[-2:]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """q, k, v ``(B, H, S, D)`` → ``(B, H, S, D)`` in ``q.dtype``."""
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape (B, H, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v are on {q.device}, {k.device}, {v.device}")
    b, h, s, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1 (a row sees its own key), got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    scale = d**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dimensions {HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _launch(_build.load("flash_attention"), q, k, v, out, scale, causal, window, softcap,
                torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return out


def _launch(lib: ctypes.CDLL, q, k, v, out, scale: float, causal: bool, window, softcap, stream: int) -> None:
    """One launch of the CUDA kernel in library ``lib`` on ``stream``; raises
    if it was refused."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, h, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, d, _DTYPE_CODE[q.dtype], scale,
             int(causal), 0 if window is None else int(window), 0.0 if softcap is None else float(softcap), stream)
    _build.check_launch("flash_attention", err)
