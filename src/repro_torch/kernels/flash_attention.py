"""Flash attention (online softmax) with causal masking, sliding windows and
logit soft-capping, as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``) with the hand-written CUDA
source ``csrc/flash_attention.cu``, built for ``sm_90a`` and called through
``ctypes``. q, k and v are ``(B, H, S, D)`` of one type, f32 or bf16, with k
and v already repeated to H heads by the caller (GQA); the softmax is f32 and
the output has the input's type. Masked logits are ``-1e30``, as in the TPU
kernel.

The source holds two kernels, chosen by dtype: bf16 runs on the tensor cores
(``wgmma``, K/V tiles brought in by TMA, P·V as two bf16 products P_hi + P_lo
so that the result stays within one bf16 rounding step of f32); f32 runs on
the CUDA cores, since no tensor-core format keeps an f32 input's accuracy.
Both pick their own tiles and take any sequence length; the JAX kernel's
``block_q``/``block_kv`` have no counterpart. The kernels are built for head
dimensions ``HEAD_DIMS``; the wrapper zero-pads any other D up to 256 to the
next of them (zero columns of q and k add nothing to the logits, the padded
columns of the output are dropped, and the scale stays that of the real D).

Dispatch: tensors on the CPU go to the plain version ``flash_attention_torch``;
CUDA tensors launch the kernel or raise. ``launches`` counts kernel launches,
``tc_launches`` those of the tensor-core kernel among them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_torch", "kernel_operand", "launches", "padded_head_dim",
           "tc_launches"]

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by flash_attention since import (or a reset)
tc_launches = 0  # those of them that ran the tensor-core (bf16) kernel


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


def padded_head_dim(d: int, head_dims=HEAD_DIMS) -> int:
    """The smallest of ``head_dims`` that holds head dimension ``d``; raises
    above the largest."""
    for dp in head_dims:
        if d <= dp:
            return dp
    raise ValueError(f"the CUDA kernel takes head dimensions up to {head_dims[-1]}, got {d}")


def kernel_operand(t: torch.Tensor, dp: int) -> torch.Tensor:
    """Contiguous ``t`` as a kernel reads it: zero-padded along its last axis
    to ``dp`` columns, or copied when its data do not start on a 16-byte
    boundary (TMA and 16-byte loads); else ``t`` itself."""
    if t.shape[-1] != dp:
        return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
    return t.clone() if t.data_ptr() % 16 else t


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
    global launches, tc_launches
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    dp = padded_head_dim(d)
    q, k, v = (kernel_operand(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            _launch(_build.load("flash_attention"), q, k, v, out, scale, causal, window, softcap,
                    torch.cuda.current_stream(q.device).cuda_stream)
        launches += 1
        if q.dtype == torch.bfloat16:
            tc_launches += 1
    return out if dp == d else out[..., :d].contiguous()


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
