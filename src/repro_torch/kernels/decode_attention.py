"""Single-token GQA decode attention over a long KV cache, as a CUDA kernel
for the per-tile partials and a plain PyTorch LSE merge.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_partials``, body ``_decode_kernel``) with the hand-written
CUDA kernel ``csrc/decode_attention.cu``, built for ``sm_90a`` and called
through ``ctypes``. ``merge_partials`` was jnp in the JAX package and is plain
PyTorch here.

Shapes: q ``(BHkv, Gq, D)``, k/v ``(BHkv, S, D)`` (f32 or bf16; k and v of one
type), ``cache_len`` ``(BHkv,)`` int32. Partials: o ``(BHkv, nb, Gq, D)``,
m/l ``(BHkv, nb, Gq, 1)``, all f32, with ``nb = S / block_s``. A tile past
``cache_len`` gives ``m = -1e30``, ``l = block_s`` and o the mean of its v, as
on the TPU, so a row with ``cache_len = 0`` decodes to the mean of all of v.
The kernel is built for head dimensions ``HEAD_DIMS``; the wrapper zero-pads
any other D up to 256 to the next of them and drops the padded columns of o.

Dispatch: tensors on the CPU go to the plain version
``decode_attention_partials_torch``; CUDA tensors launch the kernel or raise.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import kernel_operand, padded_head_dim

__all__ = [
    "DEFAULT_BLOCK_S",
    "NEG_INF",
    "decode_attention",
    "decode_attention_partials",
    "decode_attention_partials_torch",
    "launches",
    "merge_partials",
]

NEG_INF = -1e30
DEFAULT_BLOCK_S = 512
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on an H100
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by decode_attention_partials since import (or a reset)


def decode_attention_partials_torch(q, k, v, cache_len, *, scale, block_s, softcap=None):
    """Plain PyTorch version of the partials, in f32 (``block_s`` divides S)."""
    bh, gq, d = q.shape
    s = k.shape[1]
    nb = s // block_s
    kf = k.float().reshape(bh, nb, block_s, d)
    vf = v.float().reshape(bh, nb, block_s, d)
    logits = torch.einsum("bgd,bnsd->bngs", q.float(), kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=k.device).reshape(1, nb, 1, block_s)
    logits = torch.where(pos < cache_len.reshape(bh, 1, 1, 1), logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngs,bnsd->bngd", p, vf) / torch.clamp(l, min=1e-30)
    return o, m, l


def merge_partials(o, m, l, axis: int = 1):
    """LSE-merge partial attention outputs along ``axis`` (tiles or devices).

    o: ``(..., nb, Gq, D)`` normalised partial outputs; m/l: ``(..., nb, Gq, 1)``.
    Returns ``(out, lse)``."""
    m_max = m.amax(dim=axis, keepdim=True)
    w = l * torch.exp(m - m_max)  # un-normalised weight of each tile
    denom = w.sum(dim=axis, keepdim=True)
    out = (o * (w / torch.clamp(denom, min=1e-30))).sum(dim=axis)
    lse = m_max.squeeze(axis) + torch.log(denom.squeeze(axis))
    return out, lse


def _check(q, k, v, cache_len) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"decode attention takes q (BH, Gq, D) and k, v (BH, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if cache_len.shape != (q.shape[0],) or cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be ({q.shape[0]},) int32, got {tuple(cache_len.shape)} {cache_len.dtype}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"decode attention takes f32 or bf16 q and k, v of one such type; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == cache_len.device):
        raise ValueError(f"decode attention: q, k, v, cache_len are on {q.device}, {k.device}, {v.device}, "
                         f"{cache_len.device}")


def decode_attention_partials(q, k, v, cache_len, *, scale=None, block_s: int = DEFAULT_BLOCK_S, softcap=None):
    """Per-tile partials ``(o, m, l)`` of one-token decode attention."""
    global launches
    _check(q, k, v, cache_len)
    bh, gq, d = q.shape
    s = k.shape[1]
    block_s = min(block_s, s)
    if block_s <= 0 or s % block_s:
        raise ValueError(f"cache length {s} must be a multiple of block_s={block_s}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    scale = d**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return decode_attention_partials_torch(q, k, v, cache_len, scale=scale, block_s=block_s, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU tensors, got {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous() and cache_len.is_contiguous()):
        raise ValueError("decode attention takes contiguous q, k, v and cache_len")
    dp = padded_head_dim(d, HEAD_DIMS)
    k, v = kernel_operand(k, dp), kernel_operand(v, dp)  # the kernel reads k and v in 16-byte pieces
    nb = s // block_s
    need = _smem_bytes(k, gq, block_s)
    if need > SMEM_LIMIT:
        raise ValueError(f"Gq={gq} query heads over block_s={block_s} keys need {need} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block has: use a smaller block_s")
    o = torch.empty((bh, nb, gq, dp), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=q.device)
    if o.numel():
        qf = kernel_operand(q.float().contiguous(), dp)  # a cast of the small query, as the TPU kernel's first step
        with torch.cuda.device(q.device):
            _launch(qf, k, v, cache_len, o, m, l, scale, block_s, softcap,
                    torch.cuda.current_stream(q.device).cuda_stream)
        launches += 1
    return (o if dp == d else o[..., :d].contiguous()), m, l


def _smem_bytes(k, gq: int, block_s: int) -> int:
    """Shared memory the kernel needs for ``gq`` heads and ``block_s`` keys a tile."""
    fn = _build.load("decode_attention").decode_attention_smem_bytes
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn(k.shape[2], _DTYPE_CODE[k.dtype], gq, block_s)


def _launch(qf, k, v, cache_len, o, m, l, scale: float, block_s: int, softcap, stream: int) -> None:
    """One launch of the CUDA kernel on ``stream`` (``qf`` is the f32 query); raises if it was refused."""
    fn = _build.load("decode_attention").decode_attention_partials_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bh, gq, d = qf.shape
    err = fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), o.data_ptr(), m.data_ptr(),
             l.data_ptr(), bh, gq, k.shape[1], d, _DTYPE_CODE[k.dtype], block_s, scale,
             0.0 if softcap is None else float(softcap), stream)
    _build.check_launch("decode_attention", err)


def decode_attention(q, k, v, cache_len, **kw):
    """Full decode attention: the partials, then the LSE merge → ``(BHkv, Gq, D)`` f32."""
    o, m, l = decode_attention_partials(q, k, v, cache_len, **kw)
    out, _ = merge_partials(o, m, l, axis=1)
    return out
