"""Single-token GQA decode attention over a long KV cache, as flash-decoding on
the GPU: a split-K CUDA kernel over the valid part of the cache and a CUDA
combine kernel.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_partials``, body ``_decode_kernel``) and, on the merged
path, its jnp ``merge_partials`` with the hand-written CUDA source
``csrc/decode_attention.cu``, built for ``sm_90a`` and called through
``ctypes``. ``merge_partials`` stays in plain PyTorch, for the CPU and for
callers who merge partials across devices.

Shapes: q ``(BHkv, Gq, D)``, k/v ``(BHkv, S, D)`` (f32 or bf16; k and v of one
type), ``cache_len`` ``(BHkv,)`` int32. Partials: o ``(BHkv, nb, Gq, D)``,
m/l ``(BHkv, nb, Gq, 1)``, all f32, with ``nb = S / block_s``. A tile past
``cache_len`` gives ``m = -1e30``, ``l = block_s`` and o the mean of its v, as
on the TPU, so a row with ``cache_len = 0`` decodes to the mean of all of v.

``decode_attention`` on the card splits each row's keys below ``cache_len``
into ``SPLIT``-key pieces; a piece past ``cache_len`` is neither read nor
merged (its weight in the reference's merge is exactly 0), and the combine
kernel merges the pieces as ``merge_partials`` does. There ``block_s`` is
only checked, as on the partials entry point: it does not change what is
computed. ``decode_attention_partials`` runs the same split kernel with one
split per ``block_s`` tile, every tile written.

The kernels are built for head dimensions ``HEAD_DIMS``; the wrapper
zero-pads K and V of any other D up to 256 to the next of them and the
kernels drop the padded columns. q is read as it is, in f32 or bf16.

Dispatch: tensors on the CPU go to the plain versions
(``decode_attention_partials_torch``, then ``merge_partials``); CUDA tensors
launch the kernels or raise. ``launches`` counts launches of the split
kernel, ``merge_launches`` those of the combine kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import kernel_operand, padded_head_dim

__all__ = [
    "DEFAULT_BLOCK_S",
    "NEG_INF",
    "SPLIT",
    "decode_attention",
    "decode_attention_partials",
    "decode_attention_partials_torch",
    "launches",
    "merge_launches",
    "merge_partials",
]

NEG_INF = -1e30
DEFAULT_BLOCK_S = 512
SPLIT = 1024  # keys of one work item of the merged path: a power of two, a multiple of every key tile
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on an H100
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # split-kernel launches by both entry points since import (or a reset)
merge_launches = 0  # combine-kernel launches by decode_attention since import (or a reset)


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


def _prepare(q, k, v, cache_len, scale, block_s: int, softcap):
    """The checks both entry points share; returns ``(scale, block_s)``."""
    _check(q, k, v, cache_len)
    s = k.shape[1]
    block_s = min(block_s, s)
    if block_s <= 0 or s % block_s:
        raise ValueError(f"cache length {s} must be a multiple of block_s={block_s}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return (q.shape[2] ** -0.5 if scale is None else float(scale)), block_s


def _card_operands(q, k, v, cache_len, block_s: int):
    """The CUDA checks both entry points share; returns ``(k, v, dp)``, with
    k and v as the kernel reads them (padded to ``dp`` columns, 16-byte
    aligned). The (Gq, block_s) f32 scores of one tile, which the reference
    holds whole, must fit one block's shared memory, as since the first CUDA
    kernel."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU tensors, got {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous() and cache_len.is_contiguous()):
        raise ValueError("decode attention takes contiguous q, k, v and cache_len")
    if 4 * q.shape[1] * block_s > SMEM_LIMIT:
        raise ValueError(f"the scores of Gq={q.shape[1]} query heads over block_s={block_s} keys need "
                         f"{4 * q.shape[1] * block_s} bytes of shared memory, more than the {SMEM_LIMIT} a block "
                         "has: use a smaller block_s")
    dp = padded_head_dim(q.shape[2], HEAD_DIMS)
    return kernel_operand(k, dp), kernel_operand(v, dp), dp


def decode_attention_partials(q, k, v, cache_len, *, scale=None, block_s: int = DEFAULT_BLOCK_S, softcap=None):
    """Per-tile partials ``(o, m, l)`` of one-token decode attention."""
    global launches
    scale, block_s = _prepare(q, k, v, cache_len, scale, block_s, softcap)
    if q.device.type == "cpu":
        return decode_attention_partials_torch(q, k, v, cache_len, scale=scale, block_s=block_s, softcap=softcap)
    k, v, dp = _card_operands(q, k, v, cache_len, block_s)
    bh, gq, d = q.shape
    nb = k.shape[1] // block_s
    o = torch.empty((bh, nb, gq, dp), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=q.device)
    if o.numel():
        with torch.cuda.device(q.device):
            _launch_split(q, k, v, cache_len, o, m, l, scale, block_s, softcap, True,
                          torch.cuda.current_stream(q.device).cuda_stream)
        launches += 1
    return (o if dp == d else o[..., :d].contiguous()), m, l


def decode_attention(q, k, v, cache_len, *, scale=None, block_s: int = DEFAULT_BLOCK_S, softcap=None):
    """Full decode attention → ``(BHkv, Gq, D)`` f32: on the CPU the partials,
    then ``merge_partials``; on the card the split kernel over the keys below
    ``cache_len``, then the combine kernel."""
    global launches, merge_launches
    scale, block_s = _prepare(q, k, v, cache_len, scale, block_s, softcap)
    if q.device.type == "cpu":
        o, m, l = decode_attention_partials_torch(q, k, v, cache_len, scale=scale, block_s=block_s, softcap=softcap)
        return merge_partials(o, m, l, axis=1)[0]
    k, v, dp = _card_operands(q, k, v, cache_len, block_s)
    bh, gq, d = q.shape
    nsplit = -(-k.shape[1] // SPLIT)
    o = torch.empty((bh, nsplit, gq, dp), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, nsplit, gq), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, nsplit, gq), dtype=torch.float32, device=q.device)
    out = torch.empty((bh, gq, d), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _launch_split(q, k, v, cache_len, o, m, l, scale, SPLIT, softcap, False, stream)
            launches += 1
            _launch_merge(o, m, l, cache_len, out, k.shape[1], SPLIT, stream)
            merge_launches += 1
    return out


def _launch_split(q, k, v, cache_len, o, m, l, scale: float, split: int, softcap, every_split: bool,
                  stream: int) -> None:
    """One launch of the split kernel on ``stream``; raises if it was refused."""
    fn = _build.load("decode_attention").decode_attention_split_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bh, gq, dq = q.shape
    err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], dq, k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), bh, gq, k.shape[1], k.shape[2], _DTYPE_CODE[k.dtype], split,
             int(every_split), scale, 0.0 if softcap is None else float(softcap), stream)
    _build.check_launch("decode_attention", err)


def _launch_merge(o, m, l, cache_len, out, s_len: int, split: int, stream: int) -> None:
    """One launch of the combine kernel on ``stream``; raises if it was refused."""
    fn = _build.load("decode_attention").decode_attention_merge_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bh, _, gq, dp = o.shape
    err = fn(o.data_ptr(), m.data_ptr(), l.data_ptr(), cache_len.data_ptr(), out.data_ptr(), bh, gq, s_len, dp,
             split, out.shape[2], stream)
    _build.check_launch("decode_attention", err)
