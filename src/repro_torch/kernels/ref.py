"""Numpy oracles for the port's kernels (the correctness ground truth).

Transcribed from the JAX package's ``kernels/ref.py`` without jax: the same
loops, the same ``-1e30`` masking and the same f32 math.
"""
from __future__ import annotations

import numpy as np

NEG_INF = -1e30  # the masking value of the attention kernels and their oracles


def segment_distinct_counts_ref(ids_sorted: np.ndarray, pad_id: int) -> np.ndarray:
    """Distinct non-pad values per row (rows need not even be sorted here)."""
    out = np.zeros(ids_sorted.shape[0], dtype=np.int32)
    for i, row in enumerate(np.asarray(ids_sorted)):
        out[i] = np.unique(row[row != pad_id]).shape[0]
    return out


def spmv_blocked_ref(src_local, dst_local, weights, x_windows):
    """y_win[c, v] = Σ_e [dst_local[c,e]==v] · w[c,e] · x_windows[c, src_local[c,e]]."""
    c, w_e = src_local.shape
    w_v = x_windows.shape[1]
    out = np.zeros((c, w_v), dtype=np.float32)
    src = np.asarray(src_local)
    dst = np.asarray(dst_local)
    w = np.asarray(weights)
    x = np.asarray(x_windows)
    for ci in range(c):
        for e in range(w_e):
            s, d = src[ci, e], dst[ci, e]
            if 0 <= s < w_v and 0 <= d < w_v:
                out[ci, d] += w[ci, e] * x[ci, s]
    return out


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def attention_ref(q, k, v, *, scale=None, causal=True, window=None, softcap=None):
    """Dense reference attention, (B, H, S, D) f32 math → f32."""
    b, h, s, d = q.shape
    scale = (d**-0.5) if scale is None else scale
    logits = np.einsum("bhqd,bhkd->bhqk", np.asarray(q, np.float32), np.asarray(k, np.float32)) * np.float32(scale)
    if softcap is not None:
        logits = np.float32(softcap) * np.tanh(logits / np.float32(softcap))
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    mask = np.ones((s, s), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = np.where(mask, logits, np.float32(NEG_INF))
    return np.einsum("bhqk,bhkd->bhqd", _softmax(logits), np.asarray(v, np.float32))


def decode_attention_ref(q, k, v, cache_len, *, scale=None, softcap=None):
    """q (BH, Gq, D), k/v (BH, S, D), cache_len (BH,) → (BH, Gq, D) f32."""
    bh, gq, d = q.shape
    s = k.shape[1]
    scale = (d**-0.5) if scale is None else scale
    logits = np.einsum("bgd,bsd->bgs", np.asarray(q, np.float32), np.asarray(k, np.float32)) * np.float32(scale)
    if softcap is not None:
        logits = np.float32(softcap) * np.tanh(logits / np.float32(softcap))
    mask = np.arange(s)[None, None, :] < np.asarray(cache_len)[:, None, None]
    logits = np.where(mask, logits, np.float32(NEG_INF))
    return np.einsum("bgs,bsd->bgd", _softmax(logits), np.asarray(v, np.float32))
