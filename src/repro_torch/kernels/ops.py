"""Public ops over the port's kernels.

* RF of packed CEP chunks through ``segment_rf``. The rows are made on the
  data's device by ``packed_sort``: each chunk's valid endpoint ids sorted
  over the bits below ``num_vertices``, ``PAD_ID`` at the tail (on a card one
  hand-written radix sort, where the JAX package left the row sort to XLA).
  ``segment_rf`` then counts the distinct ids of every row.
* ``chunked_spmv``: the GAS gather-reduce ``y[dst] += w·x[src]`` over
  GEO-ordered edge chunks through ``edge_spmv``, with the chunks packed into
  windows on the device (``pack_windows_device``; the numpy ``pack_windows``
  is its host oracle).
* ``flash_attention`` and ``decode_attention``: the attention kernels, as the
  JAX package's ``ops`` exposes them (without its ``interpret`` switch).
"""
from __future__ import annotations

import numpy as np
import torch

from ..compat import resolve_device
from . import decode_attention as _dec
from . import edge_spmv
from . import flash_attention as _fa
from . import packed_sort, segment_rf

__all__ = [
    "chunk_vertex_counts_packed",
    "chunked_spmv",
    "decode_attention",
    "flash_attention",
    "pack_windows",
    "pack_windows_device",
    "packed_rows",
    "replication_factor_kernel",
]


def packed_rows(edges: torch.Tensor, mask: torch.Tensor, num_vertices: int | None = None) -> torch.Tensor:
    """The kernel's input for a pack: edges ``(k, E_max, 2)`` int32 and mask
    ``(k, E_max)`` f32 → ``(k, 2·E_max)`` int32 endpoint ids, each row sorted
    ascending with the masked-out slots as ``PAD_ID`` at its tail. Valid ids
    lie in ``[0, num_vertices)`` (``None``: any id that is not negative)."""
    return packed_sort.packed_sort(edges, mask, num_vertices)


def chunk_vertex_counts_packed(edges: torch.Tensor, mask: torch.Tensor,
                               num_vertices: int | None = None) -> torch.Tensor:
    """|V(E_p)| of every row of a pack → ``(k,)`` int64, on the pack's device."""
    return segment_rf.segment_distinct_counts(packed_rows(edges, mask, num_vertices)).to(torch.int64)


def replication_factor_kernel(
    src_ordered: np.ndarray, dst_ordered: np.ndarray, k: int, num_vertices: int, *, device=None
) -> float:
    """RF of the k CEP chunks of an ordered edge list, via the segment_rf kernel.

    Same signature and result as the JAX package's ``ops.replication_factor_kernel``:
    the chunks are packed on ``device`` and their rows counted by the kernel."""
    from ..graphs import engine  # engine imports this module for its own RF measure

    return engine.pack_ordered(src_ordered, dst_ordered, num_vertices, k, device=device).replication_factor


def _window_layout(chunk_bounds, window_starts, window_size: int, num_edges: int):
    """The chunk bounds and window starts as int64 arrays, and each chunk's
    size; raises unless they describe windows over an edge list of
    ``num_edges``."""
    bounds = np.asarray(chunk_bounds, dtype=np.int64)
    starts = np.asarray(window_starts, dtype=np.int64)
    c = starts.shape[0]
    if bounds.shape != (c + 1,) or c == 0:
        raise ValueError(f"{c} window starts need {c + 1} chunk bounds, got {bounds.shape[0]}")
    sizes = np.diff(bounds)
    if (sizes < 0).any() or bounds[0] < 0 or bounds[-1] > num_edges:
        raise ValueError("chunk_bounds must ascend within the edge list")
    if not 0 < window_size < 2**31:
        raise ValueError(f"window_size must be in [1, 2**31), got {window_size}")
    return bounds, starts, sizes


def pack_windows(src, dst, weights, chunk_bounds, window_starts, window_size: int):
    """Host packing of ``chunked_spmv``'s kernel input (the oracle of
    ``pack_windows_device``, which ``chunked_spmv`` runs).

    Edge ``e`` of chunk ``ci`` (ordered ids ``[bounds[ci], bounds[ci+1])``)
    goes to slot ``e - bounds[ci]`` of row ``ci`` with local ids
    ``src[e] - ws``, ``dst[e] - ws`` (``ws = window_starts[ci]``) when both
    lie in ``[0, window_size)``; any other slot holds the padding id
    ``window_size`` and weight 0. Returns numpy ``(src_l, dst_l, wts)``, each
    ``(C, W_E)`` with ``W_E`` the largest chunk, and the ids of the edges that
    fall outside their chunk's window."""
    src, dst = np.asarray(src), np.asarray(dst)
    weights = np.asarray(weights, dtype=np.float32)
    bounds, starts, sizes = _window_layout(chunk_bounds, window_starts, window_size, src.shape[0])
    c = starts.shape[0]
    edge = np.arange(bounds[0], bounds[-1])
    chunk = np.repeat(np.arange(c), sizes)
    slot = edge - bounds[chunk]
    sl = src[edge].astype(np.int64) - starts[chunk]
    dl = dst[edge].astype(np.int64) - starts[chunk]
    inside = (sl >= 0) & (sl < window_size) & (dl >= 0) & (dl < window_size)
    w_e = int(sizes.max())
    src_l = np.full((c, w_e), window_size, dtype=np.int32)
    dst_l = np.full((c, w_e), window_size, dtype=np.int32)
    wts = np.zeros((c, w_e), dtype=np.float32)
    rows, cols = chunk[inside], slot[inside]
    src_l[rows, cols] = sl[inside]
    dst_l[rows, cols] = dl[inside]
    wts[rows, cols] = weights[edge[inside]]
    return src_l, dst_l, wts, edge[~inside]


def pack_windows_device(src, dst, weights, chunk_bounds, window_starts, window_size: int, *, device=None):
    """``pack_windows`` computed with torch ops on ``device``.

    ``src``/``dst``/``weights`` are ``(E,)`` host arrays or tensors (a tensor
    already on ``device`` is not copied); the bounds and starts are short host
    sequences. Returns ``(src_l, dst_l, wts, outside)`` on ``device``: int32,
    int32 and f32 ``(C, W_E)`` tensors and the int64 ids of the edges outside
    their chunk's window, ascending; byte-equal to ``pack_windows``."""
    dev = resolve_device(device)
    src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    weights = torch.as_tensor(weights, device=dev).to(torch.float32)
    bounds, starts, sizes = _window_layout(chunk_bounds, window_starts, window_size, src.shape[0])
    c = starts.shape[0]
    b0, b1, w_e = int(bounds[0]), int(bounds[-1]), int(sizes.max())
    bounds_t, starts_t = torch.from_numpy(bounds).to(dev), torch.from_numpy(starts).to(dev)
    chunk = torch.repeat_interleave(torch.arange(c, device=dev), torch.from_numpy(sizes).to(dev), output_size=b1 - b0)
    edge = torch.arange(b0, b1, device=dev)
    ws = starts_t[chunk]
    sl = src[b0:b1].long() - ws
    dl = dst[b0:b1].long() - ws
    inside = (sl >= 0) & (sl < window_size) & (dl >= 0) & (dl < window_size)
    # Every edge owns one slot, so writing each edge's slot, its ids or the
    # padding, leaves the same bytes as writing only the edges inside.
    slots = (chunk * w_e + edge - bounds_t[chunk],)
    src_l = torch.full((c * w_e,), window_size, dtype=torch.int32, device=dev)
    dst_l = torch.full((c * w_e,), window_size, dtype=torch.int32, device=dev)
    wts = torch.zeros(c * w_e, dtype=torch.float32, device=dev)
    src_l.index_put_(slots, torch.where(inside, sl, window_size).to(torch.int32))
    dst_l.index_put_(slots, torch.where(inside, dl, window_size).to(torch.int32))
    wts.index_put_(slots, torch.where(inside, weights[b0:b1], 0.0))
    return src_l.view(c, w_e), dst_l.view(c, w_e), wts.view(c, w_e), edge[~inside]


def _edges_to_device(src, dst, weights, num_vertices: int, dev: torch.device):
    """The ``(E,)`` edge arrays on ``dev``, copied once; raises unless every
    endpoint is a vertex id in ``[0, num_vertices)`` (one sync)."""
    src, dst = np.asarray(src), np.asarray(dst)
    weights = np.asarray(weights, dtype=np.float32)
    if not (src.shape == dst.shape == weights.shape) or src.ndim != 1:
        raise ValueError(f"chunked_spmv takes (E,) src, dst and weights; got {src.shape}, {dst.shape}, {weights.shape}")
    src_t, dst_t = (torch.from_numpy(a if a.dtype in (np.int32, np.int64) else a.astype(np.int64)).to(dev)
                    for a in (src, dst))
    w_t = torch.from_numpy(weights).to(dev)
    if src_t.numel():
        lo_s, hi_s = torch.aminmax(src_t)
        lo_d, hi_d = torch.aminmax(dst_t)
        if bool((torch.minimum(lo_s, lo_d) < 0) | (torch.maximum(hi_s, hi_d) >= num_vertices)):
            raise ValueError(f"edge endpoints must be vertex ids in [0, {num_vertices})")
    return src_t, dst_t, w_t


def _x_windows(x: torch.Tensor, starts: np.ndarray, window_size: int) -> torch.Tensor:
    """``(C, window_size)`` rows ``x[ws : ws + window_size]``, read from x padded
    with zeros so that a window past the end of x is clipped at V."""
    x_pad = torch.cat([x, x.new_zeros(window_size)])
    return x_pad.unfold(0, window_size, 1)[torch.from_numpy(starts).to(x.device)]


def _add_back(y_win: torch.Tensor, starts: np.ndarray, num_vertices: int) -> torch.Tensor:
    """``(V + W,)`` f32: each window row added back at its start. The rows that
    share a start are summed first, each run of consecutive such rows as one
    reduction over a view (no copy of ``y_win``); then one slice add per
    distinct start. What falls past V lands in the padding and is dropped by
    the caller."""
    w = y_win.shape[1]
    y = torch.zeros(num_vertices + w, dtype=torch.float32, device=y_win.device)
    cuts = [0, *(np.flatnonzero(np.diff(starts)) + 1).tolist(), len(starts)]
    sums: dict = {}
    for a, b in zip(cuts[:-1], cuts[1:]):
        part = y_win[a] if b - a == 1 else y_win[a:b].sum(0)
        ws = int(starts[a])
        sums[ws] = sums[ws] + part if ws in sums else part
    for ws, part in sums.items():
        y[ws:ws + w] += part
    return y


def _add_outside(y, src_t, dst_t, w_t, x, outside) -> None:
    """The out-of-window pass: ``y[dst] += w·x[src]`` over the ``outside``
    edges, which are part of the function's own semantics."""
    if outside.numel():
        y.index_add_(0, dst_t[outside].long(), w_t[outside] * x[src_t[outside].long()])


def chunked_spmv(src, dst, weights, x, chunk_bounds, window_starts, window_size: int, *, device=None) -> torch.Tensor:
    """``y[dst] += w·x[src]`` over GEO-ordered edge chunks via the ``edge_spmv`` kernel.

    Same result as the JAX package's ``ops.chunked_spmv``: each chunk ``ci``
    works on the vertex window ``[ws, ws + window_size)`` of ``x`` (clipped
    at ``V``, each window on its own), its partial window is added back at
    ``ws``, and the edges outside their chunk's window are added in an
    out-of-window pass. ``src``/``dst``/``weights`` are ``(E,)`` host arrays,
    copied to ``device`` once and packed there (``pack_windows_device``);
    ``x`` is ``(V,)``, a host array or a tensor. Returns a ``(V,)`` f32 tensor
    on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.dim() != 1:
        raise ValueError(f"chunked_spmv takes a (V,) x, got {tuple(x.shape)}")
    v = x.shape[0]
    src_t, dst_t, w_t = _edges_to_device(src, dst, weights, v, dev)
    starts = np.asarray(window_starts, dtype=np.int64)
    if ((starts < 0) | (starts > v)).any():
        raise ValueError(f"window starts must lie in [0, {v}]")
    src_l, dst_l, wts, outside = pack_windows_device(src_t, dst_t, w_t, chunk_bounds, starts, window_size, device=dev)
    y_win = edge_spmv.spmv_blocked(src_l, dst_l, wts, _x_windows(x, starts, window_size))
    y = _add_back(y_win, starts, v)
    _add_outside(y, src_t, dst_t, w_t, x, outside)
    return y[:v]


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Flash attention over ``(B, H, S, D)`` q, k, v (see ``kernels.flash_attention``)."""
    return _fa.flash_attention(q, k, v, **kw)


def decode_attention(q, k, v, cache_len, **kw) -> torch.Tensor:
    """One-token decode attention: kernel partials + LSE merge (see ``kernels.decode_attention``)."""
    return _dec.decode_attention(q, k, v, cache_len, **kw)
