"""Public ops over the port's kernels.

* RF of packed CEP chunks through ``segment_rf``. The rows are made on the
  data's device: masked-out slots become ``PAD_ID`` and each chunk's endpoint
  ids are sorted with ``torch.sort`` (a library call, as the JAX package left
  the row sort to XLA). The kernel then counts the distinct ids of every row.
* ``chunked_spmv``: the GAS gather-reduce ``y[dst] += w·x[src]`` over
  GEO-ordered edge chunks through ``edge_spmv``.
* ``flash_attention`` and ``decode_attention``: the attention kernels, as the
  JAX package's ``ops`` exposes them (without its ``interpret`` switch).
"""
from __future__ import annotations

import numpy as np
import torch

from ..compat import PAD_ID, resolve_device
from . import decode_attention as _dec
from . import edge_spmv
from . import flash_attention as _fa
from . import segment_rf

__all__ = [
    "chunk_vertex_counts_packed",
    "chunked_spmv",
    "decode_attention",
    "flash_attention",
    "pack_windows",
    "packed_rows",
    "replication_factor_kernel",
]


def packed_rows(edges: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's input for a pack: edges ``(k, E_max, 2)`` int32 and mask
    ``(k, E_max)`` f32 → ``(k, 2·E_max)`` int32 endpoint ids, each row sorted
    ascending with the masked-out slots as ``PAD_ID`` at its tail."""
    k, e_max, _ = edges.shape
    ids = torch.where(mask[..., None] > 0, edges, PAD_ID).reshape(k, 2 * e_max)
    return torch.sort(ids, dim=1).values


def chunk_vertex_counts_packed(edges: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|V(E_p)| of every row of a pack → ``(k,)`` int64, on the pack's device."""
    return segment_rf.segment_distinct_counts(packed_rows(edges, mask)).to(torch.int64)


def replication_factor_kernel(
    src_ordered: np.ndarray, dst_ordered: np.ndarray, k: int, num_vertices: int, *, device=None
) -> float:
    """RF of the k CEP chunks of an ordered edge list, via the segment_rf kernel.

    Same signature and result as the JAX package's ``ops.replication_factor_kernel``:
    the chunks are packed on ``device`` and their rows counted by the kernel."""
    from ..graphs import engine  # engine imports this module for its own RF measure

    return engine.pack_ordered(src_ordered, dst_ordered, num_vertices, k, device=device).replication_factor


def pack_windows(src, dst, weights, chunk_bounds, window_starts, window_size: int):
    """Host packing of ``chunked_spmv``'s kernel input.

    Edge ``e`` of chunk ``ci`` (ordered ids ``[bounds[ci], bounds[ci+1])``)
    goes to slot ``e - bounds[ci]`` of row ``ci`` with local ids
    ``src[e] - ws``, ``dst[e] - ws`` (``ws = window_starts[ci]``) when both
    lie in ``[0, window_size)``; any other slot holds the padding id
    ``window_size`` and weight 0. Returns numpy ``(src_l, dst_l, wts)``, each
    ``(C, W_E)`` with ``W_E`` the largest chunk, and the ids of the edges that
    fall outside their chunk's window."""
    src, dst = np.asarray(src), np.asarray(dst)
    weights = np.asarray(weights, dtype=np.float32)
    bounds = np.asarray(chunk_bounds, dtype=np.int64)
    starts = np.asarray(window_starts, dtype=np.int64)
    c = starts.shape[0]
    if bounds.shape != (c + 1,) or c == 0:
        raise ValueError(f"{c} window starts need {c + 1} chunk bounds, got {bounds.shape[0]}")
    sizes = np.diff(bounds)
    if (sizes < 0).any() or bounds[0] < 0 or bounds[-1] > src.shape[0]:
        raise ValueError("chunk_bounds must ascend within the edge list")
    if not 0 < window_size < 2**31:
        raise ValueError(f"window_size must be in [1, 2**31), got {window_size}")
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


def chunked_spmv(src, dst, weights, x, chunk_bounds, window_starts, window_size: int, *, device=None) -> torch.Tensor:
    """``y[dst] += w·x[src]`` over GEO-ordered edge chunks via the ``edge_spmv`` kernel.

    Same result as the JAX package's ``ops.chunked_spmv``: each chunk ``ci``
    works on the vertex window ``[ws, ws + window_size)`` of ``x`` (clipped
    at ``V``, each window on its own), its partial window is added back at
    ``ws``, and the edges outside their chunk's window are added in an
    out-of-window pass. ``src``/``dst``/``weights`` are host arrays (the
    packing is host arithmetic); ``x`` is ``(V,)``, a host array or a tensor.
    Returns a ``(V,)`` f32 tensor on ``device``."""
    dev = resolve_device(device)
    src, dst = np.asarray(src), np.asarray(dst)
    weights = np.asarray(weights, dtype=np.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.dim() != 1 or not (src.shape == dst.shape == weights.shape) or src.ndim != 1:
        raise ValueError(f"chunked_spmv takes (E,) src, dst, weights and (V,) x; got {src.shape}, {dst.shape}, "
                         f"{weights.shape}, {tuple(x.shape)}")
    v = x.shape[0]
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= v):
        raise ValueError(f"edge endpoints must be vertex ids in [0, {v})")
    starts = np.asarray(window_starts, dtype=np.int64)
    if ((starts < 0) | (starts > v)).any():
        raise ValueError(f"window starts must lie in [0, {v}]")
    src_l, dst_l, wts, outside = pack_windows(src, dst, weights, chunk_bounds, starts, window_size)

    # Window ci is x[ws : ws + window_size], read from x padded with zeros so
    # that a window past the end of x is clipped at V.
    x_pad = torch.cat([x, x.new_zeros(window_size)])
    starts_t = torch.from_numpy(starts).to(dev)
    x_win = x_pad.unfold(0, window_size, 1)[starts_t]
    y_win = edge_spmv.spmv_blocked(
        torch.from_numpy(src_l).to(dev), torch.from_numpy(dst_l).to(dev), torch.from_numpy(wts).to(dev), x_win
    )
    # Each window is added back at its start, all in one index_add_; what
    # falls past V lands in the padding and is dropped.
    y = torch.zeros(v + window_size, dtype=torch.float32, device=dev)
    y.index_add_(0, (starts_t[:, None] + torch.arange(window_size, device=dev)).reshape(-1), y_win.reshape(-1))
    # Out-of-window pass: the edges whose endpoints leave their chunk's window
    # are part of the function's own semantics, added here on the device.
    if outside.size:
        s_out = torch.from_numpy(src[outside].astype(np.int64)).to(dev)
        d_out = torch.from_numpy(dst[outside].astype(np.int64)).to(dev)
        y.index_add_(0, d_out, torch.from_numpy(weights[outside]).to(dev) * x[s_out])
    return y[:v]


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Flash attention over ``(B, H, S, D)`` q, k, v (see ``kernels.flash_attention``)."""
    return _fa.flash_attention(q, k, v, **kw)


def decode_attention(q, k, v, cache_len, **kw) -> torch.Tensor:
    """One-token decode attention: kernel partials + LSE merge (see ``kernels.decode_attention``)."""
    return _dec.decode_attention(q, k, v, cache_len, **kw)
