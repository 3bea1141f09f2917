"""Partition-quality metrics — paper §2.2 / §6.4.

All metrics operate on an *edge-id partition assignment* or on an ordered edge
list + chunk bounds, using vectorized numpy. These are the host oracle: the
packed engine buffers measure the same counts on the GPU through the CUDA
``segment_rf`` kernel (kernels/ops.py ``chunk_vertex_counts_packed``).
"""
from __future__ import annotations

import numpy as np

from . import cep

__all__ = [
    "partition_vertex_counts",
    "chunk_vertex_counts_ordered",
    "replication_factor",
    "replication_factor_ordered",
    "edge_balance",
    "vertex_balance",
    "mirror_count",
    "mirror_count_ordered",
    "comm_volume_bytes",
]


def partition_vertex_counts(src: np.ndarray, dst: np.ndarray, part: np.ndarray, k: int) -> np.ndarray:
    """|V(E_p)| for every p — distinct vertices touched by each partition."""
    counts = np.zeros(k, dtype=np.int64)
    # Sort edges by partition once; count uniques per contiguous span.
    order = np.argsort(part, kind="stable")
    ps, ss, ds = part[order], src[order], dst[order]
    bounds = np.searchsorted(ps, np.arange(k + 1))
    for p in range(k):
        lo, hi = bounds[p], bounds[p + 1]
        if hi > lo:
            counts[p] = np.unique(np.concatenate([ss[lo:hi], ds[lo:hi]])).shape[0]
    return counts


def replication_factor(src, dst, part, k, num_vertices) -> float:
    """RF(E_k) = (1/|V|) Σ_p |V(E_p)|  (Def. 1). Normalized by touched vertices."""
    counts = partition_vertex_counts(np.asarray(src), np.asarray(dst), np.asarray(part), k)
    nv = np.unique(np.concatenate([src, dst])).shape[0] if num_vertices is None else num_vertices
    return float(counts.sum()) / float(nv)


def chunk_vertex_counts_ordered(src_ordered, dst_ordered, k) -> np.ndarray:
    """|V(E_p)| per CEP chunk of an already-ordered edge list."""
    e = src_ordered.shape[0]
    bounds = cep.chunk_bounds(e, k)
    counts = np.zeros(k, dtype=np.int64)
    for p in range(k):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if hi > lo:
            counts[p] = np.unique(np.concatenate([src_ordered[lo:hi], dst_ordered[lo:hi]])).shape[0]
    return counts


def replication_factor_ordered(src_ordered, dst_ordered, k, num_vertices) -> float:
    """RF of CEP chunks over an already-ordered edge list."""
    counts = chunk_vertex_counts_ordered(src_ordered, dst_ordered, k)
    return float(counts.sum()) / float(num_vertices)


def mirror_count_ordered(src_ordered, dst_ordered, k, num_vertices) -> int:
    """mirror_count for CEP chunks of an ordered edge list (same definition:
    Σ_p |V(E_p)| − |touched vertices|)."""
    counts = chunk_vertex_counts_ordered(src_ordered, dst_ordered, k)
    present = np.unique(np.concatenate([src_ordered, dst_ordered])).shape[0]
    return int(counts.sum() - present)


def edge_balance(part: np.ndarray, k: int) -> float:
    """EB = max_p |E_p| / mean_p |E_p|  (= 1 + ε of Def. 2)."""
    counts = np.bincount(part, minlength=k).astype(np.float64)
    return float(counts.max() / counts.mean())


def vertex_balance(src, dst, part, k) -> float:
    counts = partition_vertex_counts(np.asarray(src), np.asarray(dst), np.asarray(part), k).astype(np.float64)
    return float(counts.max() / counts.mean())


def mirror_count(src, dst, part, k, num_vertices) -> int:
    """# replicated (mirror) vertices = Σ_p |V(E_p)| − |V(E)| — proportional to
    per-iteration communication in vertex-cut graph processing."""
    counts = partition_vertex_counts(np.asarray(src), np.asarray(dst), np.asarray(part), k)
    present = np.unique(np.concatenate([src, dst])).shape[0]
    return int(counts.sum() - present)


def comm_volume_bytes(src, dst, part, k, num_vertices, bytes_per_value: int = 8, iterations: int = 1) -> int:
    """Model of per-iteration GAS communication: every mirror sends+receives one
    accumulator value per superstep (PowerGraph-style)."""
    return 2 * mirror_count(src, dst, part, k, num_vertices) * bytes_per_value * iterations
