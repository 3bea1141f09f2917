"""Chunk-based Edge Partitioning (CEP) — paper §3.3, Theorems 1 & 2.

Everything here is O(1) arithmetic over (|E|, k, p) / (|E|, k, i); no pass over
the edges is ever required. The same formulas take Python ints and numpy
arrays, so a rescale plan is host arithmetic over a handful of integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "chunk_size",
    "chunk_start",
    "chunk_bounds",
    "id2p",
    "id2p_loop",
    "partition_slices",
    "ScalePlan",
    "scale_plan",
    "migrated_edges_exact",
    "migration_cost_theorem2",
    "migration_cost_random",
]


def chunk_size(num_edges, k, p):
    """⌊(|E|+p)/k⌋ — size of partition p (perfect balance, ε≈0)."""
    return (num_edges + p) // k


def chunk_start(num_edges, k, p):
    """Closed form of Σ_{x<p} ⌊(|E|+x)/k⌋ = p⌊|E|/k⌋ + θ_k(p)  (Thm. 1).

    θ_k(p) = max(0, p − k + (|E| mod k)). O(1), independent of graph size.
    """
    f = num_edges // k
    r = num_edges % k
    theta = p - k + r
    theta = theta * (theta > 0)  # max(0, ·) — branch-free, so numpy arrays work too
    return p * f + theta


def chunk_bounds(num_edges: int, k: int) -> np.ndarray:
    """(k+1,) boundary array: partition p owns [bounds[p], bounds[p+1])."""
    p = np.arange(k + 1, dtype=np.int64)
    return chunk_start(num_edges, k, p)


def id2p(num_edges, k, i):
    """O(1) inverse of chunk_start: partition owning ordered edge id i.

    Partitions [0, B) have size f, partitions [B, k) have size f+1, where
    f = ⌊|E|/k⌋ and B = k − (|E| mod k). Vectorized over numpy arrays.
    """
    f = num_edges // k
    r = num_edges % k
    b = k - r  # number of small chunks
    cut = b * f  # first edge id owned by a large chunk
    # k > |E| ⇒ f = 0 (all "small" chunks are empty; every edge lives in a
    # size-1 "large" chunk). Guard the division branch-free so the formula
    # stays valid for numpy arrays (max(f, 1) is not vectorized).
    small = i // (f + (f == 0))
    large = b + (i - cut) // (f + 1)
    is_small = i < cut  # branch-free select over numpy arrays
    return is_small * small + (1 - is_small) * large


def id2p_loop(num_edges: int, k: int, i: int) -> int:
    """Paper's Algorithm 2 (linear loop) — kept as the oracle for id2p."""
    p = 0
    cur = chunk_size(num_edges, k, p)
    while i >= cur:
        p += 1
        cur += chunk_size(num_edges, k, p)
    return p


def partition_slices(num_edges: int, k: int) -> list[slice]:
    b = chunk_bounds(num_edges, k)
    return [slice(int(b[p]), int(b[p + 1])) for p in range(k)]


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    """Migration plan for rescaling k_old → k_new over the same ordered list.

    moves[j] = (lo, hi, src_part, dst_part): ordered-edge id range [lo, hi)
    moves from src to dst. Ranges with src == dst are "stay" segments and are
    not listed. O(k_old + k_new) to build; each entry is O(1).
    """

    num_edges: int
    k_old: int
    k_new: int
    moves: tuple[tuple[int, int, int, int], ...]
    stay: tuple[tuple[int, int, int], ...]

    @property
    def migrated_edges(self) -> int:
        return sum(hi - lo for lo, hi, _, _ in self.moves)

    def migrated_bytes(self, bytes_per_edge: int) -> int:
        return self.migrated_edges * bytes_per_edge


def scale_plan(num_edges: int, k_old: int, k_new: int) -> ScalePlan:
    """Overlay old and new chunk boundaries; emit contiguous move ranges.

    The boundary overlay has ≤ k_old + k_new segments, each wholly inside one
    old and one new partition, so the plan is exact and tiny (never touches
    edges). This is the framework-facing form of Thm. 1/2.
    """
    bo = chunk_bounds(num_edges, k_old)
    bn = chunk_bounds(num_edges, k_new)
    cuts = np.unique(np.concatenate([bo, bn]))
    moves: list[tuple[int, int, int, int]] = []
    stay: list[tuple[int, int, int]] = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        src = int(id2p(num_edges, k_old, lo))
        dstp = int(id2p(num_edges, k_new, lo))
        if src == dstp:
            stay.append((int(lo), int(hi), src))
        else:
            moves.append((int(lo), int(hi), src, dstp))
    return ScalePlan(num_edges, k_old, k_new, tuple(moves), tuple(stay))


def migrated_edges_exact(num_edges: int, k_old: int, k_new: int) -> int:
    return scale_plan(num_edges, k_old, k_new).migrated_edges


def migration_cost_theorem2(num_edges: int, k: int, x: int) -> float:
    """Paper Thm. 2 approximation of migrated edges for k → k+x (scale-out)."""
    ceil_kx = int(np.ceil(k / x))
    term1 = (x * num_edges) / (2 * k * (k + x)) * ceil_kx * (ceil_kx + 1)
    term2 = (num_edges / k) * (k - ceil_kx)
    return term1 + term2


def migration_cost_random(num_edges: int, k: int, x: int) -> float:
    """Hash repartitioning k → k+x migrates ≈ k/(k+x)·|E| edges (paper, Cor. 1
    discussion: for x = 1, ≈ k/(k+1)·|E| move while |E|/(k+1) stay)."""
    return num_edges * k / (k + x)
