"""Per-process RMAT shard generation — stateless in the shard index.

``core.graph.rmat_graph`` draws its quadrant bits from a *stateful* rng over
the whole edge list, so generating a 2^23+-edge graph means materializing
2^23+ edges in one host process. This module replaces the rng with the
repo-wide stateless draw (``core.baselines.mix_hash``, the same helper
``SyntheticStream`` and ``data/pipeline`` hash through): every **candidate
index** ``i ∈ [0, num_candidates)`` maps to an edge as a pure function of
``(seed, i)``, so

* any process can generate exactly its shard — candidate range
  ``chunk_bounds(num_candidates, num_shards)[s : s+2)`` — with O(shard)
  memory and zero coordination;
* a "shuffle" between generation shards and consumer chunks (dgl's
  ``data_shuffle`` ships edges over the NIC for this) is just a *re-scan*:
  whoever needs an edge regenerates it;
* sampling for the hierarchical orderer's locality pass is free: generate
  every ``stride``-th candidate directly instead of scanning and discarding.

Candidates are canonicalized (``lo < hi``) and self-loops dropped — both
pure per-candidate decisions, so shard edge counts are additive across
shards. Duplicate candidates (inherent to RMAT) are KEPT by default: global
dedup needs global state, and the downstream hierarchical orderer handles
duplicates locally (core/hier_order.py packs copies adjacent to their first
occurrence, which costs nothing in locality). ``dedup=True`` dedups *within*
the requested range for in-core use.

Vertex ids are scrambled by a stateless invertible mix (odd-multiply +
xor-shift on ``scale`` bits) standing in for ``rmat_graph``'s rng
permutation — the default candidate order carries no id locality, same as
the in-core generator's contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import cep
from ..core.baselines import mix_hash, splitmix64

__all__ = ["RmatShardPlan", "candidate_edges", "shard_edges", "sample_edges", "stream_edges"]

# Salt lanes of the per-candidate draws (distinct from SyntheticStream's 1/2/3/7).
_SALT_QUAD = 101  # + bit index: quadrant draw of that RMAT recursion level
_SALT_STREAM = 211  # insert-stream lane (stream_edges)


@dataclasses.dataclass(frozen=True)
class RmatShardPlan:
    """A sharded RMAT graph, defined entirely by its parameters.

    The graph IS the plan: any process holding it can materialize any shard,
    sample, or single candidate, bit-identically. ``num_candidates`` counts
    raw draws; the realized edge count is slightly lower (self-loops drop).
    """

    scale: int
    edge_factor: int = 16
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19
    seed: int = 0
    num_shards: int = 1

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def num_candidates(self) -> int:
        return self.num_vertices * self.edge_factor

    def shard_bounds(self) -> np.ndarray:
        """(num_shards+1,) candidate-index bounds — CEP chunks of the
        candidate space, so shard counts rebalance by Thm. 2 when
        num_shards changes."""
        return np.asarray(cep.chunk_bounds(self.num_candidates, self.num_shards))


def _scramble(v: np.ndarray, scale: int, seed: int) -> np.ndarray:
    """Stateless invertible permutation of [0, 2^scale): odd multiply +
    xor-shift rounds, constants drawn from the seed — destroys the quadrant
    id locality the same way rmat_graph's rng permutation does."""
    mask = np.uint64((1 << scale) - 1)
    c1 = (splitmix64(np.uint64(seed) + np.uint64(0xA5)) | np.uint64(1)) & mask
    c2 = (splitmix64(np.uint64(seed) + np.uint64(0xC3)) | np.uint64(1)) & mask
    s1 = max(1, scale // 2)
    s2 = max(1, (2 * scale) // 3)
    x = v.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x * c1) & mask
        x ^= x >> np.uint64(s1)
        x = (x * c2) & mask
        x ^= x >> np.uint64(s2)
    return x


def candidate_edges(plan: RmatShardPlan, idx: np.ndarray, *, dedup: bool = False) -> np.ndarray:
    """(n, 2) int64 canonical edges of the given candidate indices.

    Pure in (plan.seed, idx): per recursion bit, a mix_hash draw picks the
    RMAT quadrant against the cumulative (a, b, c, d) thresholds on the u64
    scale. Self-loops are dropped (a per-candidate decision, so counts stay
    additive across shards); duplicates are kept unless ``dedup``.
    """
    idx = np.asarray(idx, dtype=np.uint64).reshape(-1)
    src = np.zeros(idx.shape[0], dtype=np.uint64)
    dst = np.zeros(idx.shape[0], dtype=np.uint64)
    d = 1.0 - plan.a - plan.b - plan.c
    cum = np.cumsum([plan.a, plan.b, plan.c, d])
    # Thresholds on the u64 scale (exact integer arithmetic); the last is
    # forced to 2^64-1 so rounding can never leave a draw unassigned.
    t = np.asarray(
        [min(int(x * 2**64), 2**64 - 1) for x in cum[:-1]] + [2**64 - 1], dtype=np.uint64
    )
    for bit in range(plan.scale):
        h = mix_hash(plan.seed, idx, bit, _SALT_QUAD)
        q = np.searchsorted(t, h, side="left").astype(np.uint64)
        src |= ((q >> np.uint64(1)) & np.uint64(1)) << np.uint64(bit)
        dst |= (q & np.uint64(1)) << np.uint64(bit)
    src = _scramble(src, plan.scale, plan.seed)
    dst = _scramble(dst, plan.scale, plan.seed + 1)
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    keep = lo != hi
    edges = np.stack([lo[keep], hi[keep]], axis=1)
    if dedup:
        key = edges[:, 0] * np.int64(plan.num_vertices) + edges[:, 1]
        _, first = np.unique(key, return_index=True)
        edges = edges[np.sort(first)]
    return edges


def shard_edges(plan: RmatShardPlan, shard: int, *, dedup: bool = False) -> np.ndarray:
    """(n_s, 2) int64 edges of shard ``shard`` — THE per-process generator.
    O(shard) memory, stateless in the shard index: process p materializes
    shard p (or any other; regeneration is the shuffle)."""
    if not 0 <= shard < plan.num_shards:
        raise ValueError(f"shard {shard} outside [0, {plan.num_shards})")
    b = plan.shard_bounds()
    return candidate_edges(plan, np.arange(int(b[shard]), int(b[shard + 1])), dedup=dedup)


def sample_edges(plan: RmatShardPlan, stride: int, *, dedup: bool = True) -> np.ndarray:
    """Every ``stride``-th candidate, generated DIRECTLY (no full scan) —
    the bounded-memory locality sample core/hier_order.py builds its vertex
    rank from. Deduped by default (the sample feeds a Graph)."""
    if stride < 1:
        raise ValueError("stride must be >= 1")
    return candidate_edges(plan, np.arange(0, plan.num_candidates, stride), dedup=dedup)


def stream_edges(plan: RmatShardPlan, batch: int, size: int, *, salt: int = 0) -> np.ndarray:
    """(≤size, 2) int64 candidate INSERT edges for stream batch ``batch`` — a
    stateless insert stream over the plan's vertex set, for out-of-core
    ingest where SyntheticStream's live-set tracking (O(|E|) host state)
    is exactly what we must not hold. Draws are uniform pairs through the
    same mix_hash; self-loops drop, so batches may run slightly short."""
    pos = np.arange(size, dtype=np.uint64)
    nv = np.uint64(plan.num_vertices)
    u = mix_hash(plan.seed, batch, pos, _SALT_STREAM + 2 * salt) % nv
    v = mix_hash(plan.seed, batch, pos, _SALT_STREAM + 2 * salt + 1) % nv
    lo = np.minimum(u, v).astype(np.int64)
    hi = np.maximum(u, v).astype(np.int64)
    keep = lo != hi
    return np.stack([lo[keep], hi[keep]], axis=1)
