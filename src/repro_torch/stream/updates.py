"""Streaming update model: edge insert/delete batches + deterministic generator.

``EdgeUpdateBatch`` is the unit every layer of the streaming subsystem speaks:
the host orderer applies it to the ordered slot array, the device engine
scatters it into slack slots, the controller logs it as an IngestEvent.

``SyntheticStream`` generates a reproducible dynamic-graph workload the same
way data/pipeline.py generates tokens: every candidate update is a stateless
splitmix64 hash of (seed, batch index, position), so any run — test, bench,
CI — sees bit-identical streams. Inserts mix uniform edges with "triadic"
edges attached to an endpoint of an existing edge (hash-selected), giving the
stream community structure for the orderer's locality placement to exploit;
deletes hash-index into the current edge list. Replaying the same seed always
yields the same batches because the generator's edge set evolves
deterministically.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.baselines import mix_hash
from ..core.graph import Graph

__all__ = ["EdgeUpdateBatch", "SyntheticStream", "canonical_edges"]


def canonical_edges(edges: np.ndarray) -> np.ndarray:
    """(n, 2) int64 with src < dst per row; self loops dropped, dups dropped
    (keeping first occurrence, order preserved)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    seen: set = set()
    rows = []
    for u, v in zip(lo.tolist(), hi.tolist()):
        if (u, v) not in seen:
            seen.add((u, v))
            rows.append((u, v))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 2)


@dataclasses.dataclass(frozen=True)
class EdgeUpdateBatch:
    """One batch of graph mutations: canonical (src < dst) edge pairs.

    ``insert`` rows not currently in the graph are added; ``delete`` rows not
    currently in the graph are ignored (idempotent semantics, so replays and
    at-least-once delivery are safe).
    """

    insert: np.ndarray  # (n_ins, 2) int64, src < dst
    delete: np.ndarray  # (n_del, 2) int64, src < dst

    def __post_init__(self):
        object.__setattr__(self, "insert", canonical_edges(self.insert))
        object.__setattr__(self, "delete", canonical_edges(self.delete))

    @property
    def num_inserts(self) -> int:
        return int(self.insert.shape[0])

    @property
    def num_deletes(self) -> int:
        return int(self.delete.shape[0])

    @property
    def num_updates(self) -> int:
        return self.num_inserts + self.num_deletes


class SyntheticStream:
    """Deterministic dynamic-graph generator over a base graph.

    ``batch(b)`` is a pure function of (seed, b, base graph): batches may be
    generated once and replayed, or regenerated independently by any process
    holding the same seed — mirroring the stateless-hash contract of
    data/pipeline.py. Internally the generator tracks the evolving edge set so
    inserts are always novel edges and deletes always name live edges.
    """

    def __init__(
        self,
        base: Graph,
        *,
        batch_size: int = 64,
        delete_frac: float = 0.25,
        triadic_frac: float = 0.5,
        seed: int = 0,
        burst_every: int = 0,
        burst_factor: int = 4,
        burst_delete_frac: float | None = None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not 0.0 <= delete_frac < 1.0:
            raise ValueError("delete_frac must be in [0, 1)")
        if burst_every < 0:
            raise ValueError("burst_every must be >= 0 (0 = no bursts)")
        if burst_factor < 1:
            raise ValueError("burst_factor must be >= 1")
        if burst_delete_frac is not None and not 0.0 <= burst_delete_frac < 1.0:
            raise ValueError("burst_delete_frac must be in [0, 1)")
        self.num_vertices = base.num_vertices
        self.batch_size = int(batch_size)
        self.delete_frac = float(delete_frac)
        self.triadic_frac = float(triadic_frac)
        self.seed = int(seed)
        # Bursty mode: every ``burst_every``-th batch (the last of each
        # window) is ``burst_factor``× the base size at ``burst_delete_frac``
        # (default: the base delete_frac) — churn spikes that stress the
        # rebuild-under-ingest delta-splice path. Burst SHAPE is a pure
        # function of the batch index, so the stateless-replay contract is
        # untouched: same (seed, b) → same batch, bursts included.
        self.burst_every = int(burst_every)
        self.burst_factor = int(burst_factor)
        self.burst_delete_frac = (
            self.delete_frac if burst_delete_frac is None else float(burst_delete_frac)
        )
        self._next_batch = 0
        # Live edge set: list for O(1) hash-indexed delete picks (swap-remove),
        # set for O(1) membership.
        self._edges: list[tuple[int, int]] = list(
            zip(base.src.astype(int).tolist(), base.dst.astype(int).tolist())
        )
        self._present: set = set(self._edges)

    # ------------------------------------------------------------------ hash
    def _h(self, batch: int, pos: int, salt: int) -> int:
        # One shared helper with data/shards.py's generator (same key layout,
        # same draw for the same (seed, index) — property-tested).
        return int(mix_hash(self.seed, batch, pos, salt))

    def _candidate_insert(self, batch: int, pos: int) -> tuple[int, int] | None:
        h = self._h(batch, pos, salt=1)
        v_total = self.num_vertices
        if (h >> 8) % 1000 < int(self.triadic_frac * 1000) and self._edges:
            # Triadic closure: attach to an endpoint of a hash-picked live edge.
            a, c = self._edges[(h >> 16) % len(self._edges)]
            u = a if (h >> 4) & 1 else c
            v = int(self._h(batch, pos, salt=2) % v_total)
        else:
            u = int(h % v_total)
            v = int(self._h(batch, pos, salt=3) % v_total)
        if u == v:
            return None
        lo, hi = (u, v) if u < v else (v, u)
        if (lo, hi) in self._present:
            return None
        return (lo, hi)

    # ------------------------------------------------------------------ api
    @property
    def num_edges(self) -> int:
        return len(self._edges)

    def is_burst(self, b: int) -> bool:
        """Whether batch ``b`` is a burst — the last batch of each
        ``burst_every`` window, a pure function of the index."""
        return self.burst_every > 0 and b % self.burst_every == self.burst_every - 1

    def batch_shape(self, b: int) -> tuple[int, int]:
        """(n_del, n_ins) of batch ``b`` before edge-set clamping — the
        deterministic size plan (bursts included)."""
        if self.is_burst(b):
            size = self.batch_size * self.burst_factor
            frac = self.burst_delete_frac
        else:
            size = self.batch_size
            frac = self.delete_frac
        n_del = int(size * frac)
        return n_del, size - n_del

    def batch(self, index: int | None = None) -> EdgeUpdateBatch:
        """Generate the next batch (or assert the caller is replaying in
        order: batches must be consumed sequentially because deletes index the
        evolving live edge set)."""
        b = self._next_batch if index is None else int(index)
        if b != self._next_batch:
            raise ValueError(
                f"stream batches must be consumed in order (next={self._next_batch}, got {b})"
            )
        n_del, n_ins = self.batch_shape(b)
        # Deletes are drawn FIRST, from the pre-batch live set — the same
        # delete-then-insert order IncrementalOrderer.apply uses — so the
        # generator's live set and a consumer's can never diverge (an edge
        # deleted and re-inserted in one batch nets to present on both sides).
        deletes: list[tuple[int, int]] = []
        for i in range(n_del):
            if not self._edges:
                break
            j = self._h(b, i, salt=7) % len(self._edges)
            e = self._edges[j]
            # Swap-remove keeps the pick O(1) and deterministic.
            self._edges[j] = self._edges[-1]
            self._edges.pop()
            self._present.discard(e)
            deletes.append(e)
        inserts: list[tuple[int, int]] = []
        pos = 0
        # Scan bound scales with the batch's own size so bursts aren't
        # starved; identical to the historical 16×batch_size off-burst.
        while len(inserts) < n_ins and pos < 16 * max(self.batch_size, n_del + n_ins):
            e = self._candidate_insert(b, pos)
            pos += 1
            if e is None:  # _present already covers within-batch dedup
                continue
            inserts.append(e)
            self._present.add(e)
            self._edges.append(e)
        self._next_batch = b + 1
        return EdgeUpdateBatch(
            insert=np.asarray(inserts, dtype=np.int64).reshape(-1, 2),
            delete=np.asarray(deletes, dtype=np.int64).reshape(-1, 2),
        )

    def batches(self, n: int):
        for _ in range(n):
            yield self.batch()

    def edges(self) -> np.ndarray:
        """(E, 2) int64 current live edge set (generator's view)."""
        return np.asarray(sorted(self._edges), dtype=np.int64).reshape(-1, 2)
