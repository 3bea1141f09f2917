"""Baseline partitioners and orderings the paper compares against (Tables 4/5).

Partitioners return an (E,) int32 partition assignment; orderings return an
(E,) permutation (order[i] = edge id of the i-th edge) consumed by CEP.

  1D      random 1-D hash of the edge id
  2D      grid hash (src hash → row, dst hash → col)
  DBH     degree-based hashing (hash the lower-degree endpoint)
  HDRF    high-degree-replicated-first streaming partitioner
  NE      neighborhood-expansion greedy (stand-in for Zhang et al. KDD'17)
  BVC     consistent-hash ring scaling (Fan et al. PVLDB'19) — equivalent to
          CEP over a hash-ordered edge list (paper §6.4.3)
  MTS     spectral recursive-bisection vertex partitioner (METIS stand-in)
  CVP     chunk-based vertex partitioning over a vertex order
  RCM     Reverse Cuthill–McKee vertex order (scipy), lifted to edges
"""
from __future__ import annotations

import numpy as np

from . import cep
from .graph import Graph
from .ordering import lift_vertex_order

__all__ = [
    "splitmix64",
    "mix_hash",
    "hash_1d",
    "hash_2d",
    "dbh",
    "hdrf",
    "ne_partition",
    "bvc_order",
    "bvc_partition",
    "rcm_edge_order",
    "spectral_vertex_partition",
    "cvp_partition",
    "vertex_to_edge_partition",
]


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix hash (vectorized)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):  # u64 wraparound is the point
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        z = x
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        return z ^ (z >> np.uint64(31))


_MIX_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MIX_FNV = np.uint64(0x100000001B3)
_MIX_POS = np.uint64(1_000_003)


def mix_hash(seed, major, minor, salt) -> np.ndarray:
    """The ONE stateless draw every deterministic stream in the repo uses:
    ``splitmix64(seed·φ + major·FNV + minor·1000003 + salt)`` over uint64
    wraparound arithmetic. ``major``/``minor``/``salt`` may be scalars or
    arrays (broadcast); the same (seed, major, minor, salt) always yields the
    same draw, scalar or vectorized — stream/updates.SyntheticStream,
    data/pipeline and data/shards all hash through here so their replay
    contracts are one contract (property-tested in tests/test_outofcore.py).
    """
    with np.errstate(over="ignore"):  # u64 wraparound is the point
        key = (
            np.uint64(seed) * _MIX_GOLD
            + np.asarray(major, dtype=np.uint64) * _MIX_FNV
            + np.asarray(minor, dtype=np.uint64) * _MIX_POS
            + np.asarray(salt, dtype=np.uint64)
        )
        return splitmix64(key)


def hash_1d(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    return (splitmix64(np.arange(g.num_edges) + seed * 0x9E37) % np.uint64(k)).astype(np.int32)


def _grid_dims(k: int) -> tuple[int, int]:
    a = int(np.floor(np.sqrt(k)))
    while k % a:
        a -= 1
    return a, k // a


def hash_2d(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Grid partitioning: row from src hash, col from dst hash."""
    a, b = _grid_dims(k)
    hs = splitmix64(g.src.astype(np.uint64) + np.uint64(seed)) % np.uint64(a)
    hd = splitmix64(g.dst.astype(np.uint64) + np.uint64(seed) + np.uint64(1)) % np.uint64(b)
    return (hs * np.uint64(b) + hd).astype(np.int32)


def dbh(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Degree-Based Hashing (Xie et al. 2014): hash the lower-degree endpoint."""
    deg = np.diff(g.indptr)
    pick_src = deg[g.src] <= deg[g.dst]
    key = np.where(pick_src, g.src, g.dst).astype(np.uint64)
    return (splitmix64(key + np.uint64(seed)) % np.uint64(k)).astype(np.int32)


def hdrf(g: Graph, k: int, lam: float = 1.0, seed: int = 0) -> np.ndarray:
    """HDRF streaming partitioner (Petroni et al. CIKM'15).

    Score(e=(u,v), p) = C_rep + λ·C_bal with the high-degree-replicated-first
    degree normalization. O(|E|·k) — use on ≲1M-edge graphs.
    """
    rng = np.random.default_rng(seed)
    part_of = np.empty(g.num_edges, dtype=np.int32)
    present = np.zeros((k, g.num_vertices), dtype=bool)
    load = np.zeros(k, dtype=np.int64)
    pdeg = np.zeros(g.num_vertices, dtype=np.int64)  # partial (streamed) degree
    order = rng.permutation(g.num_edges)
    eps = 1e-9
    for eid in order:
        u, v = int(g.src[eid]), int(g.dst[eid])
        pdeg[u] += 1
        pdeg[v] += 1
        du, dv = pdeg[u], pdeg[v]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        in_u = present[:, u]
        in_v = present[:, v]
        # g(v,p): 1 + (1 − θ) if v already in p else 0 — replicate high-degree.
        c_rep = in_u * (1.0 + (1.0 - theta_u)) + in_v * (1.0 + (1.0 - theta_v))
        maxl, minl = load.max(), load.min()
        c_bal = lam * (maxl - load) / (eps + maxl - minl)
        p = int(np.argmax(c_rep + c_bal))
        part_of[eid] = p
        present[p, u] = True
        present[p, v] = True
        load[p] += 1
    return part_of


def ne_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Neighborhood-expansion greedy edge partitioner (NE stand-in).

    Grows each partition from a seed, repeatedly absorbing the boundary vertex
    with the fewest remaining unallocated edges and claiming its edges, until
    the CEP-balanced quota ⌊(|E|+p)/k⌋ is met. Captures NE's core heuristic
    (minimize boundary growth) without the full two-phase refinement.
    """
    import heapq

    rng = np.random.default_rng(seed)
    part_of = np.full(g.num_edges, -1, dtype=np.int32)
    remaining = np.diff(g.indptr).astype(np.int64).copy()
    allocated = np.zeros(g.num_edges, dtype=bool)
    perm = rng.permutation(g.num_vertices)
    perm_ptr = 0
    for p in range(k):
        quota = cep.chunk_size(g.num_edges, k, p)
        if p == k - 1:
            quota = int((~allocated).sum())  # absorb rounding
        got = 0
        heap: list[tuple[int, int]] = []
        in_heap = set()

        def refill() -> None:
            nonlocal perm_ptr
            while perm_ptr < g.num_vertices:
                v = int(perm[perm_ptr])
                if remaining[v] > 0:
                    heapq.heappush(heap, (int(remaining[v]), v))
                    in_heap.add(v)
                    return
                perm_ptr += 1

        refill()
        while got < quota:
            if not heap:
                refill()
                if not heap:
                    break
            r, v = heapq.heappop(heap)
            in_heap.discard(v)
            if remaining[v] == 0:
                continue
            if r != remaining[v]:  # stale entry
                heapq.heappush(heap, (int(remaining[v]), v))
                in_heap.add(v)
                continue
            for j in range(g.indptr[v], g.indptr[v + 1]):
                if got >= quota:
                    break
                eid = int(g.eid[j])
                if allocated[eid]:
                    continue
                u = int(g.nbr[j])
                allocated[eid] = True
                part_of[eid] = p
                got += 1
                remaining[v] -= 1
                remaining[u] -= 1
                if remaining[u] > 0 and u not in in_heap:
                    heapq.heappush(heap, (int(remaining[u]), u))
                    in_heap.add(u)
    part_of[part_of < 0] = k - 1
    return part_of


def bvc_order(g: Graph, seed: int = 0) -> np.ndarray:
    """BVC's consistent-hash ring as an edge order: sort edges by ring position.
    Chunking this order with CEP == arc assignment on the ring, so scaling
    moves contiguous arcs (paper §6.4.3: BVC and CEP migrate alike)."""
    pos = splitmix64(np.arange(g.num_edges, dtype=np.uint64) + np.uint64(seed))
    return np.argsort(pos, kind="stable").astype(np.int64)


def bvc_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    order = bvc_order(g, seed)
    part = np.empty(g.num_edges, dtype=np.int32)
    bounds = cep.chunk_bounds(g.num_edges, k)
    for p in range(k):
        part[order[bounds[p] : bounds[p + 1]]] = p
    return part


def rcm_edge_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee vertex order (scipy), lifted to an edge order."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = g.num_edges
    data = np.ones(2 * e, dtype=np.int8)
    rows = np.concatenate([g.src, g.dst]).astype(np.int64)
    cols = np.concatenate([g.dst, g.src]).astype(np.int64)
    a = sp.csr_matrix((data, (rows, cols)), shape=(g.num_vertices, g.num_vertices))
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    rank = np.empty(g.num_vertices, dtype=np.int64)
    rank[perm] = np.arange(g.num_vertices)
    return lift_vertex_order(g, rank)


def spectral_vertex_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Recursive spectral bisection (Fiedler vector) — METIS (MTS) stand-in.

    Returns a vertex→partition map. Balanced by median splits; k must be ≥ 1
    (non-powers of two handled by uneven leaf counts).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    vpart = np.zeros(g.num_vertices, dtype=np.int32)

    def bisect(vids: np.ndarray, nparts: int, base: int) -> None:
        if nparts <= 1 or vids.shape[0] <= 1:
            vpart[vids] = base
            return
        k_left = nparts // 2
        frac = k_left / nparts
        # Build induced subgraph Laplacian.
        lookup = -np.ones(g.num_vertices, dtype=np.int64)
        lookup[vids] = np.arange(vids.shape[0])
        mask = (lookup[g.src] >= 0) & (lookup[g.dst] >= 0)
        rs, ds = lookup[g.src[mask]], lookup[g.dst[mask]]
        n = vids.shape[0]
        if rs.shape[0] == 0:
            half = int(round(n * frac))
            bisect(vids[:half], k_left, base)
            bisect(vids[half:], nparts - k_left, base + k_left)
            return
        data = np.ones(2 * rs.shape[0])
        adj = sp.csr_matrix((data, (np.r_[rs, ds], np.r_[ds, rs])), shape=(n, n))
        lap = sp.csgraph.laplacian(adj)
        try:
            vals, vecs = spla.eigsh(
                lap.asfptype(), k=2, sigma=-1e-6, which="LM",
                v0=np.random.default_rng(seed).standard_normal(n),
            )
            fiedler = vecs[:, np.argsort(vals)[1]]
        except Exception:
            fiedler = np.random.default_rng(seed).standard_normal(n)
        cutoff = np.quantile(fiedler, frac)
        left = fiedler <= cutoff
        # Repair degenerate splits.
        if left.sum() == 0 or left.sum() == n:
            idx = np.argsort(fiedler)
            left = np.zeros(n, dtype=bool)
            left[idx[: int(round(n * frac))]] = True
        bisect(vids[left], k_left, base)
        bisect(vids[~left], nparts - k_left, base + k_left)

    bisect(np.arange(g.num_vertices), k, 0)
    return vpart


def cvp_partition(g: Graph, vertex_rank: np.ndarray, k: int) -> np.ndarray:
    """Chunk-based *vertex* partitioning: chunk the vertex order, then convert
    to edge partitions (each edge goes to a uniformly-chosen endpoint's part,
    as in the paper's MTS/CVP comparison)."""
    nv = g.num_vertices
    vpart = np.asarray(cep.id2p(nv, k, vertex_rank), dtype=np.int32)
    return vertex_to_edge_partition(g, vpart, k)


def vertex_to_edge_partition(g: Graph, vpart: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pick_src = rng.integers(0, 2, size=g.num_edges).astype(bool)
    return np.where(pick_src, vpart[g.src], vpart[g.dst]).astype(np.int32)
