"""Graph Edge Ordering (GEO) — paper §3.4 / §4.

``geo_order``    : Algorithm 4 (priority-queue fast algorithm), O(d²_max·|V|·log|V|).
``geo_order_baseline`` : Algorithm 3 (direct objective evaluation), the oracle —
                   exponential-ish, for tiny test graphs only.
``ordering_objective`` : Eq. (1)/(6) — the chunk objective Σ_k Σ_p |V(chunk)|.

Plus reference orderings used by the paper's comparison (BFS, DFS, random,
degree, default) — RCM lives in baselines.py (scipy).
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from . import cep
from .graph import Graph

__all__ = [
    "geo_order",
    "geo_order_baseline",
    "ordering_objective",
    "bfs_edge_order",
    "random_edge_order",
    "default_edge_order",
    "degree_edge_order",
    "lift_vertex_order",
]

K_MIN_DEFAULT = 4
K_MAX_DEFAULT = 128


def _alpha_beta(num_edges: int, k_min: int, k_max: int) -> tuple[int, int]:
    ks = np.arange(k_min, k_max + 1, dtype=np.int64)
    alpha = int(np.sum(num_edges // ks))
    beta = int(k_max - k_min)
    return alpha, beta


def geo_order(
    g: Graph,
    k_min: int = K_MIN_DEFAULT,
    k_max: int = K_MAX_DEFAULT,
    delta: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Paper Algorithm 4. Returns ``order``: order[i] = edge id of i-th edge.

    Priority p(v) = α·D[v] − β·M[v] (Eq. 8), min first. Lazy-deletion binary
    heap ⇒ O(log|V|) updates. Two-hop edges e_{u,w} are ordered eagerly when w
    was touched within the last δ ordered edges (Line 11's
    ``w ∈ V(X_ch(|X|−δ, δ))`` test, tracked in O(1) via M[w]).
    """
    e_total = g.num_edges
    v_total = g.num_vertices
    if delta is None:
        delta = max(1, e_total // k_max)  # paper §4.1: δ = |E| / k_max
    alpha, beta = _alpha_beta(e_total, k_min, k_max)

    rng = np.random.default_rng(seed)
    indptr, nbrs, eids = g.indptr, g.nbr, g.eid

    # The greedy below is an interpreter-bound pointer chase: plain python
    # lists beat numpy arrays for scalar indexing by ~4× (no per-access
    # boxing), and every quantity is an exact int — the produced order is
    # IDENTICAL to the historical array-based loop (it prices the streaming
    # subsystem's full-rebuild rung, so it must be as fast as python allows).
    indptr_l = indptr.tolist()
    nbrs_l = nbrs.tolist()
    eids_l = eids.tolist()

    order = np.empty(e_total, dtype=np.int64)  # order[i] = edge id
    edge_done = [False] * e_total
    d = np.diff(indptr).astype(np.int64).tolist()  # D[v] — remaining degree
    # M[v] — latest order touching v. m[v] > 0 ⟺ v has been touched: every
    # write below stores i AFTER the i += 1, so the "touched" predicate is
    # exactly m[v] > 0 and needs no separate flag array.
    m = [0] * v_total
    selected = [False] * v_total
    # nbr cursor: skip-ahead pointer so each adjacency is scanned O(1) amortized.
    cursor = indptr[:-1].tolist()

    # Heap entries are the packed int priority·|V| + vertex: with 0 ≤ v < |V|
    # the packed ordering IS the (priority, vertex) lexicographic ordering of
    # the historical tuple entries (exact ints, negative priorities included),
    # and plain-int sifting skips a tuple allocation per push and a tuple
    # compare per swap. cur_pri stores the packed key, so the lazy-deletion
    # staleness test (key != cur_pri[v]) is unchanged.
    heap: list[int] = []
    maxint = int(np.iinfo(np.int64).max)
    cur_pri = [maxint] * v_total
    heappush, heappop = heapq.heappush, heapq.heappop

    # Random fallback scan order (paper: RandomVertex()).
    rand_perm = rng.permutation(v_total).tolist()
    rand_ptr = 0

    i = 0  # next order index == |X^phi|

    # The push / order-an-edge steps are spelled inline in the loop below:
    # they fire once (or more) per edge, where CPython's call overhead alone
    # was ~40% of the whole greedy. The produced order is IDENTICAL to the
    # historical closure-based body — this function prices the full-rebuild
    # rung's candidate on every async dispatch, so it must be as fast as
    # python allows.
    while i < e_total:
        # --- select v_min ---
        vmin = -1
        while heap:
            key = heappop(heap)
            v = key % v_total
            if selected[v] or key != cur_pri[v]:
                continue
            if d[v] == 0:
                selected[v] = True
                continue
            vmin = v
            break
        if vmin < 0:
            while rand_ptr < v_total:
                v = rand_perm[rand_ptr]
                rand_ptr += 1
                if not selected[v] and d[v] > 0:
                    vmin = v
                    break
            if vmin < 0:
                # All vertices exhausted but edges remain — cannot happen on a
                # consistent graph; guard anyway.
                for eid_ in range(e_total):
                    if not edge_done[eid_]:
                        a = int(g.src[eid_])
                        b = int(g.dst[eid_])
                        order[i] = eid_
                        edge_done[eid_] = True
                        i += 1
                        d[a] -= 1
                        d[b] -= 1
                        m[a] = i
                        m[b] = i
                break
        selected[vmin] = True

        # --- order one-hop edges e_{vmin,u}, ascending u (CSR is pre-sorted) ---
        lo = cursor[vmin]
        hi = indptr_l[vmin + 1]
        for j in range(lo, hi):
            eid_ = eids_l[j]
            if edge_done[eid_]:
                continue
            u = nbrs_l[j]
            order[i] = eid_  # order_edge(eid_, vmin, u)
            edge_done[eid_] = True
            i += 1
            d[vmin] -= 1
            du = d[u] - 1
            d[u] = du
            m[vmin] = i
            m[u] = i
            # --- two-hop: e_{u,w} with w recently ordered (within δ) ---
            jlo = cursor[u]
            jhi = indptr_l[u + 1]
            for jj in range(jlo, jhi):
                eid2 = eids_l[jj]
                if edge_done[eid2]:
                    if jj == cursor[u]:
                        cursor[u] = jj + 1
                    continue
                w = nbrs_l[jj]
                if w == vmin:
                    continue
                mw = m[w]
                if mw > 0 and not selected[w] and (i - mw) <= delta:
                    order[i] = eid2  # order_edge(eid2, u, w)
                    edge_done[eid2] = True
                    i += 1
                    du = d[u] - 1
                    d[u] = du
                    dw = d[w] - 1
                    d[w] = dw
                    m[u] = i
                    m[w] = i
                    # push(w): m[w] == i here
                    key = (alpha * dw - beta * i) * v_total + w
                    if key != cur_pri[w]:
                        cur_pri[w] = key
                        heappush(heap, key)
            key = (alpha * du - beta * m[u]) * v_total + u  # push(u)
            if key != cur_pri[u]:
                cur_pri[u] = key
                heappush(heap, key)
        cursor[vmin] = hi

    assert i == e_total
    return order


# ---------------------------------------------------------------------------
# Algorithm 3 — direct objective evaluation (test oracle)
# ---------------------------------------------------------------------------


def ordering_objective(
    src_ordered: np.ndarray,
    dst_ordered: np.ndarray,
    num_edges_total: int,
    num_vertices: int,
    k_min: int = K_MIN_DEFAULT,
    k_max: int = K_MAX_DEFAULT,
) -> float:
    """Eq. (7): objective of a (possibly partial) ordered edge list X^φ.

    For each k, sum |V(X ∩ chunk)| over the chunks of the *full* edge space
    (chunks beyond |X| contribute their covered prefix; empty chunks 0).
    """
    x_len = src_ordered.shape[0]
    total = 0
    for k in range(k_min, k_max + 1):
        bounds = cep.chunk_bounds(num_edges_total, k)
        for p in range(k):
            lo, hi = int(bounds[p]), int(min(bounds[p + 1], x_len))
            if hi <= lo:
                break
            total += np.unique(
                np.concatenate([src_ordered[lo:hi], dst_ordered[lo:hi]])
            ).shape[0]
    return total / num_vertices


def geo_order_baseline(
    g: Graph,
    k_min: int = K_MIN_DEFAULT,
    k_max: int = K_MAX_DEFAULT,
    delta: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Paper Algorithm 3 — greedy selection by evaluating Eq. (7) per frontier
    vertex. O(|V|²·|E|·…): tiny graphs only (tests)."""
    e_total = g.num_edges
    if delta is None:
        delta = max(1, e_total // k_max)
    rng = np.random.default_rng(seed)
    indptr, nbrs, eids = g.indptr, g.nbr, g.eid

    order: list[int] = []
    edge_done = np.zeros(e_total, dtype=bool)
    m = np.zeros(g.num_vertices, dtype=np.int64)
    touched = np.zeros(g.num_vertices, dtype=bool)
    selected = np.zeros(g.num_vertices, dtype=bool)
    src_o: list[int] = []
    dst_o: list[int] = []

    def candidate_objective(v: int) -> float:
        # X' = X + (N(v) \ X): append v's unordered edges.
        add_s, add_d = [], []
        for j in range(indptr[v], indptr[v + 1]):
            if not edge_done[eids[j]]:
                add_s.append(v)
                add_d.append(int(nbrs[j]))
        s = np.asarray(src_o + add_s, dtype=np.int64)
        dd = np.asarray(dst_o + add_d, dtype=np.int64)
        return ordering_objective(s, dd, e_total, g.num_vertices, k_min, k_max)

    def order_edge(eid_: int, a: int, b: int) -> None:
        order.append(eid_)
        edge_done[eid_] = True
        src_o.append(a)
        dst_o.append(b)
        m[a] = len(order)
        m[b] = len(order)
        touched[a] = True
        touched[b] = True

    while len(order) < e_total:
        frontier = [
            int(v)
            for v in np.flatnonzero(touched & ~selected)
            if any(not edge_done[eids[j]] for j in range(indptr[v], indptr[v + 1]))
        ]
        if frontier:
            scores = [(candidate_objective(v), v) for v in frontier]
            _, vmin = min(scores)
        else:
            cands = [
                int(v)
                for v in np.flatnonzero(~selected)
                if any(not edge_done[eids[j]] for j in range(indptr[v], indptr[v + 1]))
            ]
            if not cands:
                break
            vmin = int(rng.choice(cands))
        selected[vmin] = True
        for j in range(indptr[vmin], indptr[vmin + 1]):
            eid_ = int(eids[j])
            if edge_done[eid_]:
                continue
            u = int(nbrs[j])
            order_edge(eid_, vmin, u)
            for jj in range(indptr[u], indptr[u + 1]):
                eid2 = int(eids[jj])
                if edge_done[eid2]:
                    continue
                w = int(nbrs[jj])
                if w == vmin:
                    continue
                if touched[w] and not selected[w] and (len(order) - m[w]) <= delta and m[w] > 0:
                    order_edge(eid2, u, w)
    # Append any stragglers (disconnected leftovers).
    for eid_ in np.flatnonzero(~edge_done):
        order.append(int(eid_))
    return np.asarray(order, dtype=np.int64)


# ---------------------------------------------------------------------------
# Parallel GEO (beyond-paper: the paper's §7 future work)
# ---------------------------------------------------------------------------


def parallel_geo_order(
    g: Graph,
    workers: int = 4,
    k_min: int = K_MIN_DEFAULT,
    k_max: int = K_MAX_DEFAULT,
    seed: int = 0,
    balance_edges: bool = False,
) -> tuple[np.ndarray, list]:
    """Block-parallel GEO: the sequential greedy is the paper's scalability
    limit (§6.4 'Scalability', §7 future work). We split the edge set into
    ``workers`` locality-preserving regions (contiguous ranges of a cheap BFS
    vertex order), GEO-order each region *independently* (embarrassingly
    parallel across hosts), and concatenate the region orders.

    Quality intuition: chunk boundaries introduced by concatenation cost at
    most (workers−1) extra boundary regions out of k_max, and each region's
    internal order is full-quality GEO — measured ≤ ~1.2× sequential-GEO RF
    at 8 workers (tests/test_ordering.py, benchmarks/bench_scalability).

    Returns (order, per-region edge counts) — wall-clock on a real cluster is
    max(region time) ≈ T_seq/workers.
    """
    if workers <= 1:
        return geo_order(g, k_min, k_max, seed=seed), [g.num_edges]
    rank = _bfs_vertex_rank(g, seed)
    # An edge belongs to its min-rank endpoint; regions are contiguous ranges
    # of the BFS vertex order. Two split policies (measured trade-off in
    # benchmarks/bench_scalability):
    #   balance_edges=False (default): equal VERTEX ranges — region quality ≈
    #     sequential GEO (≤1.1× RF @8 workers on RMAT) but hub-heavy prefixes
    #     keep most edges in one region (speedup limited by skew);
    #   balance_edges=True: equal EDGE ranges — near-perfect load balance
    #     (max/mean ≈ 1.02) at an RF penalty (~1.8× @8 workers, still well
    #     under hash ordering) because balanced BFS cuts cross communities.
    from . import cep as _cep

    if balance_edges:
        lo_end = np.where(rank[g.src] <= rank[g.dst], g.src, g.dst)
        loads = np.bincount(rank[lo_end], minlength=g.num_vertices)
        cum = np.cumsum(loads)
        targets = np.asarray(_cep.chunk_bounds(g.num_edges, workers))[1:-1]
        splits = np.searchsorted(cum, targets, side="left") + 1
        region_of_rank = np.zeros(g.num_vertices, dtype=np.int64)
        for s_ in splits:
            region_of_rank[s_:] += 1
        region = region_of_rank[np.minimum(rank[g.src], rank[g.dst])]
    else:
        lo_rank = np.minimum(rank[g.src], rank[g.dst])
        region = np.asarray(_cep.id2p(g.num_vertices, workers, lo_rank), dtype=np.int64)
    order_parts: list[np.ndarray] = []
    counts: list[int] = []
    for w in range(workers):
        eids = np.flatnonzero(region == w)
        counts.append(int(eids.shape[0]))
        if eids.shape[0] == 0:
            continue
        sub_edges = np.stack([g.src[eids], g.dst[eids]], axis=1)
        sub = Graph.from_edges(sub_edges, g.num_vertices)
        # Map the sub-graph's canonical edge list back to global edge ids.
        key_global = g.src[eids].astype(np.int64) * g.num_vertices + g.dst[eids]
        key_sub = sub.src.astype(np.int64) * g.num_vertices + sub.dst
        sort_idx = np.argsort(key_global)
        lookup = sort_idx[np.searchsorted(key_global[sort_idx], key_sub)]
        global_eid = eids[lookup]  # global id of sub edge i
        sub_order = geo_order(sub, k_min, k_max, seed=seed + w)
        order_parts.append(global_eid[sub_order])
    order = np.concatenate(order_parts)
    assert order.shape[0] == g.num_edges
    return order.astype(np.int64), counts


# ---------------------------------------------------------------------------
# Reference orderings
# ---------------------------------------------------------------------------


def default_edge_order(g: Graph) -> np.ndarray:
    return np.arange(g.num_edges, dtype=np.int64)


def random_edge_order(g: Graph, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(g.num_edges).astype(np.int64)


def bfs_edge_order(g: Graph, seed: int = 0) -> np.ndarray:
    """Order edges by BFS discovery (vertex-locality baseline)."""
    rank = _bfs_vertex_rank(g, seed)
    return lift_vertex_order(g, rank)


def degree_edge_order(g: Graph) -> np.ndarray:
    """DEG: vertices sorted by descending degree, edges lifted."""
    rank = np.empty(g.num_vertices, dtype=np.int64)
    rank[np.argsort(-np.diff(g.indptr), kind="stable")] = np.arange(g.num_vertices)
    return lift_vertex_order(g, rank)


def lift_vertex_order(g: Graph, vertex_rank: np.ndarray) -> np.ndarray:
    """Lift a vertex ordering to an edge ordering: sort edges by
    (min endpoint rank, max endpoint rank) — the CVP-style edge lifting."""
    rs = vertex_rank[g.src]
    rd = vertex_rank[g.dst]
    lo = np.minimum(rs, rd)
    hi = np.maximum(rs, rd)
    return np.lexsort((hi, lo)).astype(np.int64)


def _bfs_vertex_rank(g: Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rank = np.full(g.num_vertices, -1, dtype=np.int64)
    nxt = 0
    from collections import deque

    for start in rng.permutation(g.num_vertices):
        if rank[start] >= 0:
            continue
        q = deque([int(start)])
        rank[start] = nxt
        nxt += 1
        while q:
            v = q.popleft()
            for u in g.nbr[g.indptr[v] : g.indptr[v + 1]]:
                if rank[u] < 0:
                    rank[u] = nxt
                    nxt += 1
                    q.append(int(u))
    return rank
