"""Hierarchical GEO ordering over CEP chunks — the out-of-core scale path.

``geo_order`` is sequential and in-core: ordering a 2^23-edge graph in one
process needs the whole edge list plus E-sized greedy state. This module
builds the SAME kind of order hierarchically, so that no stage ever holds
more than one chunk of edges:

1. **Locality rank** — a vertex rank computed from a bounded *sample* of
   the edge list (``data/shards.sample_edges`` makes sampling free for
   stateless generators). Default mode "geo" GEO-orders the sample in-core
   and ranks vertices by FIRST TOUCH in that order (the order GEO itself
   discovers them); mode "bfs" is the cheaper BFS wavefront rank, which can
   also be produced semi-externally from the full edge stream with V-sized
   state — low-degree graphs (grids, roads) need that full-stream rank
   because a sparse sample of them fragments below percolation.
2. **Chunk splits** — contiguous ranges of the rank line, one chunk per
   range. An edge belongs to the range of its MAX-rank endpoint: it travels
   to its later-discovered endpoint, so a hub's edges scatter to their
   non-hub endpoints' regions instead of piling onto the hub's own range (a
   vertex-cut on hubs, the standard skewed-degree device). That makes the
   per-range edge load — a V-sized histogram any process can accumulate by
   one counting pass over its shards plus a collective sum — smooth enough
   to cut at exactly equal load: chunks land within one vertex's keyed
   degree of E/C, so ``max_chunk_edges`` is a real memory bound, with no
   hub chunk exempted. Membership is a pure function of (rank, splits):
   every process assigns identically without coordination.
3. **Chunk order** — each chunk is GEO-ordered independently on its
   *compacted* vertex set (host ``geo_order``, or the
   ``kernels/full_reorder.py`` greedy where its int32 bound fits — one
   launch of its CUDA kernel a chunk — with its byte-exact host mirror as
   the differential oracle). Duplicate edges —
   kept by sharded generation, see data/shards.py — ride adjacent to their
   first occurrence, which is locality-free placement.
4. **Seam repair** — chunk concatenation introduces at most (num_chunks−1)
   artificial boundaries; a bounded GEO pass re-orders the ±``seam_window``
   edges around each boundary *in place* (windows clamped to half the
   adjacent chunk so they never overlap ⇒ repairs commute and any process
   can repair any seam it owns, deterministically).

The device chunk mode runs on the torch device named by each entry point's
``device`` keyword (``None`` means ``"cuda"``; asking for CUDA without a CUDA
device raises ``RuntimeError``). On a CUDA device each chunk's compacted
unique edges go to the card as int32 ``u``/``v``, and ``full_order_device``
launches the greedy kernel once; the order is copied back to the host only
when it is done. With ``device="cpu"`` the same function runs its plain
version for the host mirror's step count. The keyword is read by no other
chunk mode.

Everything here is a pure function of (edges, sample, config): the in-core
wrapper ``hier_order`` exists for the small-scale differential vs the
``geo_order`` oracle, while the multi-process out-of-core pipeline
(tests/torch_outofcore_harness.py) composes the same primitives chunk by chunk.

Measured worst RF ratio vs the sequential ``geo_order`` oracle over
k ∈ {4..128} (chunks bounded at E/num_chunks, stride-4 sample unless noted):
grid 256² @ 8 chunks 1.03 (full-stream bfs rank); power-law 120k @ 8 chunks
1.01; RMAT ef=16 scales 14–16 @ 4 chunks 1.09–1.10. Dense skewed graphs
degrade with finer chunking (RMAT ef=16 @ 8 chunks ≈ 1.18–1.25): past the
graph's natural decomposition width, independent chunk orders cannot
replicate the oracle's global sequencing — pick num_chunks for memory, not
parallel slack. Min-rank assignment (the ``parallel_geo_order`` policy) was
measured at 1.8–2.2× here and the load-split variants no better; max-rank
is the difference between a bounded-memory pipeline and a broken one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device
from .graph import Graph
from .ordering import K_MAX_DEFAULT, K_MIN_DEFAULT, _bfs_vertex_rank, geo_order

__all__ = [
    "HierConfig",
    "locality_rank",
    "edge_chunk_key",
    "chunk_load",
    "chunk_splits",
    "chunk_of_edges",
    "order_edge_block",
    "seam_spans",
    "repair_seams",
    "hier_order_edges",
    "hier_order",
]

_SEAM_SALT = 7919  # seed offset lane for seam-repair blocks (prime, arbitrary)


@dataclasses.dataclass(frozen=True)
class HierConfig:
    """Knobs of the hierarchical pipeline. ``max_chunk_edges`` is the
    out-of-core memory bound (soft only by one vertex's keyed degree: edges
    sharing a max-rank endpoint cannot be split apart); ``rank_mode`` picks
    the locality rank — "geo" (first touch of the sample's GEO order, best
    on skewed graphs) or "bfs" (wavefront rank; computable semi-externally
    from the FULL edge stream with V-sized state, which low-degree graphs
    need because sparse samples of them fragment). ``chunk_mode`` picks the
    per-chunk orderer — "host" = ``geo_order``, "device" = the full-reorder
    greedy on a torch device, "mirror" = its byte-exact numpy twin (the
    differential oracle). Device/mirror fall back to "host" when the
    greedy's int32 priority bound does not fit."""

    num_chunks: int = 8
    max_chunk_edges: int = 1 << 17
    seam_window: int = 2048
    k_min: int = K_MIN_DEFAULT
    k_max: int = K_MAX_DEFAULT
    seed: int = 0
    rank_mode: str = "geo"  # geo | bfs
    chunk_mode: str = "host"  # host | device | mirror

    def __post_init__(self):
        if self.num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        if self.max_chunk_edges < 1:
            raise ValueError("max_chunk_edges must be >= 1")
        if self.rank_mode not in ("geo", "bfs"):
            raise ValueError(f"unknown rank_mode {self.rank_mode!r}")
        if self.chunk_mode not in ("host", "device", "mirror"):
            raise ValueError(f"unknown chunk_mode {self.chunk_mode!r}")


# ------------------------------------------------------------------ 1. rank
def locality_rank(
    sample: np.ndarray, num_vertices: int, seed: int = 0, mode: str = "geo"
) -> np.ndarray:
    """(V,) vertex rank of the sampled subgraph — the locality coordinate
    every other stage splits on.

    mode "geo": GEO-order the sample and rank vertices by FIRST TOUCH in
    that order — the sequence GEO itself discovers them in, which is what
    chunk assignment should approximate. mode "bfs": wavefront rank. Both
    cover vertices absent from the sample (appended after all touched
    vertices in id order / BFS restarts), as isolated singletons."""
    sample = np.asarray(sample, dtype=np.int64).reshape(-1, 2)
    g = Graph.from_edges(sample, num_vertices)
    if mode == "bfs":
        return _bfs_vertex_rank(g, seed)
    if mode != "geo":
        raise ValueError(f"unknown rank mode {mode!r}")
    order = geo_order(g, seed=seed)
    first = np.full(num_vertices, np.iinfo(np.int64).max, dtype=np.int64)
    pos = np.arange(g.num_edges, dtype=np.int64)
    np.minimum.at(first, g.src[order], pos)
    np.minimum.at(first, g.dst[order], pos)
    rank = np.empty(num_vertices, dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(num_vertices)
    return rank


# ---------------------------------------------------------------- 2. splits
def edge_chunk_key(rank: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n,) rank-line coordinate of each edge: its MAX-rank endpoint. The
    edge travels to its later-discovered endpoint — hub edges scatter to
    their non-hub endpoints' ranges (vertex-cut on hubs), which is what
    keeps per-range load smooth enough to cut at equal load."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return np.maximum(rank[edges[:, 0]], rank[edges[:, 1]])


def chunk_load(rank: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(V,) edges keyed to each rank — ONE shard's contribution to the load
    histogram. Out-of-core: each process bincounts its shards and the
    histograms add (collective sum); in-core: one call over all edges."""
    return np.bincount(edge_chunk_key(rank, edges), minlength=int(rank.shape[0]))


def chunk_splits(load: np.ndarray, cfg: HierConfig) -> np.ndarray:
    """(C+1,) ascending rank-space chunk bounds (0 … V) cutting the summed
    load histogram at equal load, with enough chunks that none exceeds
    ``cfg.max_chunk_edges`` (within one rank's keyed degree — a single rank
    value cannot be split). Pure in (load, cfg) — all processes holding the
    summed histogram derive identical splits."""
    load = np.asarray(load, dtype=np.int64).reshape(-1)
    v_total = int(load.shape[0])
    total = int(load.sum())
    parts = min(max(cfg.num_chunks, -(-total // cfg.max_chunk_edges)), max(1, v_total))
    cum = np.concatenate([[0], np.cumsum(load)])  # cum[r] = edges keyed below rank r
    splits = [0]
    if parts > 1:
        targets = total * np.arange(1, parts) / parts
        for b in np.searchsorted(cum, targets, side="left"):
            b = int(min(max(int(b), splits[-1] + 1), v_total - 1))
            if b > splits[-1]:
                splits.append(b)
    splits.append(v_total)
    return np.asarray(splits, dtype=np.int64)


def chunk_of_edges(splits: np.ndarray, rank: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n,) chunk id of each edge — the range holding its max-rank endpoint."""
    key = edge_chunk_key(rank, edges)
    return np.searchsorted(np.asarray(splits), key, side="right") - 1


# ----------------------------------------------------------- 3. chunk order
def _chunk_device(cfg: HierConfig, device) -> Optional[torch.device]:
    """The torch device chunk mode "device" orders on; None for the other
    modes, which never read ``device``."""
    return resolve_device(device) if cfg.chunk_mode == "device" else None


def _order_unique(
    uedges: np.ndarray, nv: int, cfg: HierConfig, seed: int, device: Optional[torch.device]
) -> np.ndarray:
    """Permutation of unique canonical edge rows. Host = geo_order; device /
    mirror = the full-reorder greedy (falls back to host when its int32
    priority bound does not fit — out-of-core chunks must never abort)."""
    if cfg.chunk_mode in ("device", "mirror"):
        from ..kernels import full_reorder as FRK

        deg = np.bincount(uedges.reshape(-1), minlength=nv)
        if FRK.greedy_fits_int32(uedges.shape[0], cfg.k_min, cfg.k_max, int(deg.max())):
            alpha, beta, delta = FRK.greedy_params(
                uedges.shape[0], cfg.k_min, cfg.k_max, int(deg.max())
            )
            permpos = FRK.fallback_positions(nv, seed)
            valid = np.ones(uedges.shape[0], dtype=bool)
            if cfg.chunk_mode == "mirror":
                return FRK.full_order_host(
                    uedges[:, 0], uedges[:, 1], valid, nv, alpha, beta, delta, permpos
                )
            steps = None  # the kernel counts its own steps on a card
            if device.type == "cpu":  # the plain version runs the mirror's step count
                steps = FRK._full_order_host(
                    uedges[:, 0], uedges[:, 1], valid, nv, alpha, beta, delta, permpos
                )[1]

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

            order = FRK.full_order_device(
                put(uedges[:, 0]),
                put(uedges[:, 1]),
                torch.ones(uedges.shape[0], dtype=torch.bool, device=device),
                nv,
                alpha,
                beta,
                delta,
                put(permpos),
                steps=steps,
            )
            return order.cpu().numpy().astype(np.int64)
        # fall through: host geo_order below
    g = Graph.from_edges(uedges, nv)
    # Map the Graph's canonical edge ids back to uedges rows (uedges is
    # unique + canonical, so the key lookup is a bijection).
    key_rows = uedges[:, 0] * np.int64(nv) + uedges[:, 1]
    sort_idx = np.argsort(key_rows)
    key_sub = g.src.astype(np.int64) * np.int64(nv) + g.dst
    lookup = sort_idx[np.searchsorted(key_rows[sort_idx], key_sub)]
    return lookup[geo_order(g, cfg.k_min, cfg.k_max, seed=seed)]


def order_edge_block(
    edges: np.ndarray, cfg: HierConfig, seed: int = 0, *, device=None
) -> np.ndarray:
    """Permutation of block rows GEO-ordering one edge block in isolation.

    The block's vertex set is compacted first (greedy state sized by the
    block, not the graph — the point of out-of-core chunking). Duplicate rows
    are allowed: the unique edge SET is ordered, then every row follows its
    key's first occurrence (duplicates adjacent — zero locality cost). Used
    for both chunk bodies and seam windows. ``device`` is read by chunk
    mode "device" only (``None`` means ``"cuda"``)."""
    dev = _chunk_device(cfg, device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    n = edges.shape[0]
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    verts = np.unique(edges)
    local = np.searchsorted(verts, edges)  # (n, 2) compacted ids
    nv = int(verts.shape[0])
    key = local[:, 0] * np.int64(nv) + local[:, 1]
    uk, inverse = np.unique(key, return_inverse=True)
    uedges = np.stack([uk // nv, uk % nv], axis=1)
    uorder = _order_unique(uedges, nv, cfg, seed, dev)
    pos = np.empty(uk.shape[0], dtype=np.int64)
    pos[uorder] = np.arange(uk.shape[0])
    return np.lexsort((np.arange(n), pos[inverse]))


# ------------------------------------------------------------ 4. seam repair
def seam_spans(chunk_sizes, seam_window: int) -> list:
    """[(lo, hi)] global index spans around each interior chunk boundary.

    Each side is clamped to half its chunk, so consecutive spans never
    overlap: repairs are independent, order-free, and a process can repair
    exactly the seams adjacent to the chunks it owns."""
    sizes = [int(s) for s in chunk_sizes]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    spans = []
    for i in range(len(sizes) - 1):
        w_l = min(int(seam_window), sizes[i] // 2)
        w_r = min(int(seam_window), sizes[i + 1] // 2)
        if w_l == 0 or w_r == 0:
            continue  # degenerate boundary (an empty/1-edge side): nothing to blend
        spans.append((int(bounds[i + 1] - w_l), int(bounds[i + 1] + w_r)))
    return spans


def repair_seams(
    ordered: np.ndarray,
    chunk_sizes,
    cfg: HierConfig,
    base_seed: Optional[int] = None,
    *,
    device=None,
) -> np.ndarray:
    """Re-order the edges inside every seam span in place (returns a copy).
    Each window is its own ``order_edge_block`` — pure in (window, seed), so
    distributed repair of disjoint seams reproduces this exactly."""
    dev = _chunk_device(cfg, device)
    seed0 = cfg.seed if base_seed is None else base_seed
    out = np.array(ordered, dtype=np.int64, copy=True).reshape(-1, 2)
    for i, (lo, hi) in enumerate(seam_spans(chunk_sizes, cfg.seam_window)):
        perm = order_edge_block(out[lo:hi], cfg, seed=seed0 + _SEAM_SALT * (i + 1), device=dev)
        out[lo:hi] = out[lo:hi][perm]
    return out


# ------------------------------------------------------------- end-to-end
def hier_order_edges(
    edges: np.ndarray,
    num_vertices: int,
    cfg: HierConfig,
    sample: Optional[np.ndarray] = None,
    *,
    device=None,
) -> tuple[np.ndarray, dict]:
    """In-core reference composition of the whole pipeline over an edge VALUE
    array (duplicates allowed): rank → splits → per-chunk order → concat →
    seam repair. Returns (ordered copy, info). The out-of-core harness runs
    the same primitives without ever concatenating — this function is the
    differential oracle for it at small scale."""
    dev = _chunk_device(cfg, device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if sample is None:
        sample = edges
    rank = locality_rank(sample, num_vertices, cfg.seed, mode=cfg.rank_mode)
    splits = chunk_splits(chunk_load(rank, edges), cfg)
    cid = chunk_of_edges(splits, rank, edges)
    num_chunks = splits.shape[0] - 1
    parts, sizes = [], []
    for c in range(num_chunks):
        block = edges[cid == c]
        sizes.append(int(block.shape[0]))
        if block.shape[0] == 0:
            continue
        perm = order_edge_block(block, cfg, seed=cfg.seed + c, device=dev)
        parts.append(block[perm])
    ordered = (
        np.concatenate(parts, axis=0) if parts else np.empty((0, 2), dtype=np.int64)
    )
    ordered = repair_seams(ordered, sizes, cfg, device=dev)
    info = {"splits": splits, "chunk_sizes": sizes, "num_chunks": num_chunks}
    return ordered, info


def hier_order(g: Graph, cfg: HierConfig, *, device=None) -> tuple[np.ndarray, dict]:
    """Permutation form over a Graph (unique canonical edges): the drop-in
    differential counterpart of ``geo_order`` for RF comparisons."""
    edges = np.stack([g.src, g.dst], axis=1).astype(np.int64)
    ordered, info = hier_order_edges(edges, g.num_vertices, cfg, device=device)
    key = edges[:, 0] * np.int64(g.num_vertices) + edges[:, 1]
    sort_idx = np.argsort(key)
    okey = ordered[:, 0] * np.int64(g.num_vertices) + ordered[:, 1]
    perm = sort_idx[np.searchsorted(key[sort_idx], okey)]
    return perm.astype(np.int64), info
