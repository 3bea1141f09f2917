"""Graph containers and synthetic generators.

Graphs are undirected and unweighted (paper §2.1). We store them as a
deduplicated COO edge list (``src < dst`` canonical form) plus a CSR adjacency
built over *edge ids*, so ordering algorithms can iterate ``N(v)`` and map each
neighbor edge back to its id in O(1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "rmat_graph",
    "powerlaw_graph",
    "grid_graph",
    "ring_graph",
    "erdos_renyi_graph",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph as canonical COO + CSR-over-edge-ids."""

    num_vertices: int
    src: np.ndarray  # (E,) int32, src[i] < dst[i]
    dst: np.ndarray  # (E,) int32
    # CSR over the *directed doubling* of the edge list: for vertex v,
    # neighbors are nbr[indptr[v]:indptr[v+1]] and the undirected edge id of
    # each is eid[indptr[v]:indptr[v+1]].
    indptr: np.ndarray  # (V+1,) int64
    nbr: np.ndarray  # (2E,) int32
    eid: np.ndarray  # (2E,) int32

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """(neighbor vertices, undirected edge ids) of v, sorted by neighbor id."""
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.nbr[lo:hi], self.eid[lo:hi]

    def edges(self) -> np.ndarray:
        """(E, 2) int32 canonical edge array."""
        return np.stack([self.src, self.dst], axis=1)

    @staticmethod
    def from_edges(edges: np.ndarray, num_vertices: Optional[int] = None) -> "Graph":
        """Build from an (E, 2) array; dedups, removes self loops, canonicalizes."""
        edges = np.asarray(edges, dtype=np.int64)
        if edges.size == 0:
            raise ValueError("empty edge list")
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        if num_vertices is None:
            num_vertices = int(hi.max()) + 1 if hi.size else 0
        key = lo * num_vertices + hi
        _, uniq = np.unique(key, return_index=True)
        lo, hi = lo[uniq], hi[uniq]
        e = lo.shape[0]
        # CSR over directed doubling.
        ds = np.concatenate([lo, hi])
        dd = np.concatenate([hi, lo])
        de = np.concatenate([np.arange(e), np.arange(e)])
        # Sort by (src, dst) so neighbors come out in ascending dst order, as the
        # paper's Alg. 3/4 access "each neighbor edge in ascending order of the
        # destination vertex id". Directed pairs are unique after the dedup
        # above, so the scalar key src·V + dst induces the same total order as
        # lexsort((dd, ds)) at roughly half the cost; bincount likewise beats
        # np.add.at for the degree histogram.
        order = np.argsort(ds * np.int64(num_vertices) + dd, kind="stable")
        ds, dd, de = ds[order], dd[order], de[order]
        indptr = np.zeros(num_vertices + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(ds, minlength=num_vertices))
        return Graph(
            num_vertices=int(num_vertices),
            src=lo.astype(np.int32),
            dst=hi.astype(np.int32),
            indptr=indptr,
            nbr=dd.astype(np.int32),
            eid=de.astype(np.int32),
        )


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Graph:
    """R-MAT generator (paper Fig. 15 uses RMAT with edge factors 16..40)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    p = np.array([a, b, c, 1.0 - a - b - c])
    for bit in range(scale):
        q = rng.choice(4, size=m, p=p)
        src |= ((q >> 1) & 1).astype(np.int64) << bit
        dst |= (q & 1).astype(np.int64) << bit
    # Permute vertex ids so "default order" carries no locality.
    perm = rng.permutation(n)
    return Graph.from_edges(np.stack([perm[src], perm[dst]], axis=1), n)


def powerlaw_graph(num_vertices: int, alpha: float = 2.4, seed: int = 0) -> Graph:
    """Clauset power-law degree model (paper Eq. 11, d_min = 1) via stub matching."""
    rng = np.random.default_rng(seed)
    d_max = max(2, int(np.sqrt(num_vertices)))
    ds = np.arange(1, d_max + 1, dtype=np.float64)
    pr = ds**-alpha
    pr /= pr.sum()
    deg = rng.choice(np.arange(1, d_max + 1), size=num_vertices, p=pr)
    stubs = np.repeat(np.arange(num_vertices), deg)
    rng.shuffle(stubs)
    if stubs.shape[0] % 2:
        stubs = stubs[:-1]
    e = stubs.reshape(-1, 2)
    return Graph.from_edges(e, num_vertices)


def grid_graph(side: int) -> Graph:
    """2D grid — a non-skewed graph standing in for Road-CA."""
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return Graph.from_edges(np.concatenate([right, down]), side * side)


def ring_graph(n: int) -> Graph:
    v = np.arange(n)
    return Graph.from_edges(np.stack([v, (v + 1) % n], axis=1), n)


def erdos_renyi_graph(num_vertices: int, avg_degree: float = 8.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree / 2)
    e = rng.integers(0, num_vertices, size=(int(m * 1.2), 2))
    return Graph.from_edges(e, num_vertices)
