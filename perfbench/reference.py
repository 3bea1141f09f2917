"""The plain reference: what a rescale and a query must give, worked out again.

Plain PyTorch on the benchmark's own ordered edge list, with the frozen CEP
arithmetic of ``cep.py``. It imports nothing of the program and takes
nothing the program made. Each answer is computed another way than the
program computes it where a plain way exists:

* the pack at k: one slice copy a chunk into a zeroed ``(k, ⌈n/k⌉)`` block;
* the mirrors at k: Σ_p |V(E_p)| − |V(E)|, counted for every k from the
  endpoint occurrences sorted by (vertex, ordered id), a range of vertex ids
  at a time, where the program sorts each chunk's ids and counts the
  boundaries;
* PageRank in float64 (the program computes in float32);
* SSSP (unit weights) as a breadth-first search by frontiers, with the
  sweep count of the program's synchronous relaxation, ``min(ecc + 1,
  max_iters)``;
* WCC as synchronous min-label propagation over int64 labels.

``dtype`` lowers PageRank's, SSSP's and WCC's precision: the control runs
them in bfloat16 in the program's place.
"""
from __future__ import annotations

import torch

from . import cep

UNREACHED = 1e9  # the program's distance of a vertex that no sweep reached


def pack(src: torch.Tensor, dst: torch.Tensor, k: int):
    """The CEP pack of the ordered list at k: ``(k, ⌈n/k⌉, 2)`` int32 edges
    and ``(k, ⌈n/k⌉)`` float32 mask, chunk p at the head of row p."""
    n = src.numel()
    bounds, width = cep.chunk_bounds(n, k).tolist(), cep.chunk_max(n, k)
    edges = torch.zeros((k, width, 2), dtype=torch.int32, device=src.device)
    mask = torch.zeros((k, width), dtype=torch.float32, device=src.device)
    for p in range(k):
        lo, hi = bounds[p], bounds[p + 1]
        edges[p, : hi - lo, 0] = src[lo:hi]
        edges[p, : hi - lo, 1] = dst[lo:hi]
        mask[p, : hi - lo] = 1.0
    return edges, mask


def slots_wrong(edges: torch.Tensor, mask: torch.Tensor, want_edges: torch.Tensor, want_mask: torch.Tensor) -> int:
    """Slots whose edge or mask differs from the reference's; every slot of
    either side where the shapes differ."""
    if edges.shape != want_edges.shape or mask.shape != want_mask.shape:
        return max(mask.numel(), want_mask.numel())
    return int(((edges != want_edges).any(dim=-1) | (mask != want_mask)).sum())


MIRROR_BLOCK = 1 << 27  # endpoint occurrences that ``mirrors`` sorts at once (about)


def mirrors(src: torch.Tensor, dst: torch.Tensor, ks) -> dict:
    """``{k: Σ_p |V(E_p)| − |V(E)|}`` for every k in ``ks``.

    Sorted by ordered id, a vertex's occurrences fall into its chunks in
    runs, so the chunks that hold it number one more than the pairs of its
    successive occurrences that lie in different chunks. Summed over the
    vertices, the mirrors at k are those pairs. The vertex ids are cut into
    ranges of about ``MIRROR_BLOCK`` occurrences (one vertex's whole,
    whatever its degree), and each range's occurrences are sorted once, by
    (vertex, ordered id), and its pairs counted for every k. Beyond ``src`` and
    ``dst`` the working memory is the degrees and one range's sort and
    pairs, whatever n: 7.5 GB on an H100, at 260M and at 1.05G edges alike."""
    n, block = src.numel(), MIRROR_BLOCK
    ks = sorted(set(int(k) for k in ks))
    counts = torch.zeros(len(ks), dtype=torch.int64, device=src.device)
    if n:
        v = int(torch.maximum(src.max(), dst.max())) + 1
        ends = torch.cumsum(torch.bincount(src, minlength=v) + torch.bincount(dst, minlength=v), 0)
        starts = torch.arange(1, -(-2 * n // block), device=src.device) * block  # of every range but the first
        cuts = sorted(set(torch.searchsorted(ends, starts, right=True).tolist()) | {0, v})  # each range's first vertex
        del ends, starts
        for v0, v1 in zip(cuts, cuts[1:]):
            keys = []
            for ids in (src, dst):
                at = torch.nonzero((ids >= v0) & (ids < v1)).squeeze(1)
                keys.append(((ids[at].long() - v0) << 31) | at)  # (vertex, ordered id): every id is below 2**31
                del at
            key = torch.sort(torch.cat(keys)).values
            del keys
            same = (key[1:] >> 31) == (key[:-1] >> 31)
            pos = (key & (2**31 - 1)).to(torch.int32)
            del key
            first, then = pos[:-1][same], pos[1:][same]  # successive occurrences of one vertex
            del pos, same
            for i, k in enumerate(ks):
                counts[i] += (cep.chunk_of(first, n, k) != cep.chunk_of(then, n, k)).sum()
            del first, then
    return dict(zip(ks, counts.tolist()))


def pagerank(src, dst, v: int, iterations: int, damping: float, dtype=torch.float64) -> torch.Tensor:
    """PageRank over the undirected edges: each edge pushes both ways, and the
    vertices of degree 0 spread their mass evenly."""
    s, d = src.long(), dst.long()
    deg = (torch.bincount(s, minlength=v) + torch.bincount(d, minlength=v)).to(dtype)
    dangling = deg == 0
    deg = torch.clamp(deg, min=1)
    x = torch.full((v,), 1.0 / v, dtype=dtype, device=src.device)
    for _ in range(iterations):
        share = x / deg
        y = torch.zeros_like(x)
        y.index_add_(0, d, share[s])
        y.index_add_(0, s, share[d])
        x = (1 - damping) / v + damping * (y + x[dangling].sum() / v)
    return x


def sssp(src, dst, v: int, source: int, max_iters: int, dtype=torch.float32):
    """Hop distances from ``source`` by frontiers; ``(dist, sweeps)``. The
    program stops the sweep after the first that changes nothing, or at
    ``max_iters``, so it runs ``min(ecc + 1, max_iters)`` sweeps and knows
    the vertices within that many hops."""
    s, d = src.long(), dst.long()
    level = torch.full((v,), -1, dtype=torch.int32, device=src.device)
    level[source] = 0
    frontier = torch.zeros(v, dtype=torch.bool, device=src.device)
    frontier[source] = True
    depth = 0
    while depth < max_iters:
        reached = torch.zeros_like(frontier)
        reached[d[frontier[s]]] = True
        reached[s[frontier[d]]] = True
        reached &= level < 0
        if not bool(reached.any()):
            break
        depth += 1
        level[reached] = depth
        frontier = reached
    dist = torch.where(level >= 0, level.to(dtype), torch.tensor(UNREACHED, dtype=dtype, device=src.device))
    return dist, min(depth + 1, max_iters)


def wcc(src, dst, v: int, max_iters: int, dtype=torch.int64):
    """Each vertex's smallest reachable label by synchronous min-label
    propagation; ``(labels, sweeps)``, counting the sweep that changes nothing."""
    s, d = src.long(), dst.long()
    lab = torch.arange(v, device=src.device).to(dtype)
    sweeps, changed = 0, True
    while changed and sweeps < max_iters:
        nxt = lab.clone()
        nxt.scatter_reduce_(0, d, lab[s], "amin")
        nxt.scatter_reduce_(0, s, lab[d], "amin")
        changed = bool((nxt < lab).any())
        lab, sweeps = nxt, sweeps + 1
    return lab, sweeps
