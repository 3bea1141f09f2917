"""Vertex-cut graph engine on packed CEP edge chunks — the paper's §6.4
workloads (PageRank / SSSP / WCC) on one device.

``EngineData`` is the replicated pack of the JAX package (DESIGN.md §6): one
``(k, E_max, 2)`` int32 edge buffer with partition p at row p, a
``(k, E_max)`` f32 padding mask and ``(V,)`` f32 degrees, all on one device.
Packing is host arithmetic over the ordered edge list; the buffers then move
to the device, where the degrees and the quality metrics (mirrors,
replication factor) are measured — the per-chunk distinct-vertex counts
through the CUDA ``segment_rf`` kernel (kernels/ops.py).

``ShardedEngineData`` is the same pack laid out over the ``graph`` axis
(``launch/sharding.py``): the streaming engine keeps its live pack in it. This
package runs a world of one rank, where the two layouts are bit-identical and
the GAS apps take either.

The GAS apps keep the JAX package's update rules, written as ``index_add_``
and ``scatter_reduce_(…, "amin")`` on the data's device. Float sums are taken
in another order than XLA's (CUDA scatter-add uses atomics), so PageRank
agrees with the JAX package to a tolerance; SSSP and WCC take minima of
integer-valued floats and agree exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compat import resolve_device
from ..core import cep
from ..core.graph import Graph
from ..kernels import ops
from ..launch import sharding as SH

__all__ = [
    "EngineData",
    "build_engine_data",
    "host_pack",
    "pack_ordered",
    "unpack_ordered",
    "cep_engine_data",
    "engine_data_from_arrays",
    "ShardedEngineData",
    "shard_engine_data",
    "unshard_engine_data",
    "host_pack_slots",
    "pack_slots",
    "pagerank",
    "sssp",
    "wcc",
    "comm_volume_per_iteration",
]


@dataclasses.dataclass(frozen=True)
class EngineData:
    edges: torch.Tensor  # (k, E_max, 2) int32 — undirected, both endpoints
    mask: torch.Tensor  # (k, E_max) f32 1/0 padding mask
    degrees: torch.Tensor  # (V,) f32
    num_vertices: int
    k: int
    mirrors: int  # Σ_p |V(E_p)| − |V(E)| — the paper's comm-volume metric
    replication_factor: float
    num_edges: int = 0  # total valid (unpadded) edges across partitions


def host_pack(src_ordered: np.ndarray, dst_ordered: np.ndarray, k: int, e_max: int | None = None):
    """Host buffers of the CEP pack: partition p owns ordered edge ids
    [bounds[p], bounds[p+1]), stored in list order at the head of row p.
    Returns numpy ``(edges (k, E_max, 2) int32, mask (k, E_max) f32)``."""
    e = int(src_ordered.shape[0])
    b = cep.chunk_bounds(e, k)
    sizes = np.diff(b)
    if e_max is None:
        e_max = int(sizes.max())
    elif e_max < int(sizes.max()):
        raise ValueError(f"e_max={e_max} is below the largest chunk ({int(sizes.max())})")
    edges = np.zeros((k, e_max, 2), dtype=np.int32)
    mask = np.zeros((k, e_max), dtype=np.float32)
    for p in range(k):
        lo, hi = int(b[p]), int(b[p + 1])
        c = hi - lo
        edges[p, :c, 0] = src_ordered[lo:hi]
        edges[p, :c, 1] = dst_ordered[lo:hi]
        mask[p, :c] = 1.0
    return edges, mask


def _on_device(edges, mask, num_vertices: int, k: int, num_edges: int, device) -> EngineData:
    """Move host buffers to ``device`` and measure degrees, mirrors and RF there."""
    dev = resolve_device(device)
    edges_t = torch.from_numpy(edges).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    ends = edges_t[mask_t > 0].reshape(-1).long()
    # Counts below 2**24 are exact in f32, as np.add.at's f32 sums are.
    degrees = torch.bincount(ends, minlength=num_vertices).float()
    counts = ops.chunk_vertex_counts_packed(edges_t, mask_t)
    total = int(counts.sum())
    present = int((degrees > 0).sum())
    return EngineData(
        edges=edges_t,
        mask=mask_t,
        degrees=degrees,
        num_vertices=num_vertices,
        k=k,
        mirrors=total - present,
        replication_factor=float(total) / float(num_vertices),
        num_edges=num_edges,
    )


def build_engine_data(g: Graph, part: np.ndarray, k: int, *, device=None) -> EngineData:
    """Pack per-partition edge chunks (padded to a common max) + quality metrics."""
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=k)
    e_max = int(counts.max())
    edges = np.zeros((k, e_max, 2), dtype=np.int32)
    mask = np.zeros((k, e_max), dtype=np.float32)
    src, dst = g.src[order], g.dst[order]
    off = 0
    for p in range(k):
        c = int(counts[p])
        edges[p, :c, 0] = src[off : off + c]
        edges[p, :c, 1] = dst[off : off + c]
        mask[p, :c] = 1.0
        off += c
    return _on_device(edges, mask, g.num_vertices, k, g.num_edges, device)


def pack_ordered(
    src_ordered: np.ndarray,
    dst_ordered: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    e_max: int | None = None,
    device=None,
) -> EngineData:
    """Pack CEP chunks of an already-ordered edge list: partition p owns
    ordered edge ids [bounds[p], bounds[p+1]), stored *in list order*.

    This partition-major layout is exactly what elastic/rescale_exec.py's
    range copies preserve, so an executed k_old → k_new migration is
    bit-comparable against a from-scratch pack at k_new.

    ``e_max`` overrides the per-partition row width: passing a value larger
    than the biggest chunk leaves masked slack rows at each partition's tail.
    Mirrors and replication factor are measured on ``device`` by the
    ``segment_rf`` kernel.
    """
    edges, mask = host_pack(src_ordered, dst_ordered, k, e_max)
    return _on_device(edges, mask, num_vertices, k, int(src_ordered.shape[0]), device)


def unpack_ordered(data: EngineData) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of pack_ordered: the flat ordered (src, dst) lists."""
    edges = data.edges.cpu().numpy()
    counts = data.mask.cpu().numpy().astype(bool).sum(axis=1)
    src = np.concatenate([edges[p, : counts[p], 0] for p in range(data.k)])
    dst = np.concatenate([edges[p, : counts[p], 1] for p in range(data.k)])
    return src, dst


def cep_engine_data(g: Graph, order: np.ndarray, k: int, *, device=None) -> EngineData:
    return pack_ordered(g.src[order], g.dst[order], g.num_vertices, k, device=device)


def engine_data_from_arrays(
    edges,
    mask,
    degrees,
    *,
    num_vertices: int,
    k: int,
    mirrors: int,
    replication_factor: float,
    num_edges: int,
    device=None,
) -> EngineData:
    """An ``EngineData`` on ``device`` from host arrays of the same layout —
    e.g. a JAX package pack read out with ``np.asarray``. Dtypes must already
    be int32 / f32 / f32; nothing is converted silently."""
    dev = resolve_device(device)
    arrays = {"edges": (edges, np.int32, 3), "mask": (mask, np.float32, 2), "degrees": (degrees, np.float32, 1)}
    out = {}
    for name, (a, dtype, ndim) in arrays.items():
        a = np.asarray(a)
        if a.dtype != dtype or a.ndim != ndim:
            raise TypeError(f"{name} must be a {ndim}-D {np.dtype(dtype)} array, got {a.ndim}-D {a.dtype}")
        out[name] = torch.from_numpy(np.array(a)).to(dev)  # a copy: the input may be read-only
    return EngineData(
        **out,
        num_vertices=int(num_vertices),
        k=int(k),
        mirrors=int(mirrors),
        replication_factor=float(replication_factor),
        num_edges=int(num_edges),
    )


# ------------------------------------------------------------ sharded layout
def _check_world(g: int) -> None:
    if g != 1:
        raise NotImplementedError(
            f"a graph axis of {g} ranks: the multi-rank layout is ROADMAP.md queue A2; "
            "this package runs a world of one rank"
        )


@dataclasses.dataclass(frozen=True)
class ShardedEngineData:
    """``EngineData`` laid out over the ``graph`` axis of g ranks.

    ``edges``/``mask`` are (k_pad, E_max, 2) / (k_pad, E_max) with
    k_pad = ⌈k/g⌉·g, rows in rank-major round-robin order (partition p on rank
    p % g, at row ``launch.sharding.partition_row(p, k, g)``). Rows whose
    partition id ≥ k are padding: all-zero, fully masked. ``degrees`` is
    replicated. The layout is written for any g; this package runs a world of
    one rank (g = 1), where it is bit-identical to ``EngineData``, and the GAS
    apps take it unchanged."""

    edges: torch.Tensor  # (k_pad, E_max, 2) int32
    mask: torch.Tensor  # (k_pad, E_max) f32
    degrees: torch.Tensor  # (V,) f32, replicated
    num_vertices: int
    k: int  # logical partition count (rows may exceed it)
    devices: int  # g, the graph-axis size (the reference carries its mesh here)
    mirrors: int
    replication_factor: float
    num_edges: int = 0

    @property
    def k_pad(self) -> int:
        return int(self.edges.shape[0])

    @property
    def rows_per_device(self) -> int:
        return self.k_pad // self.devices

    def partition_device(self, p: int) -> int:
        return SH.partition_device(p, self.devices)


def _partition_rows(k: int, g: int, device) -> torch.Tensor:
    return torch.tensor([SH.partition_row(p, k, g) for p in range(k)], dtype=torch.int64, device=device)


def shard_engine_data(data: EngineData, g: int = 1) -> ShardedEngineData:
    """Lay a packed ``EngineData`` out over a graph axis of ``g`` ranks, on
    the data's device. g > 1 raises ``NotImplementedError``."""
    _check_world(g)
    k = data.k
    k_pad = SH.padded_partition_count(k, g)
    e_max = int(data.edges.shape[1])
    dev = data.edges.device
    rows = _partition_rows(k, g, dev)
    edges = torch.zeros((k_pad, e_max, 2), dtype=torch.int32, device=dev)
    mask = torch.zeros((k_pad, e_max), dtype=torch.float32, device=dev)
    edges[rows] = data.edges
    mask[rows] = data.mask
    return ShardedEngineData(
        edges=edges,
        mask=mask,
        degrees=data.degrees.clone(),
        num_vertices=data.num_vertices,
        k=k,
        devices=g,
        mirrors=data.mirrors,
        replication_factor=data.replication_factor,
        num_edges=data.num_edges,
    )


def unshard_engine_data(sdata: ShardedEngineData) -> EngineData:
    """Inverse of ``shard_engine_data``: rows un-permuted back to the
    partition-major pack (the bit-identity oracle layout), on the same device."""
    _check_world(sdata.devices)
    rows = _partition_rows(sdata.k, sdata.devices, sdata.edges.device)
    return EngineData(
        edges=sdata.edges[rows],
        mask=sdata.mask[rows],
        degrees=sdata.degrees.clone(),
        num_vertices=sdata.num_vertices,
        k=sdata.k,
        mirrors=sdata.mirrors,
        replication_factor=sdata.replication_factor,
        num_edges=sdata.num_edges,
    )


# ------------------------------------------------------------- slot layout
def host_pack_slots(slot_src: np.ndarray, slot_dst: np.ndarray, slot_valid: np.ndarray, k: int, num_vertices: int):
    """Host buffers of the streaming slot pack: numpy ``(edges (k, spr+1, 2)
    int32, mask (k, spr+1) f32, degrees (V,) f32)``. See ``pack_slots``."""
    slot_valid = np.asarray(slot_valid, dtype=bool)
    c = int(slot_valid.shape[0])
    if c % k:
        raise ValueError(f"slot capacity {c} is not a multiple of k={k}")
    spr = c // k
    e_cap = spr + 1  # + scratch column
    edges = np.zeros((k, e_cap, 2), dtype=np.int32)
    mask = np.zeros((k, e_cap), dtype=np.float32)
    edges[:, :spr, 0] = (np.asarray(slot_src) * slot_valid).reshape(k, spr)
    edges[:, :spr, 1] = (np.asarray(slot_dst) * slot_valid).reshape(k, spr)
    mask[:, :spr] = slot_valid.reshape(k, spr).astype(np.float32)
    # Integer counts, exact in f32 below 2^24 — the JAX package's np.add.at of
    # f32 ones gives the same bytes there, an order of magnitude slower.
    deg = (
        np.bincount(np.asarray(slot_src)[slot_valid], minlength=num_vertices)
        + np.bincount(np.asarray(slot_dst)[slot_valid], minlength=num_vertices)
    ).astype(np.float32)
    return edges, mask, deg


def pack_slots(
    slot_src: np.ndarray,
    slot_dst: np.ndarray,
    slot_valid: np.ndarray,
    k: int,
    num_vertices: int,
    *,
    device=None,
) -> EngineData:
    """Pack a streaming slot array (stream/incremental.py) into engine buffers.

    Region p's ``slots_per_region`` slots become partition p's first columns —
    occupied slots keep their column (gaps are masked rows interleaved in
    place, not compacted, so a host slot maps 1:1 to a device (row, col) and
    an EdgeUpdateBatch applies as a scatter) — plus one trailing always-masked
    scratch column that padded scatter ops target (stream/ingest.py). GAS
    algorithms are mask-driven and run unchanged on this layout. This is the
    streaming bit-identity oracle: it is built on the host and uploaded, and
    on-device ingest must equal it byte for byte.
    """
    edges, mask, deg = host_pack_slots(slot_src, slot_dst, slot_valid, k, num_vertices)
    dev = resolve_device(device)
    # Quality metrics are monitored incrementally by the orderer, not carried
    # on the pack (same convention as ElasticRescaler's recheck=False).
    return EngineData(
        edges=torch.from_numpy(edges).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        degrees=torch.from_numpy(deg).to(dev),
        num_vertices=num_vertices,
        k=k,
        mirrors=-1,
        replication_factor=float("nan"),
        num_edges=int(np.count_nonzero(slot_valid)),
    )


def _endpoints(data: EngineData):
    e = data.edges.reshape(-1, 2).long()
    return e[:, 0], e[:, 1], data.mask.reshape(-1)


def pagerank(data: EngineData, *, iterations: int = 20, damping: float = 0.85) -> torch.Tensor:
    v = data.num_vertices
    src, dst, m = _endpoints(data)
    deg = torch.clamp(data.degrees, min=1.0)
    dangling = data.degrees == 0
    x = torch.full((v,), 1.0 / v, dtype=torch.float32, device=data.edges.device)
    for _ in range(iterations):
        contrib = x / deg
        # Undirected: each edge pushes both ways (vertex-cut GAS scatter).
        y = torch.zeros_like(x)
        y.index_add_(0, dst, contrib[src] * m)
        y.index_add_(0, src, contrib[dst] * m)
        # Dangling vertices spread their mass uniformly (networkx convention).
        dm = torch.where(dangling, x, 0.0).sum()
        x = (1 - damping) / v + damping * (y + dm / v)
    return x


def _min_propagate(data: EngineData, x0: torch.Tensor, step: float, max_iters: int):
    """Iterate x ← min(x, min over edges of x[neighbour] + step) until nothing
    changes or ``max_iters``; returns (x, iterations run)."""
    big = 1e9
    src, dst, m = _endpoints(data)
    valid = m > 0
    x, it, changed = x0, 0, True
    while changed and it < max_iters:
        cand = torch.full_like(x, big)
        cand.scatter_reduce_(0, dst, torch.where(valid, x[src] + step, big), "amin")
        cand.scatter_reduce_(0, src, torch.where(valid, x[dst] + step, big), "amin")
        nx = torch.minimum(x, cand)
        changed = bool((nx < x).any())
        x, it = nx, it + 1
    return x, it


def sssp(data: EngineData, *, source: int = 0, max_iters: int = 64) -> tuple[torch.Tensor, int]:
    d0 = torch.full((data.num_vertices,), 1e9, dtype=torch.float32, device=data.edges.device)
    d0[source] = 0.0
    return _min_propagate(data, d0, 1.0, max_iters)


def wcc(data: EngineData, *, max_iters: int = 64) -> tuple[torch.Tensor, int]:
    l0 = torch.arange(data.num_vertices, dtype=torch.float32, device=data.edges.device)
    return _min_propagate(data, l0, 0.0, max_iters)


def comm_volume_per_iteration(data: EngineData, bytes_per_value: int = 8) -> int:
    """Paper §6.4 COM metric: each mirror sends + receives one value/iteration."""
    return 2 * data.mirrors * bytes_per_value
