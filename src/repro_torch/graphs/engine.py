"""Vertex-cut graph engine on packed CEP edge chunks — the paper's §6.4
workloads (PageRank / SSSP / WCC) on one device.

``EngineData`` is the replicated pack of the JAX package (DESIGN.md §6): one
``(k, E_max, 2)`` int32 edge buffer with partition p at row p, a
``(k, E_max)`` f32 padding mask and ``(V,)`` f32 degrees, all on one device.
Packing is host arithmetic over the ordered edge list; the buffers then move
to the device, where the degrees and the quality metrics (mirrors,
replication factor) are measured — the per-chunk distinct-vertex counts
through the CUDA ``segment_rf`` kernel (kernels/ops.py).

``ShardedEngineData`` is the same pack laid out over the ``graph`` axis of g
torch.distributed ranks (``launch/sharding.py``, ``launch/mesh.py``): each
rank holds its row block on its own device, and the streaming engine keeps its
live pack in it (``pack_slots_sharded`` / ``pack_slots_sharded_stream``). A
world of one is the degenerate case, bit-identical to ``EngineData``.

The GAS apps keep the JAX package's update rules: PageRank as ``index_add_``
on the data's device, SSSP's and WCC's min-sweeps as the CUDA kernel
``kernels/min_sweep.py`` on a card (``scatter_reduce_(…, "amin")`` on the
CPU); over a sharded pack each rank scatters its own rows and an
``all_reduce`` (SUM for PageRank, MIN for SSSP and WCC) combines them, as
the reference's ``psum``/``pmin``. Float sums are taken in another order
than XLA's (CUDA scatter-add uses atomics), so PageRank agrees with the JAX
package to a tolerance; SSSP and WCC take minima of integer-valued floats
and agree exactly. ``query_program`` serves the same three apps on the
pack's operands (launch/serve.py), through the same bodies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compat import resolve_device
from ..core import cep
from ..core.graph import Graph
from ..kernels import min_sweep, ops
from ..launch import multihost as MH
from ..launch import sharding as SH
from ..launch.mesh import GraphGroup, make_graph_group
from ..obs import trace as OT

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
    "pack_ordered_sharded",
    "host_pack_slots",
    "pack_slots",
    "pack_slots_sharded",
    "local_slot_partitions",
    "pack_slots_sharded_stream",
    "pagerank",
    "sssp",
    "wcc",
    "comm_volume_per_iteration",
    "QUERY_KINDS",
    "query_program",
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
@dataclasses.dataclass(frozen=True)
class ShardedEngineData:
    """``EngineData`` laid out over the ``graph`` axis of g ranks
    (``launch/mesh.py GraphGroup``).

    The global buffers are (k_pad, E_max, 2) / (k_pad, E_max) with
    k_pad = ⌈k/g⌉·g, rows in rank-major round-robin order (partition p on rank
    p % g, at row ``launch.sharding.partition_row(p, k, g)``). Rows whose
    partition id ≥ k are padding: all-zero, fully masked. Each rank holds only
    its row block [r·m, (r+1)·m), m = k_pad/g, in ``edges``/``mask`` on its
    device; ``degrees`` is replicated. A world of one makes this layout
    bit-identical to ``EngineData``."""

    edges: torch.Tensor  # (m, E_max, 2) int32: this rank's rows
    mask: torch.Tensor  # (m, E_max) f32
    degrees: torch.Tensor  # (V,) f32, replicated
    num_vertices: int
    k: int  # logical partition count (rows may exceed it)
    group: GraphGroup
    mirrors: int
    replication_factor: float
    num_edges: int = 0

    @property
    def devices(self) -> int:
        return self.group.size

    @property
    def k_pad(self) -> int:
        return SH.padded_partition_count(self.k, self.devices)

    @property
    def rows_per_device(self) -> int:
        return int(self.edges.shape[0])

    def partition_device(self, p: int) -> int:
        return SH.partition_device(p, self.devices)

    def local_partitions(self) -> list[int]:
        """Partition id of each of this rank's rows, in row order (ids ≥ k
        are padding rows)."""
        return _block_partitions(self.k, self.group)


def _block_partitions(k: int, group: GraphGroup) -> list[int]:
    g = group.size
    lo, hi = group.row_block(SH.padded_partition_count(k, g))
    return [SH.row_partition(r, k, g) for r in range(lo, hi)]


def _local_rows(edges: np.ndarray, mask: np.ndarray, k: int, group: GraphGroup):
    """This rank's row block of a partition-major host pack, in the sharded
    layout (padding rows all-zero)."""
    parts = _block_partitions(k, group)
    real = [i for i, p in enumerate(parts) if p < k]
    ids = [parts[i] for i in real]
    e_local = np.zeros((len(parts),) + edges.shape[1:], dtype=edges.dtype)
    m_local = np.zeros((len(parts),) + mask.shape[1:], dtype=mask.dtype)
    e_local[real], m_local[real] = edges[ids], mask[ids]
    return e_local, m_local


def shard_engine_data(data: EngineData, group: GraphGroup | None = None) -> ShardedEngineData:
    """Lay a packed ``EngineData`` (every rank holds the same one) out over
    ``group``'s ranks: each keeps its row block, on the data's device. A
    world of one (``group=None``) is the identity permutation: the result
    holds the pack's own tensors, uncopied."""
    if group is None:
        group = make_graph_group(data.edges.device)
    k, g = data.k, group.size
    if g == 1:
        edges, mask = data.edges, data.mask
    else:
        parts = torch.tensor(_block_partitions(k, group), dtype=torch.int64, device=data.edges.device)
        real = parts < k
        edges = torch.zeros((parts.numel(),) + tuple(data.edges.shape[1:]), dtype=data.edges.dtype,
                            device=data.edges.device)
        mask = torch.zeros((parts.numel(),) + tuple(data.mask.shape[1:]), dtype=data.mask.dtype,
                           device=data.mask.device)
        edges[real] = data.edges[parts[real]]
        mask[real] = data.mask[parts[real]]
    return ShardedEngineData(
        edges=edges,
        mask=mask,
        degrees=data.degrees,
        num_vertices=data.num_vertices,
        k=k,
        group=group,
        mirrors=data.mirrors,
        replication_factor=data.replication_factor,
        num_edges=data.num_edges,
    )


def unshard_engine_data(sdata: ShardedEngineData) -> EngineData:
    """Inverse of ``shard_engine_data``: every rank's rows gathered and
    un-permuted back to the partition-major pack (the bit-identity oracle
    layout), on this rank's device. A collective at g > 1 (every rank
    calls it). The result is always a copy, at g = 1 too: callers may keep
    it while the sharded pack is updated in place (the stream engine)."""
    group = sdata.group
    rows = torch.tensor([SH.partition_row(p, sdata.k, sdata.devices) for p in range(sdata.k)],
                        dtype=torch.int64, device=sdata.edges.device)
    return EngineData(
        edges=MH.all_gather_rows(sdata.edges, group)[rows],
        mask=MH.all_gather_rows(sdata.mask, group)[rows],
        degrees=sdata.degrees.clone(),
        num_vertices=sdata.num_vertices,
        k=sdata.k,
        mirrors=sdata.mirrors,
        replication_factor=sdata.replication_factor,
        num_edges=sdata.num_edges,
    )


def pack_ordered_sharded(
    src_ordered: np.ndarray,
    dst_ordered: np.ndarray,
    num_vertices: int,
    k: int,
    group: GraphGroup | None = None,
    *,
    e_max: int | None = None,
    device=None,
) -> ShardedEngineData:
    """``pack_ordered``, distributed: CEP chunks land round-robin on the ranks.

    Every rank packs the replicated host list and uploads only its rows. Each
    measures its partitions' distinct-vertex counts on its device through
    ``ops.chunk_vertex_counts_packed`` (the CUDA ``segment_rf`` kernel on a
    card); mirrors and RF come from one ``all_reduce`` of those sums. Degrees
    are counted on the host from the replicated list (the same f32 integer
    counts ``pack_ordered`` measures). ``group=None`` is a world of one on
    ``device``."""
    if group is None:
        group = make_graph_group(device)
    edges, mask = host_pack(src_ordered, dst_ordered, k, e_max)
    e_local, m_local = _local_rows(edges, mask, k, group)
    del edges, mask
    k_pad = SH.padded_partition_count(k, group.size)
    edges_t = MH.put_global_local(e_local, (k_pad,) + e_local.shape[1:], group)
    mask_t = MH.put_global_local(m_local, (k_pad,) + m_local.shape[1:], group)
    deg = (np.bincount(src_ordered, minlength=num_vertices)
           + np.bincount(dst_ordered, minlength=num_vertices)).astype(np.float32)
    degrees = torch.from_numpy(deg).to(edges_t.device)
    local = ops.chunk_vertex_counts_packed(edges_t, mask_t).sum()
    total = int(MH.all_reduce(local, group, "sum"))
    present = int(np.count_nonzero(deg))
    return ShardedEngineData(
        edges=edges_t,
        mask=mask_t,
        degrees=degrees,
        num_vertices=num_vertices,
        k=k,
        group=group,
        mirrors=total - present,
        replication_factor=float(total) / float(num_vertices),
        num_edges=int(src_ordered.shape[0]),
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


def pack_slots_sharded(
    slot_src: np.ndarray,
    slot_dst: np.ndarray,
    slot_valid: np.ndarray,
    k: int,
    num_vertices: int,
    group: GraphGroup | None = None,
    *,
    device=None,
) -> ShardedEngineData:
    """``pack_slots`` laid out over ``group``'s ranks: every rank packs the
    replicated host slot arrays and uploads only its row block
    (``put_global_local``); the degrees are replicated. No collective, so a
    rank can commit without its peers. Unsharded, the result is byte-identical
    to ``pack_slots``. ``group=None`` is a world of one on ``device``."""
    if group is None:
        group = make_graph_group(device)
    edges, mask, deg = host_pack_slots(slot_src, slot_dst, slot_valid, k, num_vertices)
    e_local, m_local = _local_rows(edges, mask, k, group)
    del edges, mask
    k_pad = SH.padded_partition_count(k, group.size)
    edges_t = MH.put_global_local(e_local, (k_pad,) + e_local.shape[1:], group)
    return ShardedEngineData(
        edges=edges_t,
        mask=MH.put_global_local(m_local, (k_pad,) + m_local.shape[1:], group),
        degrees=torch.from_numpy(deg).to(edges_t.device),
        num_vertices=num_vertices,
        k=k,
        group=group,
        mirrors=-1,
        replication_factor=float("nan"),
        num_edges=int(np.count_nonzero(slot_valid)),
    )


def local_slot_partitions(k: int, group: GraphGroup | None = None) -> list[int]:
    """Partition ids whose buffer rows this rank holds, in row order (ids ≥ k
    are the all-masked padding rows and are omitted). The shard-streamed
    commit materializes exactly these partitions' slots and no others."""
    return [p for p in _block_partitions(k, group or make_graph_group("cpu")) if p < k]


def pack_slots_sharded_stream(
    part_fn,
    k: int,
    num_vertices: int,
    group: GraphGroup | None,
    slots_per_region: int,
    *,
    device=None,
) -> ShardedEngineData:
    """``pack_slots`` committed shard by shard: no full-graph host array.

    ``part_fn(p) -> (slot_src, slot_dst, slot_valid)`` produces ONE
    partition's ``slots_per_region`` slots; it is called only for the
    partitions this rank holds, one at a time, into a staging buffer bounded
    by the local row block. Degrees and the edge count are V-sized
    accumulators merged by ``psum_host``. Unsharded, the result is
    byte-identical to ``pack_slots`` over the concatenated slot arrays.
    ``group=None`` is a world of one on ``device``."""
    if group is None:
        group = make_graph_group(device)
    g = group.size
    k_pad = SH.padded_partition_count(k, g)
    spr = int(slots_per_region)
    e_cap = spr + 1  # + scratch column, as pack_slots
    parts = _block_partitions(k, group)
    edges_local = np.zeros((len(parts), e_cap, 2), dtype=np.int32)
    mask_local = np.zeros((len(parts), e_cap), dtype=np.float32)
    deg_local = np.zeros(num_vertices, dtype=np.int64)
    count_local = 0
    for i, p in enumerate(parts):
        if p >= k:
            continue
        slot_src, slot_dst, slot_valid = part_fn(p)
        slot_valid = np.asarray(slot_valid, dtype=bool)
        if slot_valid.shape[0] != spr:
            raise ValueError(f"partition {p}: got {slot_valid.shape[0]} slots, expected {spr}")
        edges_local[i, :spr, 0] = np.asarray(slot_src) * slot_valid
        edges_local[i, :spr, 1] = np.asarray(slot_dst) * slot_valid
        mask_local[i, :spr] = slot_valid.astype(np.float32)
        deg_local += np.bincount(np.asarray(slot_src)[slot_valid], minlength=num_vertices)
        deg_local += np.bincount(np.asarray(slot_dst)[slot_valid], minlength=num_vertices)
        count_local += int(np.count_nonzero(slot_valid))
    deg = MH.psum_host(deg_local, group).astype(np.float32)  # integer counts, exact in f32 below 2^24
    total = int(MH.psum_host(np.asarray([count_local], dtype=np.int64), group)[0])
    edges_t = MH.put_global_local(edges_local, (k_pad, e_cap, 2), group)
    return ShardedEngineData(
        edges=edges_t,
        mask=MH.put_global_local(mask_local, (k_pad, e_cap), group),
        degrees=torch.from_numpy(deg).to(edges_t.device),
        num_vertices=num_vertices,
        k=k,
        group=group,
        mirrors=-1,
        replication_factor=float("nan"),
        num_edges=total,
    )


# ------------------------------------------------------------------ GAS apps
def _combine(group: GraphGroup | None, y: torch.Tensor, op: str) -> torch.Tensor:
    """The GAS combine over the ``graph`` axis: each rank scattered its own
    rows into ``y``; over a group the ranks' candidates are summed (``psum``)
    or take their minimum (``pmin``), so every rank holds the same vertex
    state. ``group=None`` is the replicated pack, combined already."""
    return y if group is None else MH.all_reduce(y, group, op)


def _group_of(data) -> GraphGroup | None:
    return data.group if isinstance(data, ShardedEngineData) else None


def _pagerank_operands(edges, mask, degrees, v: int, group, iterations: int, damping: float) -> torch.Tensor:
    """PageRank on the pack operands: this rank's rows of ``edges``/``mask``
    and the replicated ``degrees`` (every rank of ``group`` calls it)."""
    e = edges.reshape(-1, 2).long()
    src, dst, m = e[:, 0], e[:, 1], mask.reshape(-1)
    deg = torch.clamp(degrees, min=1.0)
    dangling = degrees == 0
    x = torch.full((v,), 1.0 / v, dtype=torch.float32, device=edges.device)
    for _ in range(iterations):
        contrib = x / deg
        # Undirected: each edge pushes both ways (vertex-cut GAS scatter).
        y = torch.zeros_like(x)
        y.index_add_(0, dst, contrib[src] * m)
        y.index_add_(0, src, contrib[dst] * m)
        y = _combine(group, y, "sum")
        # Dangling vertices spread their mass uniformly (networkx convention).
        dm = torch.where(dangling, x, 0.0).sum()
        x = (1 - damping) / v + damping * (y + dm / v)
    return x


def _min_propagate(edges, mask, group, x0: torch.Tensor, step: float, max_iters: int):
    """Iterate x ← min(x, min over edges of x[neighbour] + step) until nothing
    changes or ``max_iters``; returns (x, iterations run). Each sweep is one
    ``min_sweep`` (the CUDA kernel on a card, its plain version on the CPU).
    Over a ``group`` each rank lowers x with its own rows and the ranks'
    results take their minimum, which is the same on every rank, so every
    rank stops together. Each iteration reads its stop flag on the host, in a
    span ``query.sweep``."""
    x, it, changed = x0, 0, True
    while changed and it < max_iters:
        with OT.span("query.sweep"):  # ends at the stop flag's readback
            nx, flags = min_sweep.min_sweep(edges, mask, x, step)
            changed = min_sweep.changed(flags)
            if group is not None:
                nx = _combine(group, nx, "min")
                changed = bool((nx < x).any())
        x, it = nx, it + 1
    return x, it


def _sssp_operands(edges, mask, v: int, group, source: int, max_iters: int):
    d0 = torch.full((v,), 1e9, dtype=torch.float32, device=edges.device)
    d0[source] = 0.0
    return _min_propagate(edges, mask, group, d0, 1.0, max_iters)


def _wcc_operands(edges, mask, v: int, group, max_iters: int):
    l0 = torch.arange(v, dtype=torch.float32, device=edges.device)
    return _min_propagate(edges, mask, group, l0, 0.0, max_iters)


def pagerank(data, *, iterations: int = 20, damping: float = 0.85) -> torch.Tensor:
    """PageRank over an ``EngineData`` or a ``ShardedEngineData`` (every rank calls it)."""
    return _pagerank_operands(data.edges, data.mask, data.degrees, data.num_vertices, _group_of(data), iterations,
                              damping)


def sssp(data, *, source: int = 0, max_iters: int = 64) -> tuple[torch.Tensor, int]:
    return _sssp_operands(data.edges, data.mask, data.num_vertices, _group_of(data), source, max_iters)


def wcc(data, *, max_iters: int = 64) -> tuple[torch.Tensor, int]:
    return _wcc_operands(data.edges, data.mask, data.num_vertices, _group_of(data), max_iters)


def comm_volume_per_iteration(data: EngineData, bytes_per_value: int = 8) -> int:
    """Paper §6.4 COM metric: each mirror sends + receives one value/iteration."""
    return 2 * data.mirrors * bytes_per_value


# --------------------------------------------------------------------------
# Pure-operand query programs (the serving path, launch/serve.py).
#
# ``query_program`` returns a callable that takes the pack OPERANDS (edges,
# mask, degrees[, source]) explicitly, so one program answers queries against
# whatever pack a live StreamingEngine holds when it is called, across
# rescales and rebuild commits. Over a ``group`` the operands are this rank's
# row block and the combine is an ``all_reduce``, as in the apps above. The
# reference caches its programs because each is a jit; here a program is a
# plain function with nothing to compile, so nothing is cached.

QUERY_KINDS = ("pagerank", "sssp", "wcc")


def query_program(
    kind: str,
    *,
    num_vertices: int,
    group: GraphGroup | None = None,
    iterations: int = 20,
    damping: float = 0.85,
    max_iters: int = 64,
):
    """The pure-operand program for ``kind``. Call signatures: pagerank
    ``(edges, mask, degrees) → ranks``; sssp ``(edges, mask, source=0) →
    (dist, iters)``; wcc ``(edges, mask) → (lab, iters)``. Unknown kinds
    raise ``ValueError``. Each call is a span ``query.<kind>``: PageRank's
    ends once its sweeps are enqueued, SSSP's and WCC's at their last stop
    flag's readback."""
    v, iterations, damping, max_iters = int(num_vertices), int(iterations), float(damping), int(max_iters)
    name = f"query.{kind}"
    if kind == "pagerank":
        def program(edges, mask, degrees):
            with OT.span(name):
                return _pagerank_operands(edges, mask, degrees, v, group, iterations, damping)
    elif kind == "sssp":
        def program(edges, mask, source=0):
            with OT.span(name):
                return _sssp_operands(edges, mask, v, group, int(source), max_iters)
    elif kind == "wcc":
        def program(edges, mask):
            with OT.span(name):
                return _wcc_operands(edges, mask, v, group, max_iters)
    else:
        raise ValueError(f"unknown query kind {kind!r} (expected one of {QUERY_KINDS})")
    return program
