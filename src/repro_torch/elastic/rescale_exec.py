"""Elastic rescale executor — the paper's Thm.-1/2 promise, executed on the device.

``cep.scale_plan(k_old → k_new)`` names the ≤ k_old + k_new − 1 ordered-edge
ranges whose owner changes; everything else stays where it is. This module
applies such a plan directly to the packed ``(k, E_max, 2)`` buffers of
graphs/engine.py as one copy per overlay segment into a fresh buffer — so
executing a rescale costs O(overlay ranges) of planning and moves exactly the
Thm.-2-minimal edge ranges across partitions, instead of re-running any
partitioner or re-packing from the host.

The JAX package compiles the copies into one jitted program and donates the
old buffer to it. Here each rank's share of the program is a segment table
(``kernels/rescale_migrate.py MigrateTable``), built and uploaded once per
cached program, and one launch of the ``rescale_migrate`` CUDA kernel writes
the rank's whole new block from it (edges and mask; the plain PyTorch version
on the CPU). The result is a fresh tensor and the input stays valid: no
donation. Over a ``ShardedEngineData`` of g ranks each rank builds the same
sorted segment list from the plan alone; a segment whose source row
``partition_row(s, k_old, g)`` and destination row ``partition_row(d, k_new,
g)`` are on one rank is a copy there, every other one a send and a receive
between the two ranks (``launch/multihost.py exchange``: NCCL on the cards,
gloo staged through host memory), into a range the kernel leaves unwritten.

Cost accounting (``RescaleStats``) keeps the JAX package's fields:

* ``migrated_*`` — rows whose owner *partition* changes (equals
  ``ScalePlan.migrated_bytes`` by construction, asserted in tests);
* ``cross_device_*`` — migrated rows whose partitions sit on different ranks
  (p % g), ``on_device_edges`` the rest;
* ``cross_process_*`` — the subset whose ranks belong to different
  processes (hosts): what a multi-host deployment pays on the network;
* ``local_shift_edges`` — rows that keep their owner but land at a different
  slot in the padded buffer because the chunk start moved.

Spans (``obs/trace.py``, on the rescaler's tracer): ``rescale.plan`` around
``cep.scale_plan``; ``rescale.execute`` around the rest, holding in turn
``rescale.layout_check`` (ending at its readback), ``rescale.table_build`` (a
program-cache miss only), ``rescale.migrate`` (``RescaleStats.elapsed_s``) and
``rescale.recheck`` (``RescaleStats.recheck_s``), the last split into
``rescale.recheck.rows`` (``packed_rows``' where and sort) and
``rescale.recheck.count`` (``segment_rf`` through the readbacks).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..core import cep
from ..graphs import engine as graph_engine
from ..kernels import ops
from ..kernels import rescale_migrate as RM
from ..kernels import segment_rf
from ..launch import multihost as MH
from ..launch import sharding as SH
from ..launch.mesh import make_graph_group
from ..obs import metrics as OM
from ..obs import trace as OT

__all__ = [
    "EDGE_BYTES",
    "ProgramCache",
    "RescaleStats",
    "ElasticRescaler",
    "cross_process_plan_edges",
    "plan_segments",
]

EDGE_BYTES = 8  # (src, dst) int32 per packed edge row


class ProgramCache:
    """Bounded LRU of prepared device programs keyed by their static
    shape/device signature. A program is whatever its owner prepares once per
    signature: a rescale's segment table and k_new mask, or a streaming
    program family's prebuilt index tensors. Keys are KIND-prefixed tuples
    (("migrate", ...), ("scatter", ...), ("compact", ...), ("span_repair",
    ...), ("full_reorder", ...), ("splice", ...)) so every program family of
    one runtime component shares a single cache, and ``program_cache_size``
    bounds all of them at once (ElasticRescaler: migrate; StreamingEngine:
    scatter + compact + span_repair + full_reorder + splice).

    Per-kind hit/miss/eviction ``counters`` (``counters_snapshot``) make the
    cache's behavior auditable: a ``get`` returning a program is a hit, a
    ``get`` returning None a miss (the caller builds and ``put``s), and
    ``put`` evicting an LRU victim an eviction — so misses == builds."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("program_cache_size must be >= 1")
        self.size = int(size)
        self._programs: collections.OrderedDict = collections.OrderedDict()
        # kind (key[0] for tuple keys, "?" otherwise) → {hits, misses, evictions}
        self.counters: dict = {}
        self._counters_shared = False  # a snapshot aliases self.counters

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key) -> bool:
        return key in self._programs

    def __iter__(self):
        return iter(self._programs)  # keys, least- to most-recently used

    @staticmethod
    def _kind(key) -> str:
        return str(key[0]) if isinstance(key, tuple) and key else "?"

    def _count(self, key, event: str) -> None:
        if self._counters_shared:
            # Copy-on-write: a snapshot handed out earlier aliases the live
            # dicts — clone before mutating so every outstanding snapshot
            # stays frozen at its emit-time values.
            self.counters = {kind: dict(c) for kind, c in self.counters.items()}
            self._counters_shared = False
        c = self.counters.setdefault(self._kind(key), {"hits": 0, "misses": 0, "evictions": 0})
        c[event] += 1

    def counters_snapshot(self) -> dict:
        """Per-kind counters, isolated from later cache activity. The live
        mapping is returned and cloned before the cache's next mutation
        (copy-on-write), so a snapshot per event costs a flag set, not a deep
        copy. Callers must treat the result as immutable."""
        self._counters_shared = True
        return self.counters

    def get(self, key):
        cached = self._programs.get(key)
        if cached is not None:
            self._programs.move_to_end(key)
            self._count(key, "hits")
        else:
            self._count(key, "misses")
        return cached

    def touch(self, key) -> bool:
        """Refresh recency if present (counted as a hit). Unlike ``get``, an
        absent key counts nothing — warm-up helpers probe with this before
        building, and the build's own ``get`` miss then counts it exactly
        once, keeping misses == builds."""
        cached = self._programs.get(key)
        if cached is not None:
            self._programs.move_to_end(key)
            self._count(key, "hits")
            return True
        return False

    def put(self, key, value):
        self._programs[key] = value
        while len(self._programs) > self.size:
            victim, _ = self._programs.popitem(last=False)
            self._count(victim, "evictions")
        return value


def cross_process_plan_edges(plan: cep.ScalePlan, group) -> int:
    """Edges of the plan's move ranges whose source and destination partitions
    live on different *processes* of ``group`` — the Thm.-2 subset that a
    multi-host deployment pays on the network. Pure host arithmetic over the
    overlay (no device readback), so the network bill is known before the
    migration runs. ``group=None`` is a world of one: 0."""
    g = SH.graph_axis_size(group)
    procs = SH.device_process_map(group)
    return int(sum(hi - lo for lo, hi, s, d in plan.moves if procs[s % g] != procs[d % g]))


def plan_segments(plan: cep.ScalePlan) -> list:
    """The plan's overlay as ordered (lo, hi, src_part, dst_part) copy
    segments — stays spelled src == dst. This is the exact instruction list of
    the migration; benchmarks reuse it for per-device accounting."""
    return sorted(
        [(lo, hi, p, p) for lo, hi, p in plan.stay]
        + [(lo, hi, s, d) for lo, hi, s, d in plan.moves]
    )


@dataclasses.dataclass(frozen=True)
class RescaleStats:
    k_old: int
    k_new: int
    num_edges: int
    migrated_edges: int  # cross-partition rows (owner changed)
    migrated_bytes: int  # migrated_edges · EDGE_BYTES
    stay_edges: int  # rows whose owner is unchanged
    local_shift_edges: int  # stays that changed slot inside their partition
    copy_ops: int  # plan segments the migration copies (the reference's slice copies)
    oracle_checked: bool  # compared bit-exactly vs a from-scratch pack
    elapsed_s: float  # wall time of the migration and the exchange, after a device synchronize
    recheck_s: float  # metrics re-check (+ oracle compare) time
    devices: int = 1  # graph-axis size the migration ran over
    cross_device_edges: int = 0  # migrated rows crossing a device boundary
    cross_device_bytes: int = 0  # cross_device_edges · EDGE_BYTES
    on_device_edges: int = 0  # migrated rows staying on their device
    processes: int = 1  # process count behind the graph axis
    cross_process_edges: int = 0  # migrated rows crossing a PROCESS boundary
    cross_process_bytes: int = 0  # cross_process_edges · EDGE_BYTES


@dataclasses.dataclass(frozen=True)
class _Program:
    """A cached migration for one rank: its share of the copy segments, the
    device segment table the kernel reads, and the stats that depend on the
    plan alone.

    Segments are ``(lo, hi, src_part, dst_part)`` in ``plan_segments`` order,
    the same on every rank. ``local`` holds those whose source and
    destination rows are both this rank's, as local (row, column) slices;
    ``sends``/``recvs`` the rest that touch this rank, each ``(peer, row,
    col_lo, col_hi, tag)`` with the tag the segment's index. ``table`` covers
    every slot of the rank's new block once: ``local``, the receive ranges,
    each row's zero tail and the padded rows."""

    local: tuple  # (row_old, a_old, b_old, row_new, a_new, b_new), local rows
    sends: tuple
    recvs: tuple
    table: RM.MigrateTable  # on the data's device, uploaded once; rows m_new, width E_max at k_new
    stats: RescaleStats


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _layout_of(data):
    """The data's group and its row block's partition ids. An ``EngineData``
    is the pack of a world of one on its device."""
    if isinstance(data, graph_engine.ShardedEngineData):
        return data.group, data.local_partitions()
    return make_graph_group(data.edges.device), list(range(data.k))


class ElasticRescaler:
    """Executes ``cep.ScalePlan``s against packed engine state on its devices.

    Takes an ``EngineData`` (a world of one) or a ``ShardedEngineData``
    (partitions round-robin over the ranks of its ``GraphGroup``); every rank
    of the group calls ``execute`` with the same plan. A segment whose source
    and destination rows are on one rank is a slice copy there; every other
    segment is one send from the rank holding the source row and one receive
    into the destination rank's fresh block (``multihost.exchange``).

    Prepared migrations (segment lists + k_new mask block) are cached per
    (num_edges, k_old, k_new, group, device) in a bounded LRU
    (``program_cache_size``), so a controller oscillating between cluster
    sizes prepares each once. ``verify=True`` re-packs from scratch on the
    host and asserts bit-equality (the tests' oracle); the metrics re-check
    (mirrors, replication factor) keeps the returned data self-consistent.
    """

    def __init__(self, *, program_cache_size: int = 8, tracer=None, metrics_registry=None):
        self._programs = ProgramCache(program_cache_size)
        # tracer=None falls back to the process-global tracer (disabled by
        # default); metrics default to the inert registry.
        self._tracer = tracer
        self.metrics = OM.NULL if metrics_registry is None else metrics_registry

    @property
    def tracer(self):
        return self._tracer if self._tracer is not None else OT.get_tracer()

    @property
    def program_cache_size(self) -> int:
        return self._programs.size

    # ------------------------------------------------------------- planning
    def plan(self, data, k_new: int) -> cep.ScalePlan:
        with self.tracer.span("rescale.plan"):
            return cep.scale_plan(data.num_edges, data.k, k_new)

    # ------------------------------------------------------------ execution
    def execute(self, data, plan: cep.ScalePlan, *, verify: bool = False, recheck: bool = True):
        """Apply ``plan`` to ``data``; returns ``(new_data, RescaleStats)``.

        ``data`` must be CEP-chunked (partition p = ordered range p, as built
        by ``pack_ordered`` / ``pack_ordered_sharded``). The result's edges and
        mask are fresh tensors on ``data``'s device; ``data`` is not donated
        and stays valid. Over a group of several ranks this is a collective:
        every rank calls it with the same plan.

        ``recheck=True`` recomputes mirrors / replication factor for k_new on
        the devices, through the ``segment_rf`` kernel on each rank's new
        rows and one ``all_reduce`` of the sums, with no host readback of the
        buffers. ``recheck=False`` keeps the pure O(overlay-ranges) migration
        cost; the returned data then carries ``mirrors=-1``,
        ``replication_factor=nan`` (engine algorithms never read them).
        ``verify=True`` reads every rank's rows back to the host
        (``host_read``), packs the ordered list from scratch at k_new there and
        compares byte for byte.
        """
        tracer = self.tracer
        with tracer.span("rescale.execute"):
            n, k_old, k_new = plan.num_edges, plan.k_old, plan.k_new
            if data.k != k_old:
                raise ValueError(f"plan is for k_old={k_old} but engine data has k={data.k}")
            if data.num_edges != n:
                raise ValueError(f"plan is for |E|={n} but engine data has |E|={data.num_edges}")
            group, parts = _layout_of(data)
            device = data.edges.device
            with tracer.span("rescale.layout_check"):
                self._check_layout(data, n, k_old, group, parts, device)
            if k_new == k_old:
                # No-op plan: hand the buffers back untouched.
                stats = RescaleStats(
                    k_old=k_old, k_new=k_new, num_edges=n, migrated_edges=0,
                    migrated_bytes=0, stay_edges=n, local_shift_edges=0,
                    copy_ops=0, oracle_checked=False, elapsed_s=0.0, recheck_s=0.0,
                    devices=group.size, processes=group.process_count,
                )
                return data, stats

            prog = self._program(n, k_old, k_new, plan, group, device)
            _synchronize(device)
            t0 = time.perf_counter()
            with tracer.span("rescale.migrate"):
                # One kernel launch writes every slot but the receive ranges'
                # edges, which the exchange fills (before or after it lands).
                new_edges, new_mask = RM.migrate(data.edges, prog.table)
                sent, received = MH.exchange(
                    group,
                    [(peer, data.edges[r, a:b], tag) for peer, r, a, b, tag in prog.sends],
                    [(peer, new_edges[r, a:b], tag) for peer, r, a, b, tag in prog.recvs],
                )
                _synchronize(device)
            elapsed = time.perf_counter() - t0
            m = self.metrics
            m.counter("rescale.migrated_bytes").inc(prog.stats.migrated_bytes)
            m.counter("rescale.cross_device_bytes").inc(prog.stats.cross_device_bytes)
            m.counter("rescale.cross_process_bytes").inc(prog.stats.cross_process_bytes)
            m.counter("rescale.sent_bytes").inc(sent)  # this rank's share of the cross-rank traffic
            m.counter("rescale.received_bytes").inc(received)

            with tracer.span("rescale.recheck"):
                # Metrics re-check: recompute quality numbers for the new k
                # (never carried over from the old pack). A rescale does not
                # change degrees, so the touched-vertex count comes from them.
                t1 = time.perf_counter()
                if recheck:
                    with tracer.span("rescale.recheck.rows"):
                        rows = ops.packed_rows(new_edges, new_mask)
                    with tracer.span("rescale.recheck.count"):
                        local = segment_rf.segment_distinct_counts(rows).to(torch.int64).sum()
                        total = int(MH.all_reduce(local, group, "sum"))
                        present = int((data.degrees > 0).sum())
                    mirrors, rf = total - present, float(total) / float(data.num_vertices)
                else:
                    mirrors, rf = -1, float("nan")
                new_data = dataclasses.replace(
                    data, edges=new_edges, mask=new_mask, k=k_new, mirrors=mirrors, replication_factor=rf
                )
                if verify:
                    self._verify(data, new_edges, new_mask, k_old, k_new, group)
                recheck_s = time.perf_counter() - t1

            stats = dataclasses.replace(
                prog.stats, oracle_checked=bool(verify), elapsed_s=elapsed, recheck_s=recheck_s
            )
            return new_data, stats

    def rescale(self, data, k_new: int, *, verify: bool = False, recheck: bool = True):
        """Plan + execute in one call (what an elastic controller uses)."""
        return self.execute(data, self.plan(data, k_new), verify=verify, recheck=recheck)

    # -------------------------------------------------------------- interns
    @staticmethod
    def _check_layout(data, n: int, k_old: int, group, parts, device) -> None:
        """Raise unless every rank's rows hold its CEP chunks of ``n`` edges at
        ``k_old``: per-row edge counts reduced on the device (m ints to the
        host), then one all_reduce MIN of the verdict, so that every rank
        raises together and none is left waiting at the next collective."""
        counts = (data.mask > 0).sum(dim=1).cpu().numpy()
        sizes_old = np.diff(cep.chunk_bounds(n, k_old))
        want = np.asarray([int(sizes_old[p]) if p < k_old else 0 for p in parts], dtype=counts.dtype)
        ok_here = counts.shape == want.shape and bool(np.array_equal(counts, want))
        ok_all = int(MH.all_reduce(torch.tensor([int(ok_here)], device=device), group, "min")[0])
        if not ok_all:
            where = (
                f"per-row edge counts {counts.tolist()} != chunk sizes {want.tolist()}" if not ok_here
                else "another rank's rows do not hold its chunks"
            )
            raise ValueError(
                f"engine data is not CEP-chunked (rank {group.rank} of {group.size}: {where}); "
                "range-copy rescaling only applies to pack_ordered layouts"
            )

    @staticmethod
    def _verify(data, new_edges, new_mask, k_old: int, k_new: int, group) -> None:
        """From-scratch host pack of the ORIGINAL ordered list at k_new, in the
        sharded row order, compared byte for byte with the new rows — a
        mis-routed move segment cannot fool this. Every rank reads every
        rank's rows, so all agree. Raises on a mismatch."""
        old_rows = [SH.partition_row(p, k_old, group.size) for p in range(k_old)]
        old_edges = MH.host_read(data.edges, group)[old_rows]
        old_valid = MH.host_read(data.mask, group)[old_rows] > 0
        src_o, dst_o = old_edges[..., 0][old_valid], old_edges[..., 1][old_valid]
        want_edges, want_mask = graph_engine.host_pack(src_o, dst_o, k_new)
        rows = [SH.partition_row(p, k_new, group.size) for p in range(k_new)]
        got_edges, got_mask = MH.host_read(new_edges, group), MH.host_read(new_mask, group)
        pad = np.ones(got_edges.shape[0], dtype=bool)
        pad[rows] = False
        if not (
            np.array_equal(want_edges, got_edges[rows])
            and np.array_equal(want_mask, got_mask[rows])
            and not got_edges[pad].any()
            and not got_mask[pad].any()
        ):
            raise AssertionError("executed rescale does not match from-scratch pack")

    def _program(self, n: int, k_old: int, k_new: int, plan: cep.ScalePlan, group, device) -> _Program:
        key = ("migrate", n, k_old, k_new, group, device)
        cached = self._programs.get(key)
        if cached is not None:
            return cached
        with self.tracer.span("rescale.table_build"):
            return self._programs.put(key, self._build_program(n, k_old, k_new, plan, group, device))

    def _build_program(self, n: int, k_old: int, k_new: int, plan: cep.ScalePlan, group, device) -> _Program:
        g, me = group.size, group.rank
        bo = cep.chunk_bounds(n, k_old)
        bn = cep.chunk_bounds(n, k_new)
        sizes_new = np.diff(bn)
        e_max_new = int(sizes_new.max())
        m_new = SH.padded_partition_count(k_new, g) // g
        segments = plan_segments(plan)
        local, sends, recvs = [], [], []
        for tag, (lo, hi, s, d) in enumerate(segments):
            # Partition p sits on rank p % g at local row p // g.
            owner, dest = SH.partition_device(s, g), SH.partition_device(d, g)
            a_old, b_old = lo - int(bo[s]), hi - int(bo[s])
            a_new, b_new = lo - int(bn[d]), hi - int(bn[d])
            if owner == me and dest == me:
                local.append((s // g, a_old, b_old, d // g, a_new, b_new))
            elif owner == me:
                sends.append((dest, s // g, a_old, b_old, tag))
            elif dest == me:
                recvs.append((owner, d // g, a_new, b_new, tag))
        local_shift = sum(
            hi - lo for lo, hi, s, d in segments if s == d and int(bo[s]) != int(bn[s])
        )
        cross = sum(
            hi - lo
            for lo, hi, s, d in plan.moves
            if SH.partition_device(s, g) != SH.partition_device(d, g)
        )
        xproc = cross_process_plan_edges(plan, group)
        stats = RescaleStats(
            k_old=k_old,
            k_new=k_new,
            num_edges=n,
            migrated_edges=plan.migrated_edges,
            migrated_bytes=plan.migrated_bytes(EDGE_BYTES),
            stay_edges=sum(hi - lo for lo, hi, _ in plan.stay),
            local_shift_edges=int(local_shift),
            copy_ops=len(segments),
            oracle_checked=False,
            elapsed_s=0.0,
            recheck_s=0.0,
            devices=g,
            cross_device_edges=int(cross),
            cross_device_bytes=int(cross) * EDGE_BYTES,
            on_device_edges=plan.migrated_edges - int(cross),
            processes=group.process_count,
            cross_process_edges=xproc,
            cross_process_bytes=xproc * EDGE_BYTES,
        )
        row_sizes = np.zeros(m_new, dtype=np.int64)  # padded rows hold none
        for d in range(me, k_new, g):  # this rank's partitions: d % g == me, at row d // g
            row_sizes[d // g] = sizes_new[d]
        table = RM.migrate_table(local, [(r, a, b) for _, r, a, b, _ in recvs], row_sizes, e_max_new, device)
        return _Program(
            local=tuple(local),
            sends=tuple(sends),
            recvs=tuple(recvs),
            table=table,
            stats=stats,
        )
