"""On-device ingest: apply EdgeUpdateBatches to the engine pack on the card.

The host ``IncrementalOrderer`` owns the ordered slot array; the
``StreamingEngine`` mirrors it on the device as a ``ShardedEngineData`` whose
partition p holds region p's slots (``graphs/engine.py pack_slots`` layout:
occupied slots keep their column, gaps are masked, one trailing scratch
column). Five device program families — all in one bounded kind-prefixed
``ProgramCache`` LRU, the container elastic/rescale_exec.py uses — keep the
mirror current without re-packing from the host. A program here is what is
prepared once per layout signature (the span and full programs' index
tensors); the ops themselves are eager torch ops on the engine's device.

* **scatter** (ingest): each drained ``SlotOp`` becomes one (row, col) write
  of the edge values + mask bit, plus a scatter-add of the per-vertex degree
  deltas. Ops are padded to a power-of-two batch capacity; padding targets
  the scratch column, which the program re-zeroes. Real ops never name one
  slot twice in a scatter (the orderer coalesces them per slot), so the
  writes do not depend on which writer of an index wins.
* **compact** (rescale-under-ingest): the orderer's re-layout gather map
  (new slot ← old slot) becomes one gather over the old buffers into the
  k_new layout.
* **span_repair** (partial re-order, the ladder's middle rung): one program
  reads the degraded span's live slots from the buffers, recomputes the
  span-local order (kernels/span_reorder.py) and writes the repaired layout
  back over the span rows. The host runs the byte-exact numpy mirror of the
  same algorithm to keep its slot array and drift counters current, so the
  rung reads nothing back. ``span_repair="oracle"`` applies host
  ``geo_order`` verbatim on the device; ``"differential"`` scores it against
  the device order on the device, through the ``segment_rf`` kernel.
* **full_reorder** + **splice** (the full-rebuild rung, async — DESIGN.md
  §11): an async mode only dispatches the whole-graph re-order program
  (kernels/full_reorder.py). On the card it runs on a side CUDA stream over a
  snapshot of the rows, taken on the ingest stream at dispatch, and writes
  fresh shadow buffers while ingest keeps scattering into the live ones.
  ``rebuild_flight`` batches later the commit re-layouts the host slot array
  to the candidate order, replays the batches queued during the flight, and
  the splice program scatters the replay's slot ops onto the shadow buffers,
  which then become the live pack. On the CPU the program runs in place of
  the dispatch, in order.

The engine updates its buffers in place: there is no ``donate`` option. A wait
is on the engine's own stream (``_wait``), never on the whole device, so a
rebuild in flight on the side stream does not hold up ingest.

Bit-identity contract (DESIGN.md §9): after any sequence of ingests,
rescales, span repairs and rebuild commits, ``unshard_engine_data(engine.data)``
equals the host-side ``pack_slots`` oracle byte for byte
(``verify_bit_identity``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device
from ..core import cep
from ..elastic.rescale_exec import EDGE_BYTES, ProgramCache
from ..graphs import engine as graph_engine
from ..kernels import full_reorder as FRK
from ..kernels import span_reorder as SRK
from ..launch import sharding as SH
from ..launch.mesh import GraphGroup, make_graph_group
from ..obs import metrics as OM
from ..obs import trace as OT
from .incremental import IncrementalOrderer
from .updates import EdgeUpdateBatch

__all__ = ["IngestStats", "StreamRescaleStats", "StreamingEngine"]

_LOG = logging.getLogger(__name__)

_MIN_OP_CAPACITY = 32
# Fixed op capacity of the commit splice: one program signature serves every
# commit; larger replay deltas run as chained chunks of this size.
_SPLICE_CAP = 1024
# full_rebuild engine mode → full-reorder program mode (kernels/full_reorder):
#   "geo"          — host geo_order candidate applied verbatim (the oracle path)
#   "device"       — device step-parallel greedy; the host mirror's
#                    never-worse-than-incumbent selection arrives as a flag
#   "differential" — geo candidate, greedy-vs-candidate selection on the device
_FULL_PROGRAM_MODE = {"geo": "apply", "device": "greedy", "differential": "select"}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _rows_of_regions(regions: np.ndarray, k: int, g: int) -> np.ndarray:
    """Vectorized launch.sharding.partition_row."""
    m = SH.padded_partition_count(k, g) // g
    return (regions % g) * m + regions // g


@dataclasses.dataclass(frozen=True)
class IngestStats:
    inserted: int  # edges added to the graph
    deleted: int  # edges removed
    skipped: int  # duplicate inserts / deletes of absent edges (idempotent)
    scatter_ops: int  # slot writes in the device scatter (0 when resynced)
    resynced: bool  # True when the slot array re-laid out (grow/escalation)
    elapsed_s: float  # host apply + device program, waited for
    num_edges: int  # live edges after the batch


@dataclasses.dataclass(frozen=True)
class StreamRescaleStats:
    k_old: int
    k_new: int
    num_edges: int
    moved_edges: int  # edges whose owning region changed (actual)
    cep_plan_edges: int  # what CEP-chunk layouts would move for this |E|, k_old → k_new
    cross_device_edges: int  # moved edges whose regions live on different ranks
    cross_device_bytes: int
    elapsed_s: float
    cross_process_edges: int = 0  # moved edges whose ranks live in different processes
    cross_process_bytes: int = 0


class StreamingEngine:
    """Keeps a device-resident engine pack in lock-step with an
    ``IncrementalOrderer`` under streaming updates and rescales.

    ``engine.data`` is always a live ``ShardedEngineData`` of one rank: the
    GAS algorithms (pagerank / sssp / wcc) run on it unchanged between — and
    across — ingests, because the slot layout is mask-driven.

    ``device=None`` means ``"cuda"`` and raises without a card; the CPU runs
    only when asked for (``device="cpu"``). ``group`` is the graph axis; the
    engine runs a world of one (the default), and a group of several ranks
    raises ``NotImplementedError`` (ROADMAP.md, queue A item 2's remainder).
    """

    def __init__(
        self,
        orderer: IncrementalOrderer,
        device=None,
        *,
        program_cache_size: int = 24,
        scatter_limit: int = 1024,
        span_repair: str = "device",
        full_rebuild: str = "host",
        rebuild_flight: int = 2,
        tracer=None,
        metrics_registry=None,
        group: GraphGroup | None = None,
    ):
        if span_repair not in ("device", "host", "oracle", "differential"):
            raise ValueError(f"unknown span_repair mode {span_repair!r}")
        if full_rebuild not in ("host", "geo", "device", "differential"):
            raise ValueError(f"unknown full_rebuild mode {full_rebuild!r}")
        if rebuild_flight < 0:
            raise ValueError("rebuild_flight must be >= 0")
        self.device = resolve_device(device)
        self.group = make_graph_group(self.device) if group is None else group
        if self.group.size != 1:
            raise NotImplementedError(
                f"a StreamingEngine over {self.group.size} ranks: its sharded scatter and compaction are "
                "ROADMAP.md queue A item 2's remainder; this engine runs a world of one rank"
            )
        self.g = self.group.size
        self.orderer = orderer
        # Above this many slot ops, a full pack re-upload replaces the scatter.
        # Only the host-mode partial rung produces span-sized op batches.
        self.scatter_limit = int(scatter_limit)
        # Partial-rung implementation (DESIGN.md §9):
        #   "device"       — device span repair + byte-exact host mirror
        #   "host"         — host geo_order + slot-op scatter
        #   "oracle"       — host geo_order applied verbatim by the device
        #                    program (bit-identical to "host")
        #   "differential" — device repair with the geo_order oracle as the
        #                    candidate, selected on the device
        self.span_repair = span_repair
        # Full-rebuild rung implementation (DESIGN.md §11):
        #   "host"         — synchronous host geo_order + re-upload
        #   "geo"          — async; host geo_order candidate applied on the device
        #   "device"       — async; device step-parallel greedy, never worse
        #                    than the incumbent layout by exact selection
        #   "differential" — async; geo candidate with device selection,
        #                    bit-identity verified at every commit
        self.full_rebuild = full_rebuild
        # Batches a dispatched rebuild stays in flight before its commit. 0 =
        # commit inside the dispatching monitor call (synchronous semantics).
        self.rebuild_flight = int(rebuild_flight)
        self._flight: Optional[dict] = None  # in-flight rebuild state
        self._side_stream = None  # CUDA stream of the async rebuild, made at first use
        self._last_drift = 1.0  # drift tracker for dispatch anticipation
        self._drift_rate = 0.0  # EMA of per-batch drift growth
        self.rebuild_log: list = []  # committed/aborted rebuild records
        self.rebuild_state = ""  # ""/"dispatch"/"flight"/"commit"/"abort"
        self.last_rebuild_s = 0.0  # rebuild work inside the last monitor call
        self._greedy_overflow_logged = False  # int32-fallback warning fires once
        # One kind-prefixed LRU for every program family (scatter / compact /
        # span_repair / full_reorder / splice), sized for the families that
        # share it.
        self._programs = ProgramCache(program_cache_size)
        self.rung_counts = {"none": 0, "partial": 0, "full": 0}
        self.rung_s = {"none": 0.0, "partial": 0.0, "full": 0.0}
        self.last_repair = ""  # what the last partial/full rung executed
        self._seen_scatter_caps: set = set()  # scatter op capacities used so far
        self._tracer = tracer
        self.metrics = OM.NULL if metrics_registry is None else metrics_registry
        m = self.metrics
        self._m_ingest_s = m.histogram("stream.ingest.batch_s")
        self._m_monitor_s = m.histogram("stream.monitor.s")
        self._m_rung_s = {r: m.histogram(f"stream.rung.{r}_s") for r in ("none", "partial", "full")}
        self._m_updates = {k: m.counter(f"stream.updates.{k}") for k in ("inserted", "deleted", "skipped")}
        self._m_scatter_ops = m.counter("stream.scatter_ops")
        self._m_resyncs = m.counter("stream.resyncs")
        self._m_edges = m.gauge("stream.num_edges")
        self._m_in_flight = m.gauge("stream.rebuilds_in_flight")
        self.data = self._upload()
        orderer.needs_resync = False
        self._warm_programs()

    # ------------------------------------------------------------- plumbing
    @property
    def tracer(self):
        return self._tracer if self._tracer is not None else OT.get_tracer()

    @property
    def k(self) -> int:
        return self.orderer.regions

    @property
    def num_vertices(self) -> int:
        return self.orderer.num_vertices

    def oracle_pack(self) -> graph_engine.EngineData:
        """Host-side bit-identity oracle: pack_slots of the current host slot
        array (what the device buffers must equal after unshard), uploaded."""
        o = self.orderer
        return graph_engine.pack_slots(
            o.slot_src, o.slot_dst, o.slot_valid, o.regions, o.num_vertices, device=self.device
        )

    def _upload(self) -> graph_engine.ShardedEngineData:
        return graph_engine.shard_engine_data(self.oracle_pack(), self.group)

    def _operand(self, arr: np.ndarray) -> torch.Tensor:
        """A host-built operand (scatter indices, gather maps) on the device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _rows(self, parts) -> torch.Tensor:
        o = self.orderer
        return self._operand(np.asarray([SH.partition_row(p, o.regions, self.g) for p in parts], dtype=np.int64))

    def _wait(self) -> None:
        """Wait for the engine's own stream, not the whole device: a rebuild
        in flight on the side stream keeps running."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def program_cache_counters(self) -> dict:
        """Per-kind {hits, misses, evictions} snapshot of the shared program
        cache (misses == builds: the warm helpers probe with ``touch``, which
        counts nothing on absence)."""
        return self._programs.counters_snapshot()

    @property
    def rebuilds_in_flight(self) -> int:
        return 1 if self._flight is not None else 0

    def _resync(self) -> None:
        """Full host re-upload after a slot re-layout (grow / full rebuild).
        Aborts any in-flight rebuild: its snapshot geometry no longer exists."""
        if self._flight is not None:
            self._abort_rebuild("resync")
        with self.tracer.span("ingest.resync"):
            self.orderer.drain_ops()  # ops predate the re-layout; drop them
            self.data = self._upload()
        self._m_resyncs.inc()
        self.orderer.needs_resync = False
        self._warm_programs()

    def _warm_programs(self) -> None:
        """Prepare every program of the current layout signature (span, full +
        splice, the scatter capacities seen so far), so an escalation or the
        first batch after a layout change builds nothing. ``touch`` probes:
        a hit refreshes LRU recency, an absent key counts no miss."""
        o = self.orderer
        e_cap = int(self.data.edges.shape[1])
        k_pad = self.data.k_pad
        if self.span_repair != "host":
            s = min(o.config.span_regions, o.regions)
            mode = {"oracle": "apply", "differential": "select"}.get(self.span_repair, "greedy")
            if not self._programs.touch(self._span_key(mode, o.regions, k_pad, e_cap, s)):
                self._span_program(mode, o.regions, k_pad, e_cap, s)
        if self.full_rebuild != "host":
            mode = _FULL_PROGRAM_MODE[self.full_rebuild]
            if not self._programs.touch(self._full_key(mode, o.regions, k_pad, e_cap)):
                self._full_program(mode, o.regions, k_pad, e_cap)
            if not self._programs.touch(self._splice_key(k_pad, e_cap)):
                self._splice_program(k_pad, e_cap)
        for cap in sorted(self._seen_scatter_caps):
            if not self._programs.touch(self._scatter_key(k_pad, e_cap, cap)):
                self._scatter_program(k_pad, e_cap, cap)

    def _sync_pending(self) -> None:
        """Bring the device mirror up to date with whatever the host orderer
        has applied since the last sync: resync after a re-layout, otherwise
        scatter the drained ops (re-upload beyond ``scatter_limit``)."""
        if self.orderer.needs_resync:
            self._resync()
            return
        ops, deg = self.orderer.drain_ops()
        if len(ops) > self.scatter_limit:
            self.data = self._upload()
        elif ops or deg:
            self._scatter(ops, deg)

    def verify_bit_identity(self) -> bool:
        """Raise unless the device pack, unsharded and read back, equals the
        host ``pack_slots`` oracle byte for byte."""
        got = graph_engine.unshard_engine_data(self.data)
        o = self.orderer
        want = graph_engine.host_pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, o.num_vertices)
        if not all(
            np.array_equal(t.cpu().numpy(), w) for t, w in zip((got.edges, got.mask, got.degrees), want)
        ):
            raise AssertionError("streaming pack diverged from the host slot oracle")
        return True

    # --------------------------------------------------------------- ingest
    def ingest(self, batch: EdgeUpdateBatch, *, verify: bool = False) -> IngestStats:
        """Apply one update batch: host slot placement, then the device
        scatter (or a resync when the batch forced a re-layout)."""
        t0 = time.perf_counter()
        with self.tracer.span("ingest.batch"):
            with self.tracer.span("ingest.apply"):
                counts = self.orderer.apply(batch)
            resynced = False
            n_ops = 0
            # The device part, waited for: its span is the scatter's time on
            # the host clock, enqueue to completion.
            with self.tracer.span("ingest.device"):
                if self.orderer.needs_resync:
                    self._resync()
                    resynced = True
                else:
                    ops, deg = self.orderer.drain_ops()
                    n_ops = len(ops)
                    if n_ops or deg:
                        self._scatter(ops, deg)
                self._wait()
        elapsed = time.perf_counter() - t0
        self._m_ingest_s.observe(elapsed)
        self._m_updates["inserted"].inc(counts["inserted"])
        self._m_updates["deleted"].inc(counts["deleted"])
        self._m_updates["skipped"].inc(counts["skipped"])
        self._m_edges.set(self.orderer.num_edges)
        if verify:
            self.verify_bit_identity()
        return IngestStats(
            inserted=counts["inserted"],
            deleted=counts["deleted"],
            skipped=counts["skipped"],
            scatter_ops=n_ops,
            resynced=resynced,
            elapsed_s=elapsed,
            num_edges=self.orderer.num_edges,
        )

    def _scatter(self, ops, deg: dict) -> None:
        with self.tracer.span("ingest.scatter"):
            self._scatter_inner(ops, deg)
        self._m_scatter_ops.inc(len(ops))

    def _slot_op_operands(self, ops, cap: int, e_cap: int):
        """(rows, cols, vals, mvals) of ``ops`` padded to ``cap``: padding
        targets the scratch column of row 0 with zeros."""
        o = self.orderer
        rows = np.zeros(cap, dtype=np.int64)
        cols = np.full(cap, e_cap - 1, dtype=np.int64)
        vals = np.zeros((cap, 2), dtype=np.int32)
        mvals = np.zeros(cap, dtype=np.float32)
        for i, op in enumerate(ops):
            rows[i] = SH.partition_row(op.slot // o.slots_per_region, o.regions, self.g)
            cols[i] = op.slot % o.slots_per_region
            if op.valid:
                vals[i] = (op.u, op.v)
                mvals[i] = 1.0
        return [self._operand(a) for a in (rows, cols, vals, mvals)]

    def _scatter_inner(self, ops, deg: dict) -> None:
        o = self.orderer
        k_pad = self.data.k_pad
        e_cap = int(self.data.edges.shape[1])  # slots_per_region + scratch
        cap = _next_pow2(max(len(ops), (len(deg) + 1) // 2, _MIN_OP_CAPACITY))
        self._seen_scatter_caps.add(cap)
        verts = np.zeros(2 * cap, dtype=np.int64)
        dvals = np.zeros(2 * cap, dtype=np.float32)
        for i, (v, d) in enumerate(sorted(deg.items())):
            verts[i] = v
            dvals[i] = float(d)
        program = self._scatter_program(k_pad, e_cap, cap)
        program(self.data, *self._slot_op_operands(ops, cap, e_cap), self._operand(verts), self._operand(dvals))
        self.data = dataclasses.replace(self.data, num_edges=o.num_edges)

    def _scatter_key(self, k_pad: int, e_cap: int, cap: int):
        return ("scatter", k_pad, e_cap, cap, self.device)

    def _scatter_program(self, k_pad: int, e_cap: int, cap: int):
        key = self._scatter_key(k_pad, e_cap, cap)
        cached = self._programs.get(key)
        if cached is not None:
            return cached

        def apply(data, rows, cols, vals, mvals, verts, dvals):
            data.edges[rows, cols] = vals
            data.mask[rows, cols] = mvals
            # Integer-valued f32 adds (net degree deltas): exact below 2^24 in
            # any order.
            data.degrees.index_add_(0, verts, dvals)
            # The scratch column absorbs padded no-op writes; keep it zero so
            # the pack stays bit-identical to the host oracle.
            data.edges[:, -1, :] = 0
            data.mask[:, -1] = 0.0

        return self._programs.put(key, apply)

    # -------------------------------------------------------------- rescale
    def rescale(self, k_new: int, *, verify: bool = False) -> StreamRescaleStats:
        """Re-slice the live stream to ``k_new`` partitions on the device: the
        orderer re-chunks the current incremental order (CEP at k_new) and the
        gather map executes as one compact program."""
        t0 = time.perf_counter()
        o = self.orderer
        # Flush what the host applied since the last device sync: the gather
        # map below describes the post-flush layout.
        self._sync_pending()
        # A rescale re-layouts every slot: an in-flight rebuild's snapshot
        # geometry (and its shadow buffers' shape) is void — abort it.
        if self._flight is not None:
            self._abort_rebuild("rescale")
        g = self.g
        k_old, spr_old = o.regions, o.slots_per_region
        old_edges = self.data.edges
        with self.tracer.span("rescale.relayout"):
            o.relayout(int(k_new))
            gm = o.drain_gather_map()
        spr_new = o.slots_per_region
        e_cap_old = int(old_edges.shape[1])
        e_cap_new = spr_new + 1
        k_pad_new = SH.padded_partition_count(int(k_new), g)

        new_slots = np.flatnonzero(gm >= 0)
        old_slots = gm[new_slots]
        new_regions = new_slots // spr_new
        old_regions = old_slots // spr_old
        src_row = np.zeros((k_pad_new, e_cap_new), dtype=np.int32)
        src_col = np.zeros((k_pad_new, e_cap_new), dtype=np.int32)
        validf = np.zeros((k_pad_new, e_cap_new), dtype=np.float32)
        dst_rows = _rows_of_regions(new_regions, int(k_new), g)
        dst_cols = new_slots % spr_new
        src_row[dst_rows, dst_cols] = _rows_of_regions(old_regions, k_old, g)
        src_col[dst_rows, dst_cols] = old_slots % spr_old
        validf[dst_rows, dst_cols] = 1.0

        moved = int(np.count_nonzero(new_regions != old_regions))
        cross = int(
            np.count_nonzero((new_regions != old_regions) & (new_regions % g != old_regions % g))
        )
        # One process holds every rank of this package's world, so no moved
        # edge crosses a process boundary.
        xproc = 0
        program = self._compact_program((int(old_edges.shape[0]), e_cap_old, k_pad_new, e_cap_new, self.device))
        with self.tracer.span("rescale.compact"):  # upload of the gather map + the gather, waited for
            edges, mask = program(
                old_edges, self._operand(src_row), self._operand(src_col), self._operand(validf)
            )
            self._wait()
        self.data = graph_engine.ShardedEngineData(
            edges=edges,
            mask=mask,
            degrees=self.data.degrees,  # same graph, degrees unchanged
            num_vertices=self.num_vertices,
            k=int(k_new),
            group=self.group,
            mirrors=-1,
            replication_factor=float("nan"),
            num_edges=o.num_edges,
        )
        o.needs_resync = False
        # The k_new layout is a new program signature: prepare them here,
        # inside the rescale's reported latency.
        self._warm_programs()
        self._wait()
        elapsed = time.perf_counter() - t0
        m = self.metrics
        m.histogram("stream.rescale.s").observe(elapsed)
        m.counter("stream.rescale.cross_device_bytes").inc(cross * EDGE_BYTES)
        m.counter("stream.rescale.cross_process_bytes").inc(xproc * EDGE_BYTES)
        if verify:
            self.verify_bit_identity()
        return StreamRescaleStats(
            k_old=k_old,
            k_new=int(k_new),
            num_edges=o.num_edges,
            moved_edges=moved,
            cep_plan_edges=cep.migrated_edges_exact(o.num_edges, k_old, int(k_new)),
            cross_device_edges=cross,
            cross_device_bytes=cross * EDGE_BYTES,
            elapsed_s=elapsed,
            cross_process_edges=xproc,
            cross_process_bytes=xproc * EDGE_BYTES,
        )

    def _compact_program(self, key):
        cached = self._programs.get(("compact",) + key)
        if cached is not None:
            return cached

        def compact(edges_old, src_row, src_col, validf):
            gathered = edges_old[src_row.long(), src_col.long()]  # (k_pad_new, e_cap_new, 2)
            return gathered * validf[..., None].to(gathered.dtype), validf

        return self._programs.put(("compact",) + key, compact)

    # ------------------------------------------------------------ escalation
    def monitor(self) -> str:
        """Quality-monitor step of the escalation ladder. The ladder decision
        stays in the orderer (``escalation()``); execution is delegated here
        per rung: a partial span re-order runs as the cached span-repair
        program (mode ``span_repair``; host mode falls back to slot-op
        scatter / re-upload under ``scatter_limit``), a full rebuild as a
        synchronous resync (``full_rebuild="host"``) or an async dispatch
        (DESIGN.md §11) that commits ``rebuild_flight`` batches later.
        Escalation is suppressed while a rebuild is in flight. Per-rung
        counters and timings accumulate in ``rung_counts`` / ``rung_s``
        (dispatch and commit both land in 'full'). Returns 'none' | 'partial'
        | 'full'."""
        t0 = time.perf_counter()
        with self.tracer.span("rung.monitor"):
            rung = self._monitor_inner()
        elapsed = time.perf_counter() - t0
        self.rung_counts[rung] += 1
        self.rung_s[rung] += elapsed
        self._m_monitor_s.observe(elapsed)
        self._m_rung_s[rung].observe(elapsed)
        self._m_in_flight.set(self.rebuilds_in_flight)
        return rung

    def _monitor_inner(self) -> str:
        self.rebuild_state = ""
        self.last_rebuild_s = 0.0
        # Flush what the host applied since the last sync first: the span
        # program reads the device buffers, which must mirror the host slots.
        self._sync_pending()
        # Dispatch anticipation: project the drift forward by the flight
        # window (EMA of the per-batch growth × rebuild_flight), so an async
        # full rung commits at roughly the drift a synchronous rebuild would
        # have repaired at.
        d = self.orderer.drift()
        lookahead = 0.0
        if self.full_rebuild != "host" and self.rebuild_flight > 0:
            sample = max(0.0, d - self._last_drift)
            self._drift_rate = 0.7 * self._drift_rate + 0.3 * sample
            lookahead = self.rebuild_flight * self._drift_rate
        self._last_drift = d
        if self._flight is not None:
            self._flight["countdown"] -= 1
            if self._flight["countdown"] <= 0:
                self._commit_rebuild()
                rung = "full"
            else:
                self.rebuild_state = "flight"
                self.last_repair = ""
                rung = "none"
        else:
            # Partial shadow: with a full rung projected within two flight
            # windows, a span repair buys nothing the imminent commit will
            # not erase — suppress it.
            rung = self.orderer.maybe_escalate(
                partial_fn=self._partial_rung, full_fn=self._full_rung,
                full_lookahead=lookahead, partial_shadow=2.0 * lookahead,
            )
            if rung == "none":
                self.last_repair = ""
            if self._flight is not None and self._flight["countdown"] <= 0:
                # rebuild_flight == 0: dispatch and commit inside one call.
                self._commit_rebuild()
        return rung

    def _full_rung(self) -> None:
        """Execute the full rung: host mode keeps the synchronous path (host
        ``geo_order`` + full re-upload); the async modes dispatch the device
        rebuild and return."""
        if self.full_rebuild == "host":
            with self.tracer.span("rebuild.sync"):
                self.orderer.full_rebuild()
                self._resync()
            self.last_repair = "resync"
        else:
            self._dispatch_rebuild()
            self.rebuild_state = "dispatch"
            self.last_repair = "dispatch"

    # ------------------------------------------------------ async full rebuild
    def _dispatch_rebuild(self) -> None:
        """Dispatch the full rung: snapshot the host slot arrays
        (``begin_full_rebuild`` starts queuing batches for the commit's
        replay), compute the candidate decision host-side via the byte-exact
        mirror, and launch the cached whole-graph re-order program, which
        writes shadow buffers while ingest keeps scattering into the live
        ones. ``dispatch_s`` is the host's time here: the mirror, and the
        enqueue of every program op (the greedy's steps included)."""
        with self.tracer.span("rebuild.dispatch"):
            self._dispatch_rebuild_inner()
        self.last_rebuild_s = self._flight["dispatch_s"]

    def _dispatch_rebuild_inner(self) -> None:
        t0 = time.perf_counter()
        o = self.orderer
        u = o.slot_src.copy()
        v = o.slot_dst.copy()
        valid = o.slot_valid.copy()
        o.begin_full_rebuild()
        mode = _FULL_PROGRAM_MODE[self.full_rebuild]
        nv = self.num_vertices
        n_live = int(valid.sum())
        ks = FRK.eval_ks_full(o.config.k_min, o.config.k_max, o.regions)
        use_cand = True
        params = None
        steps = 0
        mode_label = self.full_rebuild
        rung_mode = self.full_rebuild
        if rung_mode != "geo":
            deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
            if not FRK.greedy_fits_int32(n_live, o.config.k_min, o.config.k_max, int(deg.max())):
                # The device greedy's int32 priorities would overflow on this
                # graph: degrade to applying the host order instead of raising
                # — a full rebuild must never abort the ingest loop.
                if not self._greedy_overflow_logged:
                    self._greedy_overflow_logged = True
                    _LOG.warning(
                        "full-rebuild greedy overflows int32 at |E|=%d, "
                        "max_degree=%d: falling back to host geo_order "
                        "(logged once per engine)",
                        n_live,
                        int(deg.max()),
                    )
                rung_mode = "geo"
                mode = _FULL_PROGRAM_MODE["geo"]
                mode_label = f"{self.full_rebuild}+host-fallback"
        if rung_mode == "geo":
            # Oracle path: host geo_order is the committed order; the device
            # program applies it verbatim (mode "apply").
            chosen = FRK.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max)
            cand = chosen
        else:
            if rung_mode == "device":
                cand = FRK.identity_candidate(valid)  # incumbent = never-worse floor
            else:  # differential: geo oracle as the scored candidate
                cand = FRK.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max)
            alpha, beta, delta = FRK.greedy_params(n_live, o.config.k_min, o.config.k_max, int(deg.max()))
            permpos = FRK.fallback_positions(nv)
            chosen, use_cand, steps = FRK._select_full_order_host(
                u, v, valid, nv, cand, ks, alpha, beta, delta, permpos
            )
            params = (alpha, beta, delta, permpos)
        live_order = np.asarray(chosen[:n_live], dtype=np.int64)
        cand_src = u[live_order]
        cand_dst = v[live_order]
        e_cap = int(self.data.edges.shape[1])
        program = self._full_program(mode, o.regions, self.data.k_pad, e_cap)
        rows = self._rows(range(o.regions))
        # The snapshot: the rows as the ingest stream has them now. Later
        # scatters write the live buffers, never these copies.
        blk_e, blk_m = self.data.edges[rows], self.data.mask[rows]
        side = self._rebuild_stream()
        if side is None:
            shadow = program(blk_e, blk_m, rows, self._operand(cand), use_cand, params, steps)
            done = None
        else:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                shadow = program(blk_e, blk_m, rows, self._operand(cand), use_cand, params, steps)
                done = torch.cuda.Event()
                done.record(side)
            for t in (blk_e, blk_m, rows):
                t.record_stream(side)  # made on the ingest stream, read on the side stream
        self._flight = {
            "mode": mode_label,
            "countdown": self.rebuild_flight,
            "shadow": shadow,
            "done": done,
            "cand_src": cand_src,
            "cand_dst": cand_dst,
            "snapshot_edges": n_live,
            "dispatch_s": time.perf_counter() - t0,
        }

    def _rebuild_stream(self):
        """The side CUDA stream of the async rebuild; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _commit_rebuild(self) -> None:
        """Commit the in-flight rebuild: re-layout the host slot array to the
        candidate order and replay the flight's queued batches
        (``commit_full_rebuild``), then splice the replay's coalesced slot ops
        onto the shadow buffers — the swap that makes them the live pack.
        Waits, so the full rung's reported cost is honest. Falls back to a
        resync when the commit could not keep the buffer shape."""
        with self.tracer.span("rebuild.commit"):
            self._commit_rebuild_inner()

    def _commit_rebuild_inner(self) -> None:
        t0 = time.perf_counter()
        fl, self._flight = self._flight, None
        o = self.orderer
        replayed = o.rebuild_delta_batches
        ok = o.commit_full_rebuild(fl["cand_src"], fl["cand_dst"])
        splice_ops = 0
        if fl["done"] is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(fl["done"])
            for t in fl["shadow"]:
                t.record_stream(main)  # made on the side stream, used on the ingest stream
        if not ok:
            self._resync()
            self.last_repair = "resync"
        else:
            ops, _ = o.drain_ops()  # the replay's delta vs the candidate layout
            splice_ops = len(ops)
            edges, mask = fl["shadow"]
            if ops:
                self._splice(edges, mask, ops)
            self.data = dataclasses.replace(self.data, edges=edges, mask=mask, num_edges=o.num_edges)
            self.last_repair = fl["mode"]
        self._wait()
        self.rebuild_state = "commit"
        commit_s = time.perf_counter() - t0
        self.last_rebuild_s = commit_s
        if self.full_rebuild == "differential":
            self.verify_bit_identity()
        self.rebuild_log.append(
            {
                "kind": "full_rebuild",
                "mode": fl["mode"],
                "committed": bool(ok),
                "aborted": False,
                "snapshot_edges": fl["snapshot_edges"],
                "replayed_batches": replayed,
                "splice_ops": splice_ops,
                "flight_batches": self.rebuild_flight - fl["countdown"],
                "dispatch_s": fl["dispatch_s"],
                "commit_s": commit_s,
            }
        )

    def _abort_rebuild(self, reason: str) -> None:
        """Drop an in-flight rebuild: a re-layout (grow / rescale) voided its
        snapshot geometry. The shadow buffers are released (they belong to the
        side stream, whose later work is ordered after the rebuild); drift is
        untouched, so the ladder re-fires once the dust settles."""
        fl, self._flight = self._flight, None
        self.orderer.abort_full_rebuild()
        self.rebuild_state = "abort"
        self.rebuild_log.append(
            {
                "kind": "full_rebuild",
                "mode": fl["mode"],
                "committed": False,
                "aborted": True,
                "abort_reason": reason,
                "snapshot_edges": fl["snapshot_edges"],
                "replayed_batches": 0,
                "splice_ops": 0,
                "flight_batches": self.rebuild_flight - fl["countdown"],
                "dispatch_s": fl["dispatch_s"],
                "commit_s": 0.0,
            }
        )

    def drain_rebuild_events(self) -> list:
        """Completed (committed or aborted) rebuild records since the last
        drain."""
        log, self.rebuild_log = self.rebuild_log, []
        return log

    def _splice(self, edges, mask, ops) -> None:
        """Scatter the commit's replay ops onto the shadow buffers, in place,
        in fixed-capacity chunks (padding targets the re-zeroed scratch
        column, as in the ingest scatter)."""
        e_cap = int(edges.shape[1])
        program = self._splice_program(self.data.k_pad, e_cap)
        for base in range(0, len(ops), _SPLICE_CAP):
            program(edges, mask, *self._slot_op_operands(ops[base : base + _SPLICE_CAP], _SPLICE_CAP, e_cap))

    def _splice_key(self, k_pad: int, e_cap: int):
        return ("splice", k_pad, e_cap, _SPLICE_CAP, self.device)

    def _splice_program(self, k_pad: int, e_cap: int):
        key = self._splice_key(k_pad, e_cap)
        cached = self._programs.get(key)
        if cached is not None:
            return cached

        def splice(edges, mask, rows, cols, vals, mvals):
            edges[rows, cols] = vals
            mask[rows, cols] = mvals
            # Scratch column absorbs the padded no-op writes.
            edges[:, -1, :] = 0
            mask[:, -1] = 0.0

        return self._programs.put(key, splice)

    def _full_key(self, mode: str, k: int, k_pad: int, e_cap: int):
        o = self.orderer
        ks = FRK.eval_ks_full(o.config.k_min, o.config.k_max, k)
        # The objective's distinct counting goes through the segment_rf
        # kernel on a world of one rank, as the JAX package gates it.
        use_pallas = self.g == 1
        return ("full_reorder", mode, k, k_pad, e_cap, ks, use_pallas, self.device)

    def _full_program(self, mode: str, k: int, k_pad: int, e_cap: int):
        """Whole-graph re-order program — the span program generalized to
        s = k (kernels/full_reorder.py). It reads the snapshot rows and
        writes fresh buffers (the shadow half of the double buffer).

        Modes: ``apply`` applies the host geo_order candidate verbatim;
        ``greedy`` runs the step-parallel greedy on the device unless the
        mirror chose the candidate; ``select`` scores greedy vs candidate on
        the device (differential)."""
        spr = e_cap - 1
        cap = k * spr
        key = self._full_key(mode, k, k_pad, e_cap)
        ks, use_pallas = key[5], key[6]
        cached = self._programs.get(key)
        if cached is not None:
            return cached
        num_vertices = self.num_vertices
        dev = self.device
        j = torch.arange(cap, dtype=torch.int64, device=dev)

        def rebuild(blk_e, blk_m, rows, cand, use_cand, params, steps):
            u = blk_e[:, :spr, 0].reshape(cap)
            v = blk_e[:, :spr, 1].reshape(cap)
            valid = blk_m[:, :spr].reshape(cap) > 0
            n = valid.sum()
            if mode == "apply":
                order = cand
            else:
                alpha, beta, delta, permpos = params
                permpos_t = torch.from_numpy(np.asarray(permpos, dtype=np.int32)).to(dev)
                if mode == "select":
                    order = FRK.select_full_order_device(
                        u, v, valid, num_vertices, cand, ks, alpha, beta, delta, permpos_t,
                        use_pallas=use_pallas, steps=steps,
                    )
                elif use_cand:  # greedy: the mirror's exact decision
                    order = cand
                else:
                    order = FRK.full_order_device(
                        u, v, valid, num_vertices, alpha, beta, delta, permpos_t, steps=steps
                    )
            blk, mblk = _splice_layout(u, v, order.long(), n, j, k, spr)
            edges = torch.zeros((k_pad, e_cap, 2), dtype=torch.int32, device=dev)
            mask = torch.zeros((k_pad, e_cap), dtype=torch.float32, device=dev)
            edges[rows] = blk
            mask[rows] = mblk
            return edges, mask

        return self._programs.put(key, rebuild)

    def _partial_rung(self) -> None:
        """Execute the partial rung in the configured mode. Host bookkeeping
        (slot array, drift counters) always advances through the orderer —
        via the byte-exact numpy mirror for the device modes — so the monitor
        needs no device readback."""
        with self.tracer.span("rung.partial"):
            self._partial_rung_inner()

    def _partial_rung_inner(self) -> None:
        o = self.orderer
        if self.span_repair == "host":
            o.partial_reorder()  # slot ops picked up by _sync_pending below
            self._sync_pending()
            self.last_repair = "host"
            return
        with self.tracer.span("rung.span_mirror"):  # the host side: candidate + mirror
            r0, r1 = o.span_bounds()
            u, v, valid = o.span_arrays(r0, r1)
            if int(valid.sum()) < 2:
                self.last_repair = "skipped"
                return
            if self.span_repair == "device":
                cand = SRK.identity_candidate(valid)
            else:  # "oracle" | "differential": host geo_order on the span
                cand = o.geo_span_candidate(u, v, valid)
            use_cand = False
            if self.span_repair == "oracle":
                o.apply_span_order(r0, r1, cand, emit_ops=False)
            else:
                _, use_cand = o.partial_reorder_mirror(region=r0, candidate=cand, emit_ops=False)
        with self.tracer.span("rung.span_device"):
            self._span_repair_device(r0, r1, cand, use_cand)
        self.last_repair = self.span_repair

    def _span_repair_device(self, r0: int, r1: int, cand: np.ndarray, use_cand: bool) -> None:
        """Run the cached span-repair program over regions [r0, r1): extract
        the span's live slots from the buffers, re-order, splice back —
        nothing read back (the host mirror already advanced the slot array).
        In the production mode the mirror's exact candidate decision picks the
        branch; differential mode keeps the whole selection, objectives
        included, on the device."""
        o = self.orderer
        mode = {"oracle": "apply", "differential": "select"}.get(self.span_repair, "greedy")
        program = self._span_program(mode, o.regions, self.data.k_pad, int(self.data.edges.shape[1]), r1 - r0)
        program(self.data, self._rows(range(r0, r1)), self._operand(cand), use_cand)
        # Wait here so the rung's reported cost includes the device program.
        # Degrees untouched: a re-order never changes the graph.
        self._wait()

    def _span_key(self, mode: str, k: int, k_pad: int, e_cap: int, s: int):
        ks = SRK.eval_ks(self.orderer.config.k_min, self.orderer.config.k_max)
        use_pallas = self.g == 1
        return ("span_repair", mode, k, k_pad, e_cap, s, ks, use_pallas, self.device)

    def _span_program(self, mode: str, k: int, k_pad: int, e_cap: int, s: int):
        """Span-repair program, cached per static signature: span length, k
        and e_cap changes all re-key.

        Modes: ``greedy`` recomputes the expansion order on the device unless
        the mirror chose the candidate; ``select`` scores both orders on the
        device too (differential); ``apply`` applies the candidate verbatim
        (the geo_order oracle)."""
        spr = e_cap - 1
        cap = s * spr
        key = self._span_key(mode, k, k_pad, e_cap, s)
        ks, use_pallas = key[6], key[7]
        cached = self._programs.get(key)
        if cached is not None:
            return cached
        num_vertices = self.num_vertices
        j = torch.arange(cap, dtype=torch.int64, device=self.device)

        def repair(data, rows, cand, use_cand):
            blk_e = data.edges[rows]  # (s, e_cap, 2) — span rows only
            blk_m = data.mask[rows]
            u = blk_e[:, :spr, 0].reshape(cap)
            v = blk_e[:, :spr, 1].reshape(cap)
            valid = blk_m[:, :spr].reshape(cap) > 0
            n = valid.sum()
            if mode == "apply" or (mode == "greedy" and use_cand):
                order = cand
            elif mode == "select":
                order = SRK.select_span_order_device(u, v, valid, num_vertices, cand, ks, use_pallas=use_pallas)
            else:
                order = SRK.span_order_device(u, v, valid, num_vertices)
            blk, mblk = _splice_layout(u, v, order.long(), n, j, s, spr)
            data.edges[rows] = blk
            data.mask[rows] = mblk

        return self._programs.put(key, repair)

    def rf_vs_oracle(self, k: Optional[int] = None) -> tuple[float, float]:
        """(incremental RF, full geo_order re-run RF) at k (default: current
        partition count) — the acceptance margin check."""
        return self.orderer.rf_vs_oracle(self.k if k is None else int(k))


def _splice_layout(u, v, order, n, j, s: int, spr: int):
    """The ``(s, spr+1, 2)`` edge rows and ``(s, spr+1)`` mask rows of the
    live slots in ``order``, CEP-spread over ``s`` regions of ``spr`` slots
    (``splice_targets_device``) with a zero scratch column. Dead positions
    all target the overflow slot, with zeros."""
    cap = s * spr
    tgt = SRK.splice_targets_device(n, s, spr, cap)
    live = j < n
    dev = u.device
    new_u = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    new_v = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    new_m = torch.zeros(cap + 1, dtype=torch.float32, device=dev)
    new_u[tgt] = torch.where(live, u[order], 0)
    new_v[tgt] = torch.where(live, v[order], 0)
    new_m[tgt] = live.to(torch.float32)
    blk = torch.zeros((s, spr + 1, 2), dtype=torch.int32, device=dev)
    blk[:, :spr, 0] = new_u[:cap].reshape(s, spr)
    blk[:, :spr, 1] = new_v[:cap].reshape(s, spr)
    mblk = torch.zeros((s, spr + 1), dtype=torch.float32, device=dev)
    mblk[:, :spr] = new_m[:cap].reshape(s, spr)
    return blk, mblk
