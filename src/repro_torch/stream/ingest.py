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

Over a ``GraphGroup`` of g ranks (``launch/mesh.py``) every rank runs one
replica of the host orderer. The replicas are deterministic, so every rank
makes the same ladder and rescale decisions with no communication; each rank
holds its row block of the pack (partition p on rank p % g, at local row
p // g) and every rank holds the degrees. Per family:

* **scatter** and **splice**: a rank keeps the slot ops of its own regions;
  every rank adds every degree delta. No collective.
* **compact**: from the replicated gather map each rank builds the gather
  operands of its new block only. A slot whose old region lies on another
  rank is sent by that rank: one contiguous ``(n, 2)`` int32 message for each
  ordered pair of ranks, in one order every rank derives from the same map
  (``multihost.exchange``).
* **span_repair** and **full_reorder**: the span's rows (the whole pack, for
  the full rung) are gathered to every rank by one ``all_gather_rows`` of a
  fixed block a rank; every rank runs the same program on the same rows and
  keeps its own rows of the result. The full rung gathers on the ingest
  stream and runs its program on the side stream over that copy: no
  collective runs on the side stream.

A world of one is the degenerate case of the same code: its gathers and
exchanges return their input.

Bit-identity contract (DESIGN.md §9): after any sequence of ingests,
rescales, span repairs and rebuild commits, ``unshard_engine_data(engine.data)``
equals the host-side ``pack_slots`` oracle byte for byte
(``verify_bit_identity``, a collective whose verdict is reduced over the
ranks before any rank raises).
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
from ..launch import multihost as MH
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

    ``engine.data`` is always a live ``ShardedEngineData`` holding this rank's
    row block: the GAS algorithms (pagerank / sssp / wcc) run on it unchanged
    between — and across — ingests, because the slot layout is mask-driven.

    ``device=None`` means ``"cuda"`` and raises without a card; the CPU runs
    only when asked for (``device="cpu"``). ``group`` is the graph axis, a
    world of one on ``device`` by default; with a group the engine runs on the
    group's device, and every rank of the group drives its own engine with
    the same calls. ``commit`` says how the first pack is committed:
    ``"pack"`` packs the host slot arrays and uploads this rank's rows (no
    collective); ``"stream"`` streams them region by region through
    ``pack_slots_sharded_stream`` (``from_restored``).

    Unlike the reference, it takes no ``warm_scatter_caps``: the reference
    compiles its scatter programs ahead for those capacities, and the port's
    programs are torch ops with nothing to compile.
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
        commit: str = "pack",
    ):
        if span_repair not in ("device", "host", "oracle", "differential"):
            raise ValueError(f"unknown span_repair mode {span_repair!r}")
        if full_rebuild not in ("host", "geo", "device", "differential"):
            raise ValueError(f"unknown full_rebuild mode {full_rebuild!r}")
        if rebuild_flight < 0:
            raise ValueError("rebuild_flight must be >= 0")
        if commit not in ("pack", "stream"):
            raise ValueError(f"unknown commit mode {commit!r}")
        if group is None:
            self.device = resolve_device(device)
            self.group = make_graph_group(self.device)
        else:
            self.group = group
            self.device = group.torch_device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the group's device {self.device}")
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
        # Bytes this rank moves: scatter operands up to its device, rows it
        # receives in the span and snapshot gathers, rescale traffic.
        self._m_bytes = {name: m.counter(f"stream.{name}_bytes") for name in (
            "scatter.upload", "span.gather", "rebuild.gather", "rescale.sent", "rescale.received")}
        self.data = self._upload() if commit == "pack" else self._stream_upload()
        orderer.needs_resync = False
        self._warm_programs()

    @classmethod
    def from_restored(cls, orderer: IncrementalOrderer, device=None, *, group: GraphGroup | None = None,
                      **kwargs) -> "StreamingEngine":
        """An engine around a restored orderer, its first pack committed by
        ``pack_slots_sharded_stream`` (``commit="stream"``): region p's slot
        range feeds the commit one region at a time, and each rank stages
        only the rows it holds. Ingest then goes on as on an engine that
        never stopped: its pack equals the ``"pack"`` commit byte for byte."""
        return cls(orderer, device, group=group, commit="stream", **kwargs)

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
        """Pack the host slot arrays and upload this rank's rows (no collective)."""
        o = self.orderer
        return graph_engine.pack_slots_sharded(
            o.slot_src, o.slot_dst, o.slot_valid, o.regions, o.num_vertices, self.group
        )

    def _stream_upload(self) -> graph_engine.ShardedEngineData:
        """The shard-streamed commit (``from_restored``): region p's slot
        range is its partition, so ``part_fn`` is a slice."""
        o = self.orderer
        spr = o.slots_per_region

        def part_fn(p: int):
            lo, hi = p * spr, (p + 1) * spr
            return o.slot_src[lo:hi], o.slot_dst[lo:hi], o.slot_valid[lo:hi]

        with self.tracer.span("ingest.stream_commit"):
            return graph_engine.pack_slots_sharded_stream(part_fn, o.regions, o.num_vertices, self.group, spr)

    def _operand(self, arr: np.ndarray) -> torch.Tensor:
        """A host-built operand (scatter indices, gather maps) on the device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _own(self, parts) -> list:
        """The partitions among ``parts`` whose rows this rank holds."""
        return [p for p in parts if p % self.g == self.group.rank]

    def _local_ops(self, ops) -> list:
        """The slot ops of this rank's regions."""
        spr = self.orderer.slots_per_region
        return [op for op in ops if (op.slot // spr) % self.g == self.group.rank]

    def _gather_partitions(self, parts, counter: str):
        """The rows of ``parts`` (ascending) from every rank, in ``parts``
        order, on this rank's device: ``(len(parts), e_cap, 2)`` edges and
        ``(len(parts), e_cap)`` mask. Each rank packs its own rows among
        ``parts`` (the mask's bits as a third int32 channel) into a block of
        ⌈len(parts)/g⌉ rows, zero-padded, and one ``all_gather_rows`` brings
        every block to every rank; a rank with no rows there still sends its
        block. A collective at g > 1."""
        g = self.g
        per = -(-len(parts) // g)
        own = self._own(parts)
        e_cap = int(self.data.edges.shape[1])
        local = self._operand(np.asarray([p // g for p in own], dtype=np.int64))
        block = torch.zeros((per, e_cap, 3), dtype=torch.int32, device=self.device)
        block[: len(own), :, :2] = self.data.edges[local]
        block[: len(own), :, 2] = self.data.mask[local].view(torch.int32)
        whole = MH.all_gather_rows(block, self.group)  # (g·per, e_cap, 3), rank-major
        # Rank q's block holds its partitions among ``parts`` in order.
        slot_of, seen = [], [0] * g
        for p in parts:
            slot_of.append((p % g) * per + seen[p % g])
            seen[p % g] += 1
        rows = whole[self._operand(np.asarray(slot_of, dtype=np.int64))]
        self._m_bytes[counter].inc(whole.numel() * whole.element_size())
        return rows[..., :2], rows[..., 2].contiguous().view(torch.float32)

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
        host ``pack_slots`` oracle byte for byte and this rank's padding rows
        are zero. A collective at g > 1 (the unshard gathers every rank's
        rows); the verdict is reduced over the ranks (``all_reduce`` MIN)
        before any rank raises, so every rank raises together."""
        got = graph_engine.unshard_engine_data(self.data)
        o = self.orderer
        want = graph_engine.host_pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, o.num_vertices)
        pad = self._operand(np.asarray([i for i, p in enumerate(self.data.local_partitions()) if p >= o.regions],
                                       dtype=np.int64))
        ok_here = all(
            np.array_equal(t.cpu().numpy(), w) for t, w in zip((got.edges, got.mask, got.degrees), want)
        ) and not bool(self.data.edges[pad].any()) and not bool(self.data.mask[pad].any())
        ok_all = int(MH.all_reduce(torch.tensor([int(ok_here)]), self.group, "min")[0])
        if not ok_all:
            where = "seen on this rank" if not ok_here else "seen on another rank"
            raise AssertionError(f"streaming pack diverged from the host slot oracle (rank {self.group.rank} of "
                                 f"{self.g}: {where})")
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
        """(rows, cols, vals, mvals) of this rank's ``ops`` padded to ``cap``,
        rows local to its block (region p at row p // g): padding targets the
        scratch column of local row 0 with zeros."""
        spr = self.orderer.slots_per_region
        rows = np.zeros(cap, dtype=np.int64)
        cols = np.full(cap, e_cap - 1, dtype=np.int64)
        vals = np.zeros((cap, 2), dtype=np.int32)
        mvals = np.zeros(cap, dtype=np.float32)
        for i, op in enumerate(ops):
            rows[i] = op.slot // spr // self.g
            cols[i] = op.slot % spr
            if op.valid:
                vals[i] = (op.u, op.v)
                mvals[i] = 1.0
        return [self._operand(a) for a in (rows, cols, vals, mvals)]

    def _scatter_inner(self, ops, deg: dict) -> None:
        o = self.orderer
        k_pad = self.data.k_pad
        e_cap = int(self.data.edges.shape[1])  # slots_per_region + scratch
        ops = self._local_ops(ops)
        cap = _next_pow2(max(len(ops), (len(deg) + 1) // 2, _MIN_OP_CAPACITY))
        self._seen_scatter_caps.add(cap)
        # Every rank adds every degree delta: the degrees are replicated.
        verts = np.zeros(2 * cap, dtype=np.int64)
        dvals = np.zeros(2 * cap, dtype=np.float32)
        for i, (v, d) in enumerate(sorted(deg.items())):
            verts[i] = v
            dvals[i] = float(d)
        operands = self._slot_op_operands(ops, cap, e_cap) + [self._operand(verts), self._operand(dvals)]
        self._m_bytes["scatter.upload"].inc(sum(t.numel() * t.element_size() for t in operands))
        self._scatter_program(k_pad, e_cap, cap)(self.data, *operands)
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
        gather map executes as one compact gather into this rank's new block.
        Slots whose old region lies on another rank arrive from it through
        ``multihost.exchange`` (a collective at g > 1: every rank calls it)."""
        t0 = time.perf_counter()
        o = self.orderer
        # Flush what the host applied since the last device sync: the gather
        # map below describes the post-flush layout.
        self._sync_pending()
        # A rescale re-layouts every slot: an in-flight rebuild's snapshot
        # geometry (and its shadow buffers' shape) is void — abort it.
        if self._flight is not None:
            self._abort_rebuild("rescale")
        g, me = self.g, self.group.rank
        k_old, spr_old = o.regions, o.slots_per_region
        k_new = int(k_new)
        old_edges = self.data.edges
        with self.tracer.span("rescale.relayout"):
            o.relayout(k_new)
            gm = o.drain_gather_map()
        spr_new = o.slots_per_region
        e_cap_new = spr_new + 1
        m_new = SH.padded_partition_count(k_new, g) // g

        new_slots = np.flatnonzero(gm >= 0)
        old_slots = gm[new_slots]
        new_regions = new_slots // spr_new
        old_regions = old_slots // spr_old
        dst_rank, src_rank = new_regions % g, old_regions % g
        moved_slots = new_regions != old_regions
        moved = int(np.count_nonzero(moved_slots))
        cross = int(np.count_nonzero(moved_slots & (dst_rank != src_rank)))
        procs = SH.device_process_map(self.group)
        xproc = int(np.count_nonzero(moved_slots & (procs[dst_rank] != procs[src_rank])))
        # This rank's new block: every slot it holds at k_new is valid; the
        # ones whose old region is its own too are gathered from its old block.
        mine = dst_rank == me
        rows_new, cols_new = new_regions[mine] // g, new_slots[mine] % spr_new
        src_here = src_rank[mine] == me
        src_row = np.zeros((m_new, e_cap_new), dtype=np.int32)
        src_col = np.zeros((m_new, e_cap_new), dtype=np.int32)
        validf = np.zeros((m_new, e_cap_new), dtype=np.float32)
        validf[rows_new, cols_new] = 1.0
        src_row[rows_new[src_here], cols_new[src_here]] = old_regions[mine][src_here] // g
        src_col[rows_new[src_here], cols_new[src_here]] = old_slots[mine][src_here] % spr_old
        # One message per ordered pair of ranks, its slots in new-slot order,
        # tagged source · g + destination: sender and receiver derive the
        # same list from the same map. Flat (row · e_cap + col) positions.
        e_cap_old = int(old_edges.shape[1])
        from_me = src_rank == me
        out_flat = (old_regions[from_me] // g) * e_cap_old + old_slots[from_me] % spr_old
        out_peer = dst_rank[from_me]
        in_flat = rows_new * e_cap_new + cols_new
        in_peer = src_rank[mine]
        sends, recvs = [], []
        for peer in range(g):
            if peer == me:
                continue
            out_sel = out_peer == peer
            if out_sel.any():
                sends.append((peer, self._operand(out_flat[out_sel]), me * g + peer))
            in_sel = in_peer == peer
            if in_sel.any():
                recvs.append((peer, self._operand(in_flat[in_sel]), peer * g + me))
        # Every replica must have taken the same decision; this reduction
        # also runs a collective on the group before its first exchange.
        self._check_replicas(k_old, k_new, o.num_edges, moved)
        program = self._compact_program((int(old_edges.shape[0]), e_cap_old, m_new, e_cap_new, self.device))
        with self.tracer.span("rescale.exchange"):  # the cross-rank slots, waited for
            arrived = [torch.empty((idx.numel(), 2), dtype=torch.int32, device=self.device) for _, idx, _ in recvs]
            sent, received = MH.exchange(
                self.group,
                [(peer, old_edges.view(-1, 2)[idx], tag) for peer, idx, tag in sends],
                [(peer, out, tag) for (peer, _, tag), out in zip(recvs, arrived)],
            )
            self._wait()
        with self.tracer.span("rescale.compact"):  # upload of the gather map + the gather, waited for
            edges, mask = program(
                old_edges, self._operand(src_row), self._operand(src_col), self._operand(validf)
            )
            for (_, idx, _), rows in zip(recvs, arrived):
                edges.view(-1, 2)[idx] = rows
            self._wait()
        self.data = graph_engine.ShardedEngineData(
            edges=edges,
            mask=mask,
            degrees=self.data.degrees,  # same graph, degrees unchanged
            num_vertices=self.num_vertices,
            k=k_new,
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
        # This rank's share of the cross-rank traffic: summed over the ranks,
        # each equals cross_device_bytes.
        self._m_bytes["rescale.sent"].inc(sent)
        self._m_bytes["rescale.received"].inc(received)
        if verify:
            self.verify_bit_identity()
        return StreamRescaleStats(
            k_old=k_old,
            k_new=k_new,
            num_edges=o.num_edges,
            moved_edges=moved,
            cep_plan_edges=cep.migrated_edges_exact(o.num_edges, k_old, k_new),
            cross_device_edges=cross,
            cross_device_bytes=cross * EDGE_BYTES,
            elapsed_s=elapsed,
            cross_process_edges=xproc,
            cross_process_bytes=xproc * EDGE_BYTES,
        )

    def _check_replicas(self, *values: int) -> None:
        """Raise on every rank unless every rank passed the same ``values``
        (one ``all_reduce`` MIN of the values and their negations)."""
        t = torch.tensor([*values, *(-v for v in values)], dtype=torch.int64)
        if not torch.equal(MH.all_reduce(t, self.group, "min"), t):
            raise RuntimeError(f"the ranks' orderer replicas diverged: rank {self.group.rank} has {values}")

    def _compact_program(self, key):
        cached = self._programs.get(("compact",) + key)
        if cached is not None:
            return cached

        def compact(edges_old, src_row, src_col, validf):
            # Slots that arrive from other ranks gather a placeholder here and
            # are overwritten by the exchange's rows.
            gathered = edges_old[src_row.long(), src_col.long()]  # (m_new, e_cap_new, 2)
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
        # The snapshot: all k rows as the ingest stream has them now, gathered
        # to every rank on the ingest stream. Later scatters write the live
        # buffers, never these copies.
        with self.tracer.span("rebuild.gather"):
            blk_e, blk_m = self._gather_partitions(range(o.regions), "rebuild.gather")
        own = self._own(range(o.regions))
        operands = [blk_e, blk_m, self._operand(np.asarray([p // self.g for p in own], dtype=np.int64)),
                    self._operand(np.asarray(own, dtype=np.int64)), self._operand(cand)]
        side = self._rebuild_stream()
        if side is None:
            shadow = program(*operands, use_cand, params, steps)
            done = None
        else:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                shadow = program(*operands, use_cand, params, steps)
                done = torch.cuda.Event()
                done.record(side)
            for t in operands:
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
        """Scatter the commit's replay ops of this rank's regions onto its
        shadow buffers, in place, in fixed-capacity chunks (padding targets
        the re-zeroed scratch column, as in the ingest scatter)."""
        e_cap = int(edges.shape[1])
        program = self._splice_program(self.data.k_pad, e_cap)
        ops = self._local_ops(ops)
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
        return ("full_reorder", mode, k, k_pad, e_cap, ks, self.device)

    def _full_program(self, mode: str, k: int, k_pad: int, e_cap: int):
        """Whole-graph re-order program — the span program generalized to
        s = k (kernels/full_reorder.py). It reads the snapshot of all k rows
        and writes fresh buffers of this rank's block (the shadow half of the
        double buffer).

        Modes: ``apply`` applies the host geo_order candidate verbatim;
        ``greedy`` runs the step-parallel greedy on the device unless the
        mirror chose the candidate; ``select`` scores greedy vs candidate on
        the device (differential), the objectives through
        ``segment_distinct_counts``."""
        spr = e_cap - 1
        cap = k * spr
        key = self._full_key(mode, k, k_pad, e_cap)
        ks = key[5]
        cached = self._programs.get(key)
        if cached is not None:
            return cached
        num_vertices = self.num_vertices
        dev = self.device
        m = k_pad // self.g
        j = torch.arange(cap, dtype=torch.int64, device=dev)

        def rebuild(blk_e, blk_m, local, at, cand, use_cand, params, steps):
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
                        use_pallas=True, steps=steps,
                    )
                elif use_cand:  # greedy: the mirror's exact decision
                    order = cand
                else:
                    order = FRK.full_order_device(
                        u, v, valid, num_vertices, alpha, beta, delta, permpos_t, steps=steps
                    )
            blk, mblk = _splice_layout(u, v, order.long(), n, j, k, spr)
            edges = torch.zeros((m, e_cap, 2), dtype=torch.int32, device=dev)
            mask = torch.zeros((m, e_cap), dtype=torch.float32, device=dev)
            edges[local] = blk[at]
            mask[local] = mblk[at]
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
        """Run the cached span-repair program over regions [r0, r1): gather
        the span's rows to every rank, extract their live slots, re-order,
        and write back the rows this rank holds — nothing read back (the host
        mirror already advanced the slot array). Every rank runs the same
        program on the same rows, so each keeps its rows of one result. In
        the production mode the mirror's exact candidate decision picks the
        branch; differential mode keeps the whole selection, objectives
        included, on the device."""
        o = self.orderer
        parts = range(r0, r1)
        mode = {"oracle": "apply", "differential": "select"}.get(self.span_repair, "greedy")
        program = self._span_program(mode, o.regions, self.data.k_pad, int(self.data.edges.shape[1]), r1 - r0)
        with self.tracer.span("rung.span_gather"):
            blk_e, blk_m = self._gather_partitions(parts, "span.gather")
        with self.tracer.span("rung.span_program"):
            blk, mblk = program(blk_e, blk_m, self._operand(cand), use_cand)
            own = self._own(parts)
            local = self._operand(np.asarray([p // self.g for p in own], dtype=np.int64))
            at = self._operand(np.asarray([p - r0 for p in own], dtype=np.int64))
            self.data.edges[local] = blk[at]
            self.data.mask[local] = mblk[at]
            # Wait here so the rung's reported cost includes the device program.
            # Degrees untouched: a re-order never changes the graph.
            self._wait()

    def _span_key(self, mode: str, k: int, k_pad: int, e_cap: int, s: int):
        ks = SRK.eval_ks(self.orderer.config.k_min, self.orderer.config.k_max)
        return ("span_repair", mode, k, k_pad, e_cap, s, ks, self.device)

    def _span_program(self, mode: str, k: int, k_pad: int, e_cap: int, s: int):
        """Span-repair program, cached per static signature: span length, k
        and e_cap changes all re-key. It takes the span's ``(s, e_cap)`` rows
        and returns their repaired layout.

        Modes: ``greedy`` recomputes the expansion order on the device unless
        the mirror chose the candidate; ``select`` scores both orders on the
        device too (differential), the objectives' distinct counts through
        ``segment_distinct_counts`` (the CUDA ``segment_rf`` kernel on a card);
        ``apply`` applies the candidate verbatim (the geo_order oracle)."""
        spr = e_cap - 1
        cap = s * spr
        key = self._span_key(mode, k, k_pad, e_cap, s)
        ks = key[6]
        cached = self._programs.get(key)
        if cached is not None:
            return cached
        num_vertices = self.num_vertices
        j = torch.arange(cap, dtype=torch.int64, device=self.device)

        def repair(blk_e, blk_m, cand, use_cand):
            u = blk_e[:, :spr, 0].reshape(cap)
            v = blk_e[:, :spr, 1].reshape(cap)
            valid = blk_m[:, :spr].reshape(cap) > 0
            n = valid.sum()
            if mode == "apply" or (mode == "greedy" and use_cand):
                order = cand
            elif mode == "select":
                order = SRK.select_span_order_device(u, v, valid, num_vertices, cand, ks, use_pallas=True)
            else:
                order = SRK.span_order_device(u, v, valid, num_vertices)
            return _splice_layout(u, v, order.long(), n, j, s, spr)

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
