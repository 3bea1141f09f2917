"""Incremental maintenance of the GEO-ordered edge list under updates.

The ordered edge list (DESIGN.md §2 — the single source of truth every packed
layout views) is held in a gap-buffer / packed-memory-array **slot array**:
``capacity = regions · slots_per_region`` slots, each empty or holding one
edge. Region p (== device partition p of the streaming pack) owns the
contiguous slot range ``[p·spr, (p+1)·spr)``; the logical edge order is slot
order restricted to occupied slots. Gaps are the per-partition slack capacity
(DESIGN.md §9): inserting an edge fills a gap, deleting tombstones a slot, and
neither shifts any other edge — which is what lets the device mirror apply an
``EdgeUpdateBatch`` as a tiny scatter instead of a re-pack.

Placement policy (the incremental analogue of GEO's locality greedy): a new
edge's *target* is the median slot of its endpoints' existing edges; candidate
regions — the median's region vs append-at-end — are scored by the exact
Eq.-(7)-style region objective delta ``(u ∉ V_p) + (v ∉ V_p)`` maintained in
O(1) per-region vertex counters, so locality placement never scores worse than
appending. The free slot nearest the target is used, searched within the
two-hop δ window reused from ``core/ordering.py`` (δ = capacity / k_max by
default); ``best_insert_position`` is the exact ``ordering_objective`` oracle
of the same decision, used by the property tests.

Escalation ladder (DESIGN.md §9): when the monitored objective drifts past a
threshold, the partial rung re-orders only the degraded span of regions —
on the device by default (``ingest.StreamingEngine`` delegates via
``maybe_escalate(partial_fn=...)`` and this class advances the host slot
array through ``partial_reorder_mirror``, the byte-exact numpy twin of the
device program in ``kernels/span_reorder.py``); ``partial_reorder`` keeps the
host ``geo_order``-on-the-span rung, which doubles as the repair-quality
oracle. ``full_rebuild`` re-runs ``geo_order`` on the whole current graph — a
full ``geo_order`` re-run is the oracle the incremental order must stay
within ``StreamConfig.rf_margin`` of (``rf_vs_oracle``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import cep, metrics, ordering
from ..core.graph import Graph
from .updates import EdgeUpdateBatch

__all__ = ["StreamConfig", "IncrementalOrderer", "SlotOp", "best_insert_position"]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Tuning knobs of the incremental orderer + quality monitor."""

    slack: float = 0.5  # free-slot fraction per region (gap-buffer headroom)
    k_min: int = ordering.K_MIN_DEFAULT  # objective range for GEO re-runs
    k_max: int = ordering.K_MAX_DEFAULT
    delta: Optional[int] = None  # placement search window; None → capacity // k_max
    partial_drift: float = 1.04  # normalized drift that triggers a span re-order
    full_drift: float = 1.08  # drift that escalates to a full geo_order rebuild
    span_regions: int = 1  # width (in regions) of a partial re-order
    partial_cooldown: int = 0  # monitor steps to skip after a partial repair
    # (hysteresis: a span repair needs fresh updates before repairing again
    # pays for itself; 0 = PR-3 behavior, re-fire while over threshold)
    rf_margin: float = 1.10  # incremental RF must stay within this × oracle RF

    def __post_init__(self):
        if not 0.0 < self.slack:
            raise ValueError("slack must be > 0")
        if self.partial_drift > self.full_drift:
            raise ValueError("partial_drift must not exceed full_drift")


@dataclasses.dataclass(frozen=True)
class SlotOp:
    """One slot mutation for the device mirror. ``u, v`` are always the edge's
    endpoints — on a tombstone (valid=False) the device writes zeros to the
    slot but still needs the endpoints for the degree update."""

    slot: int
    u: int
    v: int
    valid: bool


def best_insert_position(
    src_o: np.ndarray,
    dst_o: np.ndarray,
    u: int,
    v: int,
    num_vertices: int,
    k: int,
) -> int:
    """Exact-objective oracle of the incremental placement decision.

    Candidates are the median position of (u, v)'s existing edges and
    append-at-end; each is scored by ``ordering.ordering_objective`` with
    ``k_min = k_max = k`` on the list-with-insertion. Returns the best
    insertion index (ties → the median, i.e. locality wins). By construction
    the returned position's objective is never worse than append-at-end —
    the invariant the production O(1) region-counter placement approximates.
    Tiny lists only (each candidate costs a full objective evaluation).
    """
    src_o = np.asarray(src_o, dtype=np.int64)
    dst_o = np.asarray(dst_o, dtype=np.int64)
    n = src_o.shape[0]
    hits = np.flatnonzero((src_o == u) | (dst_o == u) | (src_o == v) | (dst_o == v))
    candidates = [int(n)]  # append-at-end is always a candidate
    if hits.size:
        candidates.insert(0, int(hits[hits.size // 2]))

    def objective(pos: int) -> float:
        s = np.insert(src_o, pos, min(u, v))
        d = np.insert(dst_o, pos, max(u, v))
        return ordering.ordering_objective(s, d, n + 1, num_vertices, k, k)

    scores = [objective(p) for p in candidates]
    return candidates[int(np.argmin(scores))]  # argmin keeps first on ties


class IncrementalOrderer:
    """Maintains the ordered edge list in a region-sliced slot array.

    The slot array is the host source of truth the device streaming pack
    mirrors slot-for-slot (``ingest.StreamingEngine``); ``drain_ops`` hands
    the engine exactly the slots each ``apply`` touched.
    """

    def __init__(
        self,
        src_ordered: np.ndarray,
        dst_ordered: np.ndarray,
        num_vertices: int,
        *,
        regions: int,
        config: StreamConfig = StreamConfig(),
    ):
        if regions < 1:
            raise ValueError("regions must be >= 1")
        self.num_vertices = int(num_vertices)
        self.config = config
        self.needs_resync = False  # set by re-layouts; cleared by the engine
        self._cooldown = 0  # partial-rung hysteresis counter (maybe_escalate)
        self._ops: dict[int, SlotOp] = {}
        self._deg_delta: dict[int, int] = {}  # vertex → degree change since drain
        # Async full-rebuild recording: while a rebuild is in flight, every
        # applied batch is ALSO queued here so the commit can replay it onto
        # the rebuilt order (DESIGN.md §11). None = no rebuild in flight.
        self._rebuild_delta: Optional[list] = None
        self._layout(
            np.asarray(src_ordered, dtype=np.int64),
            np.asarray(dst_ordered, dtype=np.int64),
            regions,
        )
        self._set_baseline()

    # ------------------------------------------------------------ properties
    @property
    def regions(self) -> int:
        return self._regions

    @property
    def slots_per_region(self) -> int:
        return self._spr

    @property
    def capacity(self) -> int:
        return self._regions * self._spr

    @property
    def num_edges(self) -> int:
        return len(self._edge2slot)

    @property
    def delta(self) -> int:
        if self.config.delta is not None:
            return int(self.config.delta)
        return max(1, self.capacity // self.config.k_max)

    # ---------------------------------------------------------------- layout
    def _layout(self, src_o: np.ndarray, dst_o: np.ndarray, regions: int, spr: Optional[int] = None) -> None:
        """(Re)build the slot array from an ordered list: CEP chunk at
        k=regions, each chunk's edges spread evenly over its region's slots so
        gaps are interleaved (PMA style) and early inserts never shift."""
        e = int(src_o.shape[0])
        if spr is None:
            raw = max(2, int(np.ceil(e * (1.0 + self.config.slack) / regions)))
            prev = self._spr if getattr(self, "_regions", None) == regions else None
            if prev is not None and prev >= raw:
                # Same region count and the current width still fits: KEEP it.
                # slots_per_region defines the device buffer width, i.e. the
                # static signature of every cached scatter / compact /
                # span-repair program — a full rebuild at |E|+500 must not
                # recompile three programs.
                spr = prev
            else:
                # Fresh width: 25% growth headroom, 256-aligned, so a k-phase
                # of steady ingest re-laying out at every full rebuild stays
                # on one program signature (compiles only at k changes, which
                # the engine warms inside the rescale).
                spr = max(2, -(-int(np.ceil(raw * 1.25)) // 256) * 256)
        self._regions = int(regions)
        self._spr = int(spr)
        # Checkpoint bookkeeping (DESIGN.md §15): a re-layout rewrites every
        # region, invalidates slot-addressed recovery ops, and changes the
        # chunk geometry the incremental snapshot addresses by — bump the
        # epoch so the checkpoint layer forces a full snapshot.
        self.layout_epoch = getattr(self, "layout_epoch", -1) + 1
        self._dirty_regions: set[int] = set(range(int(regions)))
        self._rec_ops: dict[int, tuple[int, int, bool]] = {}
        c = self.capacity
        self.slot_src = np.zeros(c, dtype=np.int64)
        self.slot_dst = np.zeros(c, dtype=np.int64)
        self.slot_valid = np.zeros(c, dtype=bool)
        self._edge2slot: dict[tuple[int, int], int] = {}
        self._incident: dict[int, set] = {}
        self._rc: list[dict[int, int]] = [dict() for _ in range(regions)]
        self._free = np.full(regions, self._spr, dtype=np.int64)  # free slots/region
        # Per-region sorted free-slot arrays, built lazily (one vectorized scan
        # per region per batch) and maintained incrementally as slots fill /
        # free — the batched replacement for the per-insert occupancy rescans
        # the placement loop used to do (ROADMAP follow-up).
        self._free_cache: list = [None] * int(regions)
        self._gather_from = None  # new slot ← old slot; only relayout builds it
        if e == 0:
            return
        # Vectorized fill (the same CEP spread the device splice computes):
        # the per-edge dict/set bookkeeping below is bulk-built — this runs on
        # every full rebuild and relayout, so it must not out-cost geo_order.
        bounds = np.asarray(cep.chunk_bounds(e, regions), dtype=np.int64)
        sizes = np.diff(bounds)
        if int(sizes.max()) > self._spr:
            p_bad = int(np.argmax(sizes))
            raise ValueError(
                f"region {p_bad} chunk ({int(sizes[p_bad])} edges) exceeds "
                f"slots_per_region={self._spr}"
            )
        j = np.arange(e, dtype=np.int64)
        p = np.asarray(cep.id2p(e, regions, j), dtype=np.int64)
        n_p = bounds[p + 1] - bounds[p]
        cols = ((j - bounds[p]) * self._spr) // n_p
        slots = p * self._spr + cols
        self.slot_src[slots] = src_o
        self.slot_dst[slots] = dst_o
        self.slot_valid[slots] = True
        self._free -= np.bincount(p, minlength=regions)
        self._edge2slot = dict(zip(zip(src_o.tolist(), dst_o.tolist()), slots.tolist()))
        self._rebuild_region_counts(0, regions, p, src_o, dst_o)
        idx, ws, starts, ends = self._vertex_groups(np.concatenate([src_o, dst_o]))
        sslots = np.concatenate([slots, slots])[idx].tolist()
        self._incident = {
            w: set(sslots[a:b]) for w, a, b in zip(ws, starts, ends)
        }

    def _set_baseline(self) -> None:
        """Record the current normalized objective as 'fresh-GEO quality'.

        Called at construction and after full rebuilds ONLY: partial reorders
        and re-layouts must not move the yardstick, or gradual degradation
        hides behind repeated rebaselining."""
        self._baseline_kappa = self._kappa()

    def _kappa(self) -> float:
        """Σ_p |V(region_p)| normalized by the Thm.-6-style capacity
        |V| + |E| + k, which makes the signal comparable across graph growth
        and region-count changes (both Σ|V_p| and the bound scale with them)."""
        return self.region_vertex_sum() / max(1, self.num_vertices + self.num_edges + self._regions)

    # -------------------------------------------------------------- counters
    @staticmethod
    def _vertex_groups(verts: np.ndarray):
        """Group a per-incidence vertex array: returns (idx, vertices, starts,
        ends) where ``idx`` sorts the incidences by vertex and group g of the
        sorted payload is ``[starts[g]:ends[g]]`` for ``vertices[g]`` — the
        shared bulk-build step of ``_layout`` and ``_rewrite_span``'s
        incident-set bookkeeping."""
        if verts.size == 0:
            return np.zeros(0, dtype=np.int64), [], [], []
        idx = np.argsort(verts, kind="stable")
        sv = verts[idx]
        cut = np.flatnonzero(np.diff(sv)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [sv.size]])
        return idx, sv[starts].tolist(), starts.tolist(), ends.tolist()

    def _rebuild_region_counts(
        self, base: int, regions: int, p: np.ndarray, src_o: np.ndarray, dst_o: np.ndarray
    ) -> None:
        """Region vertex counters for regions [base, base+regions) rebuilt
        from their chunk assignment ``p`` — a region's counts are fully
        determined by its chunk's endpoints."""
        for ridx in range(regions):
            sel = p == ridx
            ids, cnt = np.unique(
                np.concatenate([src_o[sel], dst_o[sel]]), return_counts=True
            )
            self._rc[base + ridx] = dict(zip(ids.tolist(), cnt.tolist()))

    def _count(self, region: int, vertex: int, d: int) -> None:
        rc = self._rc[region]
        n = rc.get(vertex, 0) + d
        if n <= 0:
            rc.pop(vertex, None)
        else:
            rc[vertex] = n

    def region_vertex_sum(self) -> int:
        """Σ_p |V(region_p)| — the monitored Eq.-(7)-style objective (equal to
        ``ordering_objective·|V|`` at k=regions when region fills are equal)."""
        return int(sum(len(rc) for rc in self._rc))

    def drift(self) -> float:
        """Normalized objective now vs at the last full-quality order (init or
        full rebuild): the quality monitor's escalation signal. 1.0 = as good
        as fresh GEO; growth alone is not drift (see ``_kappa``)."""
        return self._kappa() / max(self._baseline_kappa, 1e-12)

    # ----------------------------------------------------------------- apply
    def apply(self, batch: EdgeUpdateBatch) -> dict:
        """Apply one update batch to the slot array. Returns counts
        {inserted, deleted, skipped}. Deletes run first so a batch that
        replaces edges reuses the freed slots. Device-mirror ops accumulate in
        ``drain_ops`` order-insensitively (last write per slot wins)."""
        ins = batch.insert
        if ins.size:
            # Whole-batch range check, vectorized (negative ids would silently
            # wrap in both host np.add.at and the device scatter): reject the
            # batch before any mutation instead of dying halfway through it.
            bad = (ins[:, 0] < 0) | (ins[:, 1] >= self.num_vertices)
            if np.any(bad):
                u, v = ins[int(np.flatnonzero(bad)[0])].tolist()
                raise ValueError(f"edge ({u}, {v}) out of range (|V|={self.num_vertices})")
        if self._rebuild_delta is not None:
            # Double-buffer protocol: the live slot array keeps advancing
            # below; the queued copy replays onto the rebuilt order at commit.
            self._rebuild_delta.append(batch)
        inserted = deleted = skipped = 0
        for u, v in batch.delete.tolist():
            if self._delete(int(u), int(v)):
                deleted += 1
            else:
                skipped += 1
        for u, v in batch.insert.tolist():
            r = self._insert(int(u), int(v))
            if r is None:
                skipped += 1
            else:
                inserted += 1
        return {"inserted": inserted, "deleted": deleted, "skipped": skipped}

    def _delete(self, u: int, v: int) -> bool:
        s = self._edge2slot.pop((u, v), None)
        if s is None:
            return False
        region = s // self._spr
        self.slot_valid[s] = False
        self.slot_src[s] = 0
        self.slot_dst[s] = 0
        self._free[region] += 1
        self._cache_freed(s)
        for w in (u, v):
            inc = self._incident.get(w)
            if inc is not None:
                inc.discard(s)
                if not inc:
                    del self._incident[w]
            self._count(region, w, -1)
            self._deg_delta[w] = self._deg_delta.get(w, 0) - 1
        self._ops[s] = SlotOp(s, u, v, False)
        self._rec_ops[s] = (u, v, False)
        self._dirty_regions.add(region)
        return True

    def _insert(self, u: int, v: int) -> Optional[int]:
        if u == v:
            return None
        u, v = (u, v) if u < v else (v, u)
        if (u, v) in self._edge2slot:
            return None
        if u < 0 or v >= self.num_vertices:
            # Negative ids would silently wrap in both host np.add.at and the
            # device scatter, crediting some other vertex's degree.
            raise ValueError(f"edge ({u}, {v}) out of range (|V|={self.num_vertices})")
        slot = self._place(u, v)
        if slot is None:
            # All regions full: grow the slot array in place (same order,
            # bigger gaps) and retry — the engine re-uploads on resync.
            self.grow()
            slot = self._place(u, v)
            assert slot is not None
        region = slot // self._spr
        self.slot_src[slot] = u
        self.slot_dst[slot] = v
        self.slot_valid[slot] = True
        self._free[region] -= 1
        self._cache_fill(slot)
        self._edge2slot[(u, v)] = slot
        self._incident.setdefault(u, set()).add(slot)
        self._incident.setdefault(v, set()).add(slot)
        self._count(region, u, +1)
        self._count(region, v, +1)
        self._deg_delta[u] = self._deg_delta.get(u, 0) + 1
        self._deg_delta[v] = self._deg_delta.get(v, 0) + 1
        self._ops[slot] = SlotOp(slot, u, v, True)
        self._rec_ops[slot] = (u, v, True)
        self._dirty_regions.add(region)
        return slot

    def _median_slot(self, u: int, v: int) -> Optional[int]:
        """Median incident slot of (u, v) via an O(d) numpy partial sort — the
        element at sorted index d // 2, exactly what sorting would pick."""
        union = self._incident.get(u, set()) | self._incident.get(v, set())
        if not union:
            return None
        arr = np.fromiter(union, dtype=np.int64, count=len(union))
        mid = arr.size // 2
        return int(np.partition(arr, mid)[mid])

    def _place(self, u: int, v: int) -> Optional[int]:
        """Locality-best free slot for (u, v) — see module docstring."""
        target = self._median_slot(u, v)
        candidates: list[int] = []
        if target is not None:
            candidates.append(target // self._spr)
        append_region = self._append_region()
        if append_region is not None and append_region not in candidates:
            candidates.append(append_region)
        candidates = [r for r in candidates if self._free[r] > 0]
        if not candidates:
            return self._any_free_slot(target)
        # Exact region-objective delta: +1 per endpoint the region hasn't seen.
        # min() keeps the FIRST best — the median region — on ties, so
        # locality placement never scores worse than append-at-end.
        best = min(candidates, key=lambda r: (u not in self._rc[r]) + (v not in self._rc[r]))
        want = target if (target is not None and target // self._spr == best) else best * self._spr
        slot = self._free_in(best, near=want)
        if target is not None and slot is not None and abs(slot - target) > self.delta and best != append_region:
            # The δ window around the locality target is saturated: the edge
            # would land far from its neighbors anyway, so fall back to append.
            alt = self._free_in(append_region) if append_region is not None else None
            if alt is not None:
                return alt
        return slot

    def _append_region(self) -> Optional[int]:
        """Region of the append-at-end position: the last region with a free
        slot (append-at-end of the occupied prefix). O(k) via the per-region
        free counts — no occupancy rescans on the insert hot path."""
        for r in range(self._regions - 1, -1, -1):
            if self._free[r] > 0:
                return r
        return None

    def _free_slots(self, region: int) -> np.ndarray:
        """Sorted absolute slot ids of ``region``'s free slots, from the
        incremental cache (scanned at most once per region between bulk
        re-layouts; kept exact by ``_cache_fill`` / ``_cache_freed``)."""
        a = self._free_cache[region]
        if a is None:
            lo = region * self._spr
            a = lo + np.flatnonzero(~self.slot_valid[lo : lo + self._spr])
            self._free_cache[region] = a
        return a

    def _cache_fill(self, slot: int) -> None:
        a = self._free_cache[slot // self._spr]
        if a is not None:
            self._free_cache[slot // self._spr] = a[a != slot]

    def _cache_freed(self, slot: int) -> None:
        r = slot // self._spr
        a = self._free_cache[r]
        if a is not None:
            self._free_cache[r] = np.insert(a, int(np.searchsorted(a, slot)), slot)

    def _free_in(self, region: int, near: Optional[int] = None) -> Optional[int]:
        """Candidate-slot scoring over the cached free list: nearest free slot
        to ``near`` by |slot − near|, first-of-ties (identical decision to the
        historical per-insert occupancy rescan, minus the rescan)."""
        free = self._free_slots(region)
        if free.size == 0:
            return None
        if near is None:
            return int(free[0])
        return int(free[np.argmin(np.abs(free - near))])

    def _any_free_slot(self, near: Optional[int]) -> Optional[int]:
        free = np.concatenate([self._free_slots(r) for r in range(self._regions)])
        if free.size == 0:
            return None
        if near is None:
            return int(free[0])
        return int(free[np.argmin(np.abs(free - near))])

    # ------------------------------------------------------------ device ops
    def drain_ops(self) -> tuple[list[SlotOp], dict[int, int]]:
        """(slot mutations, per-vertex degree deltas) since the last drain.
        Slot ops are coalesced (last write per slot wins — safe because degree
        deltas are accumulated separately, so a delete+reinsert into the same
        slot still nets the right degrees). Meaningless after a re-layout —
        check ``needs_resync`` first."""
        ops = list(self._ops.values())
        deg = dict(self._deg_delta)
        self._ops.clear()
        self._deg_delta.clear()
        return ops, deg

    # --------------------------------------------------- checkpoint plumbing
    def drain_dirty_regions(self) -> list[int]:
        """Sorted region ids whose slot ranges changed since the last drain
        (inserts, deletes, span rewrites; a re-layout marks ALL regions).
        Consumed by the incremental checkpoint: snapshot cost is proportional
        to the drained set, not the slot-array size."""
        dirty = sorted(self._dirty_regions)
        self._dirty_regions.clear()
        return dirty

    def drain_recovery_ops(self) -> list[tuple[int, int, int, bool]]:
        """Coalesced ``(slot, u, v, valid)`` writes since the last drain, for
        the checkpoint WAL. Independent of ``drain_ops`` (the device-mirror
        stream): always on, and it DOES capture ``emit_ops=False`` span
        rewrites, so replaying a WAL tail onto a snapshot reproduces the slot
        array bit-exactly without re-running any placement or repair logic.
        Meaningless across a re-layout — the checkpoint layer snapshots
        instead (``layout_epoch``)."""
        ops = [(s, uvw[0], uvw[1], uvw[2]) for s, uvw in self._rec_ops.items()]
        ops.sort()
        self._rec_ops.clear()
        return ops

    @classmethod
    def from_slots(
        cls,
        slot_src: np.ndarray,
        slot_dst: np.ndarray,
        slot_valid: np.ndarray,
        num_vertices: int,
        *,
        regions: int,
        config: StreamConfig = StreamConfig(),
        baseline_kappa: Optional[float] = None,
        cooldown: int = 0,
    ) -> "IncrementalOrderer":
        """Reconstruct an orderer from a raw slot triple, preserving gaps and
        tombstone positions EXACTLY (``__init__`` would re-spread the edges
        and lose the layout). This is the checkpoint-restore path: all derived
        bookkeeping (edge→slot map, incident sets, region counters, free
        lists) is rebuilt from the arrays, and ``baseline_kappa`` /
        ``cooldown`` re-inject the monitor control state so post-restore
        escalation decisions replay identically to the pre-failure timeline."""
        slot_src = np.array(slot_src, dtype=np.int64)
        slot_dst = np.array(slot_dst, dtype=np.int64)
        slot_valid = np.array(slot_valid, dtype=bool)
        regions = int(regions)
        if regions < 1:
            raise ValueError("regions must be >= 1")
        if slot_src.shape != slot_dst.shape or slot_src.shape != slot_valid.shape:
            raise ValueError("slot arrays must share one shape")
        if slot_src.ndim != 1 or slot_src.size % regions != 0:
            raise ValueError(
                f"slot capacity {slot_src.size} is not a multiple of regions={regions}"
            )
        o = cls.__new__(cls)
        o.num_vertices = int(num_vertices)
        o.config = config
        o.needs_resync = False
        o._cooldown = int(cooldown)
        o._ops = {}
        o._deg_delta = {}
        o._rebuild_delta = None
        o._regions = regions
        o._spr = slot_src.size // regions
        o.layout_epoch = 0
        o._dirty_regions = set(range(regions))  # conservative: first snapshot is full
        o._rec_ops = {}
        o.slot_src = slot_src
        o.slot_dst = slot_dst
        o.slot_valid = slot_valid
        occ = np.flatnonzero(slot_valid)
        src_o = slot_src[occ]
        dst_o = slot_dst[occ]
        o._edge2slot = dict(zip(zip(src_o.tolist(), dst_o.tolist()), occ.tolist()))
        if len(o._edge2slot) != occ.size:
            raise ValueError("slot arrays hold duplicate edges")
        p = occ // o._spr
        o._rc = [dict() for _ in range(regions)]
        o._rebuild_region_counts(0, regions, p, src_o, dst_o)
        o._free = np.full(regions, o._spr, dtype=np.int64)
        o._free -= np.bincount(p, minlength=regions)
        o._free_cache = [None] * regions
        o._gather_from = None
        idx, ws, starts, ends = cls._vertex_groups(np.concatenate([src_o, dst_o]))
        sslots = np.concatenate([occ, occ])[idx].tolist()
        o._incident = {w: set(sslots[a:b]) for w, a, b in zip(ws, starts, ends)}
        if baseline_kappa is None:
            o._set_baseline()
        else:
            o._baseline_kappa = float(baseline_kappa)
        return o

    def drain_gather_map(self) -> np.ndarray:
        """(capacity,) int64: for each slot of the CURRENT layout, the slot of
        the previous layout it was filled from (-1 = empty). Only ``relayout``
        (the rescale path) produces one — the on-device compact program turns
        it into a single gather; grow / full_rebuild resync instead."""
        if self._gather_from is None:
            raise ValueError("no gather map: only relayout() produces one")
        gm, self._gather_from = self._gather_from, None
        return gm

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """The flat ordered (src, dst) lists — occupied slots in slot order."""
        vs = self.slot_valid
        return self.slot_src[vs].copy(), self.slot_dst[vs].copy()

    def graph(self) -> Graph:
        src, dst = self.snapshot()
        return Graph.from_edges(np.stack([src, dst], axis=1), self.num_vertices)

    def rf(self, k: int) -> float:
        """Replication factor of CEP chunks over the current incremental order."""
        src, dst = self.snapshot()
        return metrics.replication_factor_ordered(src, dst, k, self.num_vertices)

    def rf_vs_oracle(self, k: int, seed: int = 0) -> tuple[float, float]:
        """(incremental RF, full geo_order re-run RF) at k — the margin the
        incremental order must stay within (config.rf_margin)."""
        g = self.graph()
        order = ordering.geo_order(g, self.config.k_min, self.config.k_max, seed=seed)
        oracle = metrics.replication_factor_ordered(
            g.src[order], g.dst[order], k, self.num_vertices
        )
        return self.rf(k), oracle

    # ------------------------------------------------------------ escalation
    def escalation(
        self, full_lookahead: float = 0.0, partial_shadow: float = 0.0
    ) -> str:
        """The ladder DECISION only — 'none' | 'partial' | 'full' — so callers
        owning a device mirror (``ingest.StreamingEngine``) can execute the
        partial rung on the device instead of the host ``geo_order`` path.
        Thresholds are strict: drift exactly at a threshold does not fire.

        ``full_lookahead`` anticipates an asynchronous full rung: the caller
        adds its projected drift growth over the rebuild's flight window, so
        the dispatch fires early enough that the COMMIT lands at roughly the
        drift a synchronous rebuild would have repaired at. Zero (the
        default) keeps the classic instant-repair decision; the partial
        threshold never anticipates (that rung repairs synchronously).

        ``partial_shadow`` suppresses the partial rung when a full rebuild is
        projected within that drift horizon (caller-chosen, typically a
        couple of flight windows of growth): repeated span repairs on the
        same drifted layout plateau after the first pass, so a partial fired
        just before a whole-graph re-order buys nothing the imminent commit
        will not erase — the decision reports 'none' instead."""
        d = self.drift()
        if d + full_lookahead > self.config.full_drift:
            return "full"
        if d > self.config.partial_drift:
            if partial_shadow > 0.0 and d + partial_shadow > self.config.full_drift:
                return "none"
            return "partial"
        return "none"

    def maybe_escalate(
        self,
        partial_fn=None,
        full_fn=None,
        full_lookahead: float = 0.0,
        partial_shadow: float = 0.0,
    ) -> str:
        """Quality-monitor step: 'none' | 'partial' | 'full' (what ran).

        ``partial_fn`` delegates the partial rung (the streaming engine passes
        its on-device span repair; host-only replays pass the numpy mirror);
        None keeps the host ``geo_order`` span repair. ``full_fn`` delegates
        the full rung the same way — the streaming engine passes its async
        dispatch so the rebuild runs against a snapshot while ingest
        continues; None keeps the synchronous ``full_rebuild``. A fired
        partial starts a ``config.partial_cooldown``-step hysteresis window
        during which further partial triggers report 'none' (a just-repaired
        layout needs fresh updates before repairing again pays for itself);
        the full rung ignores the window and resets it. ``full_lookahead``
        and ``partial_shadow`` pass through to ``escalation()`` (async
        dispatch anticipation / partial-rung shadow suppression)."""
        rung = self.escalation(full_lookahead, partial_shadow)
        if rung == "full":
            if full_fn is None:
                self.full_rebuild()
            else:
                full_fn()
            self._cooldown = 0
        elif rung == "partial":
            if self._cooldown > 0:
                self._cooldown -= 1
                return "none"
            self._cooldown = self.config.partial_cooldown
            if partial_fn is None:
                self.partial_reorder()
            else:
                partial_fn()
        return rung

    def worst_region(self) -> int:
        """Region with the highest vertex count per occupied slot — the most
        locality-degraded span start."""
        scores = []
        for r in range(self._regions):
            lo = r * self._spr
            fill = int(self.slot_valid[lo : lo + self._spr].sum())
            scores.append(len(self._rc[r]) / max(1, fill))
        return int(np.argmax(scores))

    def span_bounds(self, region: Optional[int] = None) -> tuple[int, int]:
        """[r0, r1) region range of the repair span anchored at ``region``
        (default: the worst region), ``config.span_regions`` wide, clamped."""
        w = self.worst_region() if region is None else int(region)
        span = self.config.span_regions
        r0 = max(0, min(w, self._regions - span))
        r1 = min(self._regions, r0 + span)
        return r0, r1

    def span_arrays(self, r0: int, r1: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Copies of the span's (slot_src, slot_dst, slot_valid) slices —
        the host view of what the device span-repair program reads from the
        sharded pack_slots buffers (bit-identical by the mirror contract)."""
        lo, hi = r0 * self._spr, r1 * self._spr
        return (
            self.slot_src[lo:hi].copy(),
            self.slot_dst[lo:hi].copy(),
            self.slot_valid[lo:hi].copy(),
        )

    def geo_span_candidate(
        self, u: np.ndarray, v: np.ndarray, valid: np.ndarray, seed: int = 0
    ) -> np.ndarray:
        """Host ``geo_order`` of the span's live edges as a live-first slot
        permutation — the span repair's quality ORACLE. The production device
        rung never computes this; oracle / differential modes feed it to the
        repair program as the candidate order."""
        from ..kernels import span_reorder as SRK

        live = np.flatnonzero(valid)
        if live.size < 2:
            return SRK.identity_candidate(valid)
        sub = Graph.from_edges(
            np.stack([u[live], v[live]], axis=1), self.num_vertices
        )
        sub_order = ordering.geo_order(sub, self.config.k_min, self.config.k_max, seed=seed)
        # Map canonical sub edges back to span positions (slots hold unique
        # canonical u < v pairs, so the mapping is a bijection).
        pos = {
            (int(a), int(b)): int(s_)
            for s_, a, b in zip(live.tolist(), u[live].tolist(), v[live].tolist())
        }
        cand_live = np.asarray(
            [pos[(int(a), int(b))] for a, b in zip(sub.src[sub_order], sub.dst[sub_order])],
            dtype=np.int64,
        )
        return np.concatenate([cand_live, np.flatnonzero(~np.asarray(valid, bool))])

    def apply_span_order(
        self, r0: int, r1: int, order: np.ndarray, *, emit_ops: bool = True
    ) -> int:
        """Commit a live-first span permutation: splice the re-ordered edges
        back over regions [r0, r1) (CEP chunks spread evenly — the exact
        layout the device splice computes) and update all bookkeeping, so the
        drift monitor needs no device readback. ``emit_ops=False`` is the
        device-rung path: the repair program already rewrote the device rows, so
        no slot ops must travel. Returns the number of edges re-ordered."""
        lo, hi = r0 * self._spr, r1 * self._spr
        u = self.slot_src[lo:hi].copy()
        v = self.slot_dst[lo:hi].copy()
        valid = self.slot_valid[lo:hi].copy()
        n = int(valid.sum())
        order = np.asarray(order, dtype=np.int64)
        new_src = u[order[:n]]
        new_dst = v[order[:n]]
        self._rewrite_span(r0, r1, new_src, new_dst)
        if emit_ops:
            for s_ in range(lo, hi):
                self._ops[s_] = SlotOp(
                    s_, int(self.slot_src[s_]), int(self.slot_dst[s_]), bool(self.slot_valid[s_])
                )
        return n

    def partial_reorder(self, region: Optional[int] = None) -> int:
        """Bounded re-order of only the degraded span: GEO on the subgraph
        induced by ``span_regions`` consecutive regions' edges, spliced back
        into the same slots. Returns the number of edges re-ordered. The
        rewrite is emitted as ordinary slot ops (one op per span slot), so the
        device mirror follows with the same scatter program ingest uses — no
        full re-upload; degrees are untouched (a re-order never changes the
        graph). This is the HOST rung — the streaming engine's default runs
        the repair on the device instead (``partial_reorder_mirror`` + the span
        program of kernels/span_reorder.py)."""
        r0, r1 = self.span_bounds(region)
        u, v, valid = self.span_arrays(r0, r1)
        if int(valid.sum()) < 2:
            return 0
        cand = self.geo_span_candidate(u, v, valid)
        return self.apply_span_order(r0, r1, cand)

    def partial_reorder_mirror(
        self,
        region: Optional[int] = None,
        *,
        candidate: Optional[np.ndarray] = None,
        emit_ops: bool = True,
    ) -> tuple[int, bool]:
        """Partial rung via the numpy mirror of the DEVICE span repair
        (kernels/span_reorder.py): neighbor-expansion order vs ``candidate``
        (default: the current layout), better of the two by the exact span
        objective. Returns (edges re-ordered, chose_candidate). Byte-identical
        to what the device program writes — the differential-oracle
        contract."""
        from ..kernels import span_reorder as SRK

        r0, r1 = self.span_bounds(region)
        u, v, valid = self.span_arrays(r0, r1)
        if int(valid.sum()) < 2:
            return 0, False
        if candidate is None:
            candidate = SRK.identity_candidate(valid)
        ks = SRK.eval_ks(self.config.k_min, self.config.k_max)
        order, chose = SRK.select_span_order_host(
            u, v, valid, self.num_vertices, candidate, ks
        )
        n = self.apply_span_order(r0, r1, order, emit_ops=emit_ops)
        return n, chose

    def _rewrite_span(self, r0: int, r1: int, src_o: np.ndarray, dst_o: np.ndarray) -> None:
        """Rewrite regions [r0, r1) with the span order (CEP chunks spread
        evenly). Bookkeeping is vectorized on the partial-rung hot path: a
        re-order rewrites the SAME edge multiset, so ``_edge2slot`` needs only
        value updates (one C-level dict.update), region counters rebuild from
        per-chunk ``np.unique``, and incident sets swap old↔new slots in
        per-vertex bulk ops — this host pass rides along every device span
        repair, so it must not cost what the repair saves."""
        spr = self._spr
        lo, hi = r0 * spr, r1 * spr
        src_o = np.asarray(src_o, dtype=np.int64)
        dst_o = np.asarray(dst_o, dtype=np.int64)
        e = int(src_o.shape[0])
        old_rel = np.flatnonzero(self.slot_valid[lo:hi])
        old_slots = lo + old_rel
        old_u = self.slot_src[old_slots].copy()
        old_v = self.slot_dst[old_slots].copy()
        same_edges = e == old_slots.size and np.array_equal(
            np.sort(old_u * self.num_vertices + old_v),
            np.sort(src_o * self.num_vertices + dst_o),
        )
        if not same_edges:
            # General path (never hit by re-orders): old edges leave the maps.
            for s_, a, b in zip(old_slots.tolist(), old_u.tolist(), old_v.tolist()):
                del self._edge2slot[(a, b)]
                for w in (a, b):
                    inc = self._incident.get(w)
                    if inc is not None:
                        inc.discard(s_)
                        if not inc:
                            del self._incident[w]
        self.slot_valid[lo:hi] = False
        self.slot_src[lo:hi] = 0
        self.slot_dst[lo:hi] = 0
        self._free[r0:r1] = spr
        for r in range(r0, r1):  # bulk rewrite: rescan these regions lazily
            self._free_cache[r] = None
        # Re-fill: CEP chunks of the span order over the span regions, slot
        # targets computed in one closed-form vector pass (the exact layout
        # kernels/span_reorder.splice_targets_device writes on the device).
        regions = r1 - r0
        if e:
            j = np.arange(e, dtype=np.int64)
            p = np.asarray(cep.id2p(e, regions, j), dtype=np.int64)
            bounds = np.asarray(cep.chunk_bounds(e, regions), dtype=np.int64)
            n_p = bounds[p + 1] - bounds[p]
            cols = ((j - bounds[p]) * spr) // n_p
            slots = (r0 + p) * spr + cols
            self.slot_src[slots] = src_o
            self.slot_dst[slots] = dst_o
            self.slot_valid[slots] = True
            self._free[r0:r1] -= np.bincount(p, minlength=regions)
            self._edge2slot.update(
                zip(zip(src_o.tolist(), dst_o.tolist()), slots.tolist())
            )
        else:
            p = np.zeros(0, dtype=np.int64)
            slots = np.zeros(0, dtype=np.int64)
        self._rebuild_region_counts(r0, regions, p, src_o, dst_o)
        # Incident sets: swap each affected vertex's old span slots for its
        # new ones in one difference/update pair per vertex.
        if same_edges:
            # Align old and new slots per EDGE: both keyed by (u, v); the
            # edge multiset is identical, so sorting by edge key pairs them.
            old_key = np.argsort(old_u * self.num_vertices + old_v, kind="stable")
            new_key = np.argsort(src_o * self.num_vertices + dst_o, kind="stable")
            edge_new_slot = np.empty(e, dtype=np.int64)
            edge_new_slot[old_key] = slots[new_key]
            idx, ws, starts, ends = self._vertex_groups(np.concatenate([old_u, old_v]))
            # python-list slicing beats np.split's per-group view construction
            olds_l = np.concatenate([old_slots, old_slots])[idx].tolist()
            news_l = np.concatenate([edge_new_slot, edge_new_slot])[idx].tolist()
            for w, g0, g1 in zip(ws, starts, ends):
                inc = self._incident[w]
                inc.difference_update(olds_l[g0:g1])
                inc.update(news_l[g0:g1])
        else:
            for s_, a, b in zip(slots.tolist(), src_o.tolist(), dst_o.tolist()):
                self._incident.setdefault(a, set()).add(s_)
                self._incident.setdefault(b, set()).add(s_)
        self._dirty_regions.update(range(r0, r1))
        # Recovery ops: the span rewrite touched every slot of [lo, hi), and
        # the device rung's emit_ops=False path bypasses ``_ops`` entirely —
        # the checkpoint WAL must still see the writes (post-rewrite content).
        self._rec_ops.update(
            zip(
                range(lo, hi),
                zip(
                    self.slot_src[lo:hi].tolist(),
                    self.slot_dst[lo:hi].tolist(),
                    self.slot_valid[lo:hi].tolist(),
                ),
            )
        )

    def full_rebuild(self, seed: int = 0) -> None:
        """Escalation terminal: re-run geo_order on the current graph and
        re-layout every slot. Sets ``needs_resync``."""
        g = self.graph()
        order = ordering.geo_order(g, self.config.k_min, self.config.k_max, seed=seed)
        self._layout(g.src[order].astype(np.int64), g.dst[order].astype(np.int64), self._regions)
        self._finish_relayout()
        self._set_baseline()  # a fresh GEO order IS the new quality yardstick

    # -------------------------------------------------- async full rebuild
    @property
    def rebuild_in_flight(self) -> bool:
        return self._rebuild_delta is not None

    @property
    def rebuild_delta_batches(self) -> int:
        """Batches queued for replay by the in-flight rebuild (0 if none)."""
        return len(self._rebuild_delta) if self._rebuild_delta is not None else 0

    def begin_full_rebuild(self) -> tuple[np.ndarray, np.ndarray]:
        """Start the double-buffered rebuild protocol (DESIGN.md §11): return
        the ordered snapshot the rebuild will re-order, and start queuing
        every subsequently applied batch for the commit's replay. The live
        slot array keeps serving ingest untouched. The caller (the streaming
        engine) must be device-synced — pending slot ops are NOT snapshotted."""
        if self._rebuild_delta is not None:
            raise ValueError("a full rebuild is already in flight")
        self._rebuild_delta = []
        return self.snapshot()

    def abort_full_rebuild(self) -> int:
        """Drop the in-flight rebuild (re-layout / rescale invalidated its
        snapshot). Returns the number of queued batches discarded; drift
        stays as-is, so the ladder simply re-fires later."""
        n = self.rebuild_delta_batches
        self._rebuild_delta = None
        return n

    def commit_full_rebuild(self, cand_src: np.ndarray, cand_dst: np.ndarray) -> bool:
        """Commit an async rebuild: re-layout to the candidate order of the
        SNAPSHOT (``begin_full_rebuild``'s edge list, re-ordered), replay the
        batches queued during the flight, and re-baseline the drift monitor.

        Returns True when the commit kept the slot-array shape: the slot ops
        accumulated by the replay then describe EXACTLY the delta between the
        candidate layout and the committed state — the engine drains them into
        the device splice program, so the device never re-uploads. Returns
        False when the layout width changed underneath (the candidate chunks
        outgrew ``slots_per_region``, or a replayed insert forced ``grow``):
        the caller must resync (``needs_resync`` is set).

        The caller must be device-synced before calling (the engine's monitor
        is): pending ops are dropped, and the replay's degree deltas are
        discarded because the flight's ingests already applied them to the
        live device degrees — a re-order never changes the graph."""
        if self._rebuild_delta is None:
            raise ValueError("no full rebuild in flight")
        delta, self._rebuild_delta = self._rebuild_delta, None
        spr_before = self._spr
        self._ops.clear()
        self._deg_delta.clear()
        self._layout(
            np.asarray(cand_src, dtype=np.int64),
            np.asarray(cand_dst, dtype=np.int64),
            self._regions,
        )
        shape_kept = self._spr == spr_before
        for batch in delta:
            self.apply(batch)  # may grow() → needs_resync, handled below
        self._deg_delta.clear()  # flight ingests already applied these
        self._set_baseline()  # rebuilt + replayed = the new quality yardstick
        if not shape_kept or self.needs_resync:
            self._ops.clear()
            self.needs_resync = True
            return False
        return True

    def relayout(self, regions: int) -> None:
        """Re-slice the CURRENT incremental order into ``regions`` regions
        (rescale k→k' under ingest: order unchanged, slots re-chunked). Sets
        ``needs_resync``; ``drain_gather_map`` feeds the on-device compact."""
        d = self.drift()  # Σ|V_p| scales with the region count, so carry the
        src_o, dst_o = self.snapshot()  # drift VALUE across the k change
        old_valid = self.slot_valid.copy()
        self._layout(src_o, dst_o, int(regions))
        # Both layouts hold the same order in slot order (snapshot reads the
        # occupied slots ascending, _layout spreads them ascending), so the
        # i-th occupied new slot is filled from the i-th occupied old slot.
        gm = np.full(self.capacity, -1, dtype=np.int64)
        gm[np.flatnonzero(self.slot_valid)] = np.flatnonzero(old_valid)
        self._gather_from = gm
        self._finish_relayout()
        self._baseline_kappa = self._kappa() / max(d, 1e-12)

    def grow(self, factor: float = 2.0) -> None:
        """Enlarge slots_per_region (same region count, same order, bigger
        gaps) when the array runs out of free slots. Sets ``needs_resync``."""
        d = self.drift()
        src_o, dst_o = self.snapshot()
        spr = max(self._spr + 1, int(np.ceil(self._spr * factor)))
        self._layout(src_o, dst_o, self._regions, spr=spr)
        self._finish_relayout()
        self._baseline_kappa = self._kappa() / max(d, 1e-12)

    def _finish_relayout(self) -> None:
        self._ops.clear()
        self._deg_delta.clear()
        self.needs_resync = True
