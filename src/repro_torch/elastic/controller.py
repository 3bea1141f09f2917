"""Elastic-cluster controller: heartbeats, preemption, stragglers, rescale.

Host processes (real or simulated) report heartbeats with step progress; the
controller detects dead hosts (missed beats) and stragglers (progress lag),
and emits ScaleEvents whose migration plans come from CEP — so reacting to a
spot-instance preemption costs an O(k) plan + Thm.-2-minimal data movement,
which is exactly the paper's motivating scenario (§1).

With a streaming engine attached (``attach_stream``) the controller also
accepts graph updates: ``ingest`` applies an EdgeUpdateBatch on the device and
runs the quality monitor, whose escalation ladder is ingest → partial
re-order → full GEO repartition (DESIGN.md §9). Every event — scale, ingest,
or rebuild — carries a monotonic ``seq`` from one shared counter, so
interleaved logs have a total order regardless of wall-clock resolution.

Decision vs dispatch (DESIGN.md §11): membership changes (``add_hosts``,
``poll``) first produce a ``ScaleDecision`` — the pure what-should-happen —
and ``_execute`` then dispatches it against whatever engine is attached.
Asynchronous work follows the same discipline one layer down: the engine's
full-rebuild rung dispatches against shadow buffers and the controller drains
the COMPLETED records (``drain_rebuild_events``) into ``RebuildEvent``s whose
``seq`` is assigned at completion-commit time — an in-flight rebuild has no
place in the total order until it commits (or aborts).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..core import cep
from ..obs import metrics as OM
from ..obs import trace as OT


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    step: int
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """The DECISION half of a membership change — what should happen, before
    any engine is touched. ``_execute`` turns one into a ScaleEvent."""

    kind: str  # "scale_in" | "scale_out" | "straggler"
    k_old: int
    k_new: int
    lost_hosts: tuple
    reason: str


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    kind: str  # "scale_in" | "scale_out" | "straggler"
    k_old: int
    k_new: int
    lost_hosts: tuple
    plan_edges_moved_frac: float
    reason: str
    executed: bool = False  # True when an attached engine was migrated on-device
    cross_device_bytes: int = 0  # executed rank-to-rank traffic (runs over a group)
    cross_process_bytes: int = 0  # subset crossing process boundaries — the
    # network bill of a multi-process run (launch/multihost.py)
    seq: int = -1  # monotonic event sequence, shared with IngestEvents
    program_cache: dict = dataclasses.field(default_factory=dict)
    # per-kind {hits, misses, evictions} of the engine's program cache at
    # emit time (``StreamingEngine.program_cache_counters()``, unchanged)


@dataclasses.dataclass(frozen=True)
class IngestEvent:
    kind: str  # always "ingest" (mirrors ScaleEvent.kind for shared logs)
    inserted: int
    deleted: int
    skipped: int
    escalation: str  # "none" | "partial" | "full" — monitor's ladder step
    num_edges: int  # live edges after the batch
    elapsed_s: float  # host placement + device ingest (excludes the monitor)
    monitor_s: float = 0.0  # quality monitor + any escalation it ran
    seq: int = -1
    repair: str = ""  # what the rung executed: "device" | "host" | "oracle" |
    # "differential" | "resync" | "skipped" | "" (none) | "dispatch" | "geo"
    rung_count: int = 0  # cumulative firings of THIS event's rung (incl. it)
    rung_total_s: float = 0.0  # cumulative seconds spent in this rung so far
    # --- async full-rebuild overlap accounting (DESIGN.md §11) ---
    rebuild_state: str = ""  # ""/"dispatch"/"flight"/"commit"/"abort"
    rebuild_s: float = 0.0  # rebuild work inside THIS batch's monitor call
    rebuilds_in_flight: int = 0  # rebuilds still in flight after the batch
    program_cache: dict = dataclasses.field(default_factory=dict)
    # Spill-layer traffic (stream/spill.py) — empty for streams without one.
    spill: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """An UNPLANNED membership loss (preemption, crash) detected by the
    liveness layer (launch.multihost.LeaseBoard or heartbeat expiry) and
    reported through ``report_failure``. Sequenced on the shared monotonic
    counter immediately BEFORE the scale-in event that re-plans k over the
    survivors — detection precedes the plan in the total order, exactly the
    order the system learned about it. Restore accounting (Thm-2-style: the
    recovery bill is the lost partitions' chunk bytes + the WAL tail, not
    graph size) rides on the event when the caller ran a restore."""

    kind: str  # always "failure"
    lost_hosts: tuple
    k_old: int
    k_new: int  # the re-plan over survivors (k_min floor applied)
    detect_s: float  # lease-expiry detection latency (0 when not measured)
    reason: str
    restored_bytes: int = 0  # checkpoint chunk + WAL-tail bytes the restore read
    restore_s: float = 0.0
    replayed_records: int = 0  # WAL tail length replayed onto the snapshot
    seq: int = -1


@dataclasses.dataclass(frozen=True)
class RebuildEvent:
    """A COMPLETED async full rebuild (committed or aborted). Emitted when
    the controller drains the engine's rebuild log, so ``seq`` is assigned at
    completion-commit time — in-flight work has no place in the total order.
    Appears in ``events`` immediately before the IngestEvent of the batch
    whose monitor call completed it."""

    kind: str  # always "full_rebuild"
    mode: str  # "geo" | "device" | "differential"
    committed: bool  # False on abort or resync fallback
    aborted: bool  # True when a re-layout voided the snapshot
    snapshot_edges: int  # live edges the dispatched program re-ordered
    replayed_batches: int  # delta batches replayed onto the new order
    splice_ops: int  # slot ops the commit splice scattered
    flight_batches: int  # batches between dispatch and completion
    dispatch_s: float  # host candidate compute + program dispatch (async)
    commit_s: float  # commit: re-layout + replay + splice, blocked
    seq: int = -1


class ElasticController:
    def __init__(
        self,
        num_hosts: int,
        *,
        dead_after_s: float = 10.0,
        straggler_lag_steps: int = 50,
        state_elements: int = 1_000_000,
        clock: Callable[[], float] = time.monotonic,
        rescaler=None,
        k_min: int = 1,
        tracer=None,
        metrics_registry=None,
    ):
        if k_min < 1:
            raise ValueError("k_min must be >= 1: a plan to zero partitions is not a rescale")
        self.clock = clock
        self.dead_after_s = dead_after_s
        self.straggler_lag_steps = straggler_lag_steps
        self.state_elements = state_elements
        # Eviction floor: poll() never drives k below this, however many
        # hosts went dark in one poll — a scale plan to zero partitions has
        # no executable meaning (and would zero the pack an attached engine
        # holds). Autoscale policies carry their own (>= this) k_min.
        self.k_min = int(k_min)
        now = self.clock()
        self.hosts = {h: HostState(h, now, 0) for h in range(num_hosts)}
        self.events: list = []  # ScaleEvents + IngestEvents, ordered by seq
        self._rescaler = rescaler
        self._seq = 0  # one counter for all event kinds
        self.engine_data = None  # packed EngineData migrated on scale events
        self.stream = None  # StreamingEngine: scale events + ingest run on it
        self.autoscaler = None  # AutoscalePolicy consulted by autoscale()
        self._backlog = 0  # externally-reported work backlog (serve queue)
        self.rescale_stats: list = []
        # Observability (obs/, DESIGN.md §13): the event wall histogram and
        # the queue-depth / events-per-second gauges are the signals the
        # ROADMAP's traffic-driven autoscaler will consume.
        self._tracer = tracer
        self.metrics = OM.NULL if metrics_registry is None else metrics_registry
        self._m_wall = self.metrics.histogram("controller.batch_wall_s")
        self._m_queue = self.metrics.gauge("controller.queue_depth")
        self._m_rate = self.metrics.gauge("controller.events_per_s")
        self._m_ingests = self.metrics.counter("controller.ingest_events")
        self._m_scales = self.metrics.counter("controller.scale_events")
        self._m_failures = self.metrics.counter("controller.failure_events")
        self._last_event_t: Optional[float] = None
        self.checkpoint = None  # SlotCheckpoint making ingested batches durable
        self._batch_step = -1  # durable batch index the checkpoint records under

    @property
    def tracer(self):
        return self._tracer if self._tracer is not None else OT.get_tracer()

    def _mark_event(self) -> None:
        """Update the events/s gauge: an EMA of the inter-event rate (the
        smoothing keeps a bursty stream from whipsawing the autoscaler
        signal; 0 until two events exist). Reads the INJECTED clock — the
        same one heartbeat/poll liveness runs on — so a fake clock drives
        the gauge deterministically in tests and the serve loop's virtual
        timeline feeds the autoscaler consistently."""
        now = self.clock()
        if self._last_event_t is not None:
            dt = now - self._last_event_t
            if dt > 0:
                prev = self._m_rate.value
                rate = 1.0 / dt
                self._m_rate.set(rate if prev == 0.0 else 0.8 * prev + 0.2 * rate)
        self._last_event_t = now

    def events_jsonl(self, *, drop_timings: bool = False) -> str:
        """The full event log (shared ``seq`` order) as JSONL — see
        obs/log.py; ``drop_timings`` zeroes wall-clock fields so logs from
        deterministic replica processes diff byte-identical."""
        from ..obs import log as OL

        return OL.events_jsonl(self.events, drop_timings=drop_timings)

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    @property
    def k(self) -> int:
        return sum(1 for h in self.hosts.values() if h.alive)

    def heartbeat(self, host_id: int, step: int) -> None:
        h = self.hosts[host_id]
        h.last_beat = self.clock()
        h.step = max(h.step, step)

    def add_hosts(self, n: int) -> ScaleEvent:
        k_old = self.k
        base = max(self.hosts) + 1 if self.hosts else 0
        now = self.clock()
        for i in range(n):
            self.hosts[base + i] = HostState(base + i, now, 0)
        return self._emit("scale_out", k_old, self.k, (), f"+{n} provisioned hosts")

    def _clamp_eviction(self, evict: list) -> tuple[list, str]:
        """Apply the ``k_min`` floor to an eviction list: retain the
        most-recently-heard-from candidates so the survivors are the best
        liveness bets. Returns (evictable hosts, clamp note for the event
        reason — empty when the floor never engaged)."""
        survivors = self.k - len(evict)
        if survivors >= self.k_min:
            return evict, ""
        keep = self.k_min - survivors
        # Stalest-first, so the retained tail is the most recently beating.
        ranked = sorted(evict, key=lambda hid: (self.hosts[hid].last_beat, hid))
        retained = sorted(ranked[len(ranked) - keep :])
        return ranked[: len(ranked) - keep], (
            f" (clamped at k_min={self.k_min}: retained hosts {retained})"
        )

    def poll(self) -> Optional[ScaleEvent]:
        """Detect failures/stragglers; emit at most one event per poll.
        Eviction never drives k below ``k_min``: when every host went dark
        in one window, the most-recently-beating hosts stay in the working
        set (surfaced in the event reason) rather than emitting a scale
        plan to zero partitions."""
        now = self.clock()
        dead = [h.host_id for h in self.hosts.values() if h.alive and now - h.last_beat > self.dead_after_s]
        if dead:
            dead, clamp = self._clamp_eviction(dead)
            if not dead:
                return None  # the floor retained every candidate: no event
            k_old = self.k
            for hid in dead:
                self.hosts[hid].alive = False
            return self._emit(
                "scale_in", k_old, self.k, tuple(dead),
                f"hosts {dead} missed heartbeats{clamp}",
            )
        alive = [h for h in self.hosts.values() if h.alive]
        if len(alive) >= 2:
            max_step = max(h.step for h in alive)
            lag = [h.host_id for h in alive if max_step - h.step > self.straggler_lag_steps]
            if lag:
                # Straggler mitigation = evict + rescale (chunk boundaries shift
                # away from the slow host; its chunk is Thm.-2-cheap to move).
                lag, clamp = self._clamp_eviction(lag)
                if not lag:
                    return None
                k_old = self.k
                for hid in lag:
                    self.hosts[hid].alive = False
                return self._emit(
                    "straggler", k_old, self.k, tuple(lag),
                    f"hosts {lag} lag >{self.straggler_lag_steps} steps{clamp}",
                )
        return None

    def attach_engine(self, data, group=None) -> None:
        """Attach packed graph-engine state (``engine.pack_ordered`` layout).

        With an engine attached, every rescale decision is *executed*: the
        emitted event carries ``executed=True`` and ``self.engine_data`` is
        replaced by the migrated k_new engine data (stats appended to
        ``self.rescale_stats``) — not just a plan.

        Passing ``group`` (a ``launch.mesh.GraphGroup``, the graph axis)
        lays the pack out over its ranks first (``shard_engine_data``), so
        every subsequent scale event is executed as a migration between the
        ranks and reports the rank-to-rank traffic it actually generated
        (``ScaleEvent.cross_device_bytes``). A ``ShardedEngineData`` may also
        be attached directly.
        """
        if group is not None:
            from ..graphs import engine as graph_engine

            if not isinstance(data, graph_engine.ShardedEngineData):
                data = graph_engine.shard_engine_data(data, group)
        self.engine_data = data

    def attach_stream(self, stream) -> None:
        """Attach a live ``stream.ingest.StreamingEngine``.

        Scale events then execute as on-device compactions of the streaming
        pack (``StreamingEngine.rescale``) and ``ingest`` becomes available.
        Takes precedence over ``attach_engine`` state: a streaming graph's
        pack has gaps, which the range-copy rescaler correctly rejects.
        """
        self.stream = stream

    def attach_autoscaler(self, policy) -> None:
        """Attach an ``elastic.autoscale.AutoscalePolicy``: ``autoscale()``
        then closes the traffic→k loop, reading the metrics registry this
        controller publishes to and executing the policy's decisions through
        the same ``_execute`` path membership changes use."""
        if policy.config.k_min < self.k_min:
            raise ValueError(
                f"policy k_min={policy.config.k_min} below the controller's "
                f"eviction floor k_min={self.k_min}"
            )
        self.autoscaler = policy

    def attach_checkpoint(self, ckpt) -> None:
        """Attach a ``checkpoint.SlotCheckpoint``: every ingested batch then
        becomes durable (a WAL record, or a snapshot at the interval / after
        a re-layout) and every EXECUTED rescale writes a scale barrier — the
        state ``report_failure`` recoveries restore from."""
        if self.stream is None or getattr(self.stream, "orderer", None) is None:
            raise ValueError(
                "attach_stream first: the checkpoint snapshots the engine's orderer"
            )
        self.checkpoint = ckpt

    def report_failure(
        self,
        lost_hosts,
        *,
        detect_s: float = 0.0,
        reason: str = "process lease expired",
        restored_bytes: int = 0,
        restore_s: float = 0.0,
        replayed_records: int = 0,
    ) -> tuple[FailureEvent, Optional[ScaleEvent]]:
        """Treat process loss as an UNPLANNED rescale: mark the lost hosts
        dead (k_min floor applied, like ``poll`` eviction), sequence a
        FailureEvent, and re-plan k over the survivors through the same
        ``_emit``/``_execute`` path every planned decision takes. A failure
        shrink arms BOTH autoscaler cooldown windows like any other executed
        decision — the policy must not bounce k right back out (or further
        in) while the cluster is still settling. Returns (failure event,
        executed scale event or None when the floor retained every host)."""
        lost = [int(h) for h in lost_hosts if h in self.hosts and self.hosts[h].alive]
        k_old = self.k
        evict, clamp = self._clamp_eviction(lost)
        for hid in evict:
            self.hosts[hid].alive = False
        fev = FailureEvent(
            kind="failure",
            lost_hosts=tuple(evict),
            k_old=k_old,
            k_new=self.k,
            detect_s=float(detect_s),
            reason=f"{reason}{clamp}",
            restored_bytes=int(restored_bytes),
            restore_s=float(restore_s),
            replayed_records=int(replayed_records),
            seq=self._next_seq(),
        )
        self.events.append(fev)
        self._m_failures.inc()
        self._mark_event()
        sev = None
        if evict:
            sev = self._emit(
                "scale_in", k_old, self.k, tuple(evict), f"failure shrink: {reason}{clamp}"
            )
            if self.autoscaler is not None:
                self.autoscaler.note_external_scale(self.clock())
        return fev, sev

    def note_backlog(self, depth: int) -> None:
        """Report an external work backlog (a serve loop's query queue) into
        the ``controller.queue_depth`` gauge — the autoscaler's queue signal.
        The gauge always reads backlog + rebuilds-in-flight, so ingest-side
        pressure and serve-side pressure land on one signal."""
        self._backlog = int(depth)
        self._m_queue.set(self._backlog + int(getattr(self.stream, "rebuilds_in_flight", 0)))

    def autoscale(self) -> Optional[ScaleEvent]:
        """Consult the attached policy against the current metrics and clock;
        execute at most one decision. Scale-out provisions fresh host ids
        (the ``add_hosts`` path); scale-in retires the highest-id alive hosts
        — the CEP chunk boundary shifts are Thm.-2-cheap either way. Returns
        the executed ScaleEvent, or None (no policy / no decision)."""
        if self.autoscaler is None:
            return None
        decision = self.autoscaler.decide(
            k=self.k, now=self.clock(), registry=self.metrics
        )
        if decision is None:
            return None
        k_new, reason = decision
        k_old = self.k
        if k_new > k_old:
            base = max(self.hosts) + 1 if self.hosts else 0
            now = self.clock()
            for i in range(k_new - k_old):
                self.hosts[base + i] = HostState(base + i, now, 0)
            return self._emit("scale_out", k_old, self.k, (), reason)
        retired = sorted(h.host_id for h in self.hosts.values() if h.alive)[k_new - k_old:]
        for hid in retired:
            self.hosts[hid].alive = False
        return self._emit("scale_in", k_old, self.k, tuple(retired), reason)

    def _cache_counters(self) -> dict:
        """Per-kind program-cache counters of the attached stream engine (a
        host-only replay stream has none — default to empty)."""
        fn = getattr(self.stream, "program_cache_counters", None)
        return fn() if fn is not None else {}

    def _drain_rebuilds(self) -> list:
        """Wrap the engine's completed rebuild records into RebuildEvents,
        assigning the shared seq NOW — completion-commit time. Called before
        the IngestEvent of the completing batch is sequenced, so the log
        order is rebuild-then-ingest, exactly the order the state changed."""
        drain = getattr(self.stream, "drain_rebuild_events", None)
        if drain is None:
            return []
        out = []
        for rec in drain():
            ev = RebuildEvent(
                kind=rec["kind"],
                mode=rec["mode"],
                committed=rec["committed"],
                aborted=rec["aborted"],
                snapshot_edges=rec["snapshot_edges"],
                replayed_batches=rec["replayed_batches"],
                splice_ops=rec["splice_ops"],
                flight_batches=rec["flight_batches"],
                dispatch_s=rec["dispatch_s"],
                commit_s=rec["commit_s"],
                seq=self._next_seq(),
            )
            self.events.append(ev)
            out.append(ev)
        return out

    def ingest(self, batch) -> IngestEvent:
        """Apply an EdgeUpdateBatch to the attached stream, run the quality
        monitor (escalation ladder: ingest → partial re-order → async full
        rebuild), and log the event in the shared seq order. A rebuild the
        monitor completed (committed or aborted) is sequenced as its own
        RebuildEvent immediately before this batch's IngestEvent."""
        if self.stream is None:
            raise ValueError("no streaming engine attached (call attach_stream first)")
        stats = self.stream.ingest(batch)
        t0 = time.perf_counter()
        escalation = self.stream.monitor()
        monitor_s = time.perf_counter() - t0
        self._drain_rebuilds()
        if self.checkpoint is not None:
            # Durability point: the batch AND any monitor-run repair/rebuild
            # are applied — WAL-append (or snapshot) their slot writes now.
            self._batch_step += 1
            self.checkpoint.note_batch(self.stream.orderer, batch, self._batch_step)
        self._m_wall.observe(stats.elapsed_s + monitor_s)
        self._m_queue.set(self._backlog + int(getattr(self.stream, "rebuilds_in_flight", 0)))
        self._m_ingests.inc()
        self._mark_event()
        # Per-rung ladder accounting (StreamingEngine keeps the counters; a
        # host-only replay stream may not — default to empty).
        counts = getattr(self.stream, "rung_counts", {})
        totals = getattr(self.stream, "rung_s", {})
        ev = IngestEvent(
            kind="ingest",
            inserted=stats.inserted,
            deleted=stats.deleted,
            skipped=stats.skipped,
            escalation=escalation,
            num_edges=stats.num_edges,
            elapsed_s=stats.elapsed_s,
            monitor_s=monitor_s,
            seq=self._next_seq(),
            repair=getattr(self.stream, "last_repair", ""),
            rung_count=int(counts.get(escalation, 0)),
            rung_total_s=float(totals.get(escalation, 0.0)),
            rebuild_state=getattr(self.stream, "rebuild_state", ""),
            rebuild_s=float(getattr(self.stream, "last_rebuild_s", 0.0)),
            rebuilds_in_flight=int(getattr(self.stream, "rebuilds_in_flight", 0)),
            program_cache=self._cache_counters(),
            spill=dict(getattr(self.stream, "spill_counters", None) or {}),
        )
        self.events.append(ev)
        return ev

    def _emit(self, kind, k_old, k_new, lost, reason) -> ScaleEvent:
        """Decision + dispatch in one call — what the membership hooks
        (``add_hosts``/``poll``) use."""
        return self._execute(ScaleDecision(kind, k_old, k_new, tuple(lost), reason))

    def _execute(self, decision: ScaleDecision) -> ScaleEvent:
        """Dispatch a ScaleDecision against whatever engine is attached and
        sequence the resulting ScaleEvent. Pure plan (no engine): the CEP
        model supplies the migration fraction."""
        kind, k_old, k_new, lost, reason = (
            decision.kind,
            decision.k_old,
            decision.k_new,
            decision.lost_hosts,
            decision.reason,
        )
        executed = False
        cross_device_bytes = 0
        cross_process_bytes = 0
        frac = None
        if self.stream is not None and k_new not in (0, self.stream.k):
            stats = self.stream.rescale(k_new)
            self.rescale_stats.append(stats)
            executed = True
            cross_device_bytes = stats.cross_device_bytes
            cross_process_bytes = stats.cross_process_bytes
            frac = stats.moved_edges / max(stats.num_edges, 1)
            if self.checkpoint is not None:
                # Scale barrier: replay re-runs relayout(k_new) here instead
                # of replaying slot ops across the geometry change.
                self.checkpoint.note_scale(self.stream.orderer, k_new, self._batch_step)
        elif self.stream is None and self.engine_data is not None and k_new not in (0, self.engine_data.k):
            if self._rescaler is None:
                from .rescale_exec import ElasticRescaler

                self._rescaler = ElasticRescaler()
            self.engine_data, stats = self._rescaler.rescale(self.engine_data, k_new)
            self.rescale_stats.append(stats)
            executed = True
            cross_device_bytes = stats.cross_device_bytes
            cross_process_bytes = stats.cross_process_bytes
            # Report what was actually migrated, not the synthetic model.
            frac = stats.migrated_edges / max(stats.num_edges, 1)
        if frac is None:
            if k_new == k_old or k_new == 0:
                frac = 0.0
            else:
                frac = cep.migrated_edges_exact(self.state_elements, k_old, k_new) / self.state_elements
        # A rescale aborts any in-flight rebuild: sequence the abort record
        # BEFORE the scale event that caused it.
        self._drain_rebuilds()
        self._m_scales.inc()
        self._mark_event()
        ev = ScaleEvent(
            kind, k_old, k_new, lost, frac, reason, executed, cross_device_bytes,
            cross_process_bytes, seq=self._next_seq(),
            program_cache=self._cache_counters(),
        )
        self.events.append(ev)
        return ev
