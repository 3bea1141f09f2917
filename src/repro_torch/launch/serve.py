"""Graph-query serving front end over a live StreamingEngine.

  python -m repro_torch.launch.serve --ticks 96               # on the card
  python -m repro_torch.launch.serve --ticks 96 --device cpu  # on the CPU

The last consumer the paper's pipeline needs: the graph is not just
maintained (ingest) and not just elastic (rescale) — it is *queried while
both happen*. This module serves concurrent PageRank / SSSP / WCC queries
against the streaming pack between ingest batches, closing the loop the
traffic-driven autoscaler (elastic/autoscale.py) scales:

* ``QueryEngine`` — executes one query against the engine's CURRENT pack via
  the pure-operand programs of ``graphs.engine.query_program``. The pack
  operands are read at call time, so a query issued right after a rescale or
  an async full-rebuild commit runs against the new layout with no
  coordination. Each call is timed with a SINGLE ``perf_counter`` pair
  (start before the call, stop after ``torch.cuda.synchronize`` when the
  pack lies on a card) and recorded once; every consumer — histogram, SLO
  check, stdout — reads that one number, so a printed latency can never
  disagree with the recorded one.

* ``ServeLoop`` — the worker loop: one *tick* of the shared virtual clock
  ingests the next update batch through the controller, admits the tick's
  open-loop arrivals (stream/workload.py) into a FIFO queue, retires what
  the current capacity allows, probes the live pack with real measured
  queries, reports the backlog into the controller's queue gauge, and lets
  the attached autoscaler act. Queue WAITING is modeled on the virtual
  timeline (a deterministic G/G/k system: capacity = k × per-host service
  rate, identical on every machine, so the autoscaler's trajectory is
  replayable in CI), while query EXECUTION is measured for real on the
  device — the modeled latency a query reports is its virtual wait + virtual
  service time, and the probe histograms carry the measured numbers
  alongside. Dispatch is between batches by construction: a query never
  interleaves with a device mutation, which is what lets it read the live
  buffers without snapshotting.

The controller, autoscaler, workload, and this loop all run on ONE injected
clock — the serve loop owns it and advances it tick by tick — so hysteresis
windows, events/s, and arrival ramps share a timeline and the whole system
is a pure function of (seed, config). Over a ``GraphGroup`` every rank runs
the same loop: a probe is a collective that every rank reaches on the same
tick, and the decisions agree without communication as long as no policy
signal reads a measured time (keep ``AutoscaleConfig.p99_high_s`` infinite).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device
from ..graphs import engine as graph_engine
from ..obs import metrics as OM

__all__ = ["QueryEngine", "ServeConfig", "ServeLoop", "QueryRecord"]


@dataclasses.dataclass(frozen=True)
class QueryRecord:
    """One retired query: where it waited and what it cost."""

    tick: int  # retirement tick
    arrival_tick: int
    kind: str
    latency_s: float  # virtual wait + virtual service (the SLO-checked number)
    violated: bool  # latency_s > slo_s
    measured_s: float  # device wall of the probe run, 0.0 for modeled-only


class QueryEngine:
    """Concurrent-query executor over a StreamingEngine's live pack.

    Stateless between calls: queries read ``stream.data`` at call time, so
    rescales and rebuild commits swap the pack underneath without any
    handshake. A program is built per call (``query_program`` caches
    nothing: there is nothing to compile).
    """

    def __init__(
        self,
        stream,
        *,
        registry=None,
        pagerank_iters: int = 8,
        query_max_iters: int = 32,
    ):
        self.stream = stream
        self.metrics = OM.NULL if registry is None else registry
        self.pagerank_iters = int(pagerank_iters)
        self.query_max_iters = int(query_max_iters)
        self._m_measured = self.metrics.histogram("serve.query_measured_s")
        self._m_count = self.metrics.counter("serve.queries")

    def _program(self, kind: str):
        data = self.stream.data
        return graph_engine.query_program(
            kind,
            num_vertices=data.num_vertices,
            group=data.group,
            iterations=self.pagerank_iters,
            max_iters=self.query_max_iters,
        )

    def query(self, kind: str, source: int = 0):
        """Run one query against the current pack. Returns (result,
        elapsed_s) where elapsed_s is ONE perf_counter pair around the call +
        ``torch.cuda.synchronize`` (when the pack lies on a card) — the only
        timing read; everything downstream (histogram, caller prints) reuses
        it. SSSP and WCC read their stop flag on the host every iteration
        (the reference's ``while_loop`` stops on the device), so their time
        includes those round trips; their iteration counts equal the
        reference's."""
        data = self.stream.data
        prog = self._program(kind)
        t0 = time.perf_counter()
        if kind == "pagerank":
            out = prog(data.edges, data.mask, data.degrees)
        elif kind == "sssp":
            out = prog(data.edges, data.mask, source % max(1, data.num_vertices))
        elif kind == "wcc":
            out = prog(data.edges, data.mask)
        else:
            raise ValueError(f"unknown query kind {kind!r}")
        if data.edges.device.type == "cuda":
            torch.cuda.synchronize(data.edges.device)
        elapsed = time.perf_counter() - t0
        self._m_measured.observe(elapsed)
        self._m_count.inc()
        return out, elapsed

    def warm(self) -> None:
        """Run every query kind once on the current layout, so the first
        served tick measures execution, not CUDA's lazy initialisation and
        the allocator's first requests."""
        for kind in graph_engine.QUERY_KINDS:
            self.query(kind, source=0)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serve-loop timing + capacity model.

    The capacity model is deliberately machine-independent: one host retires
    ``per_host_rate`` queries per tick of ``tick_s`` virtual seconds,
    regardless of how fast this machine runs the probes — so the backlog
    trajectory, and with it every autoscaler decision, is a pure function of
    (workload seed, config) and replays identically in CI.
    """

    tick_s: float = 1.0  # virtual seconds one tick advances the shared clock
    per_host_rate: float = 2.0  # queries one host retires per tick
    slo_s: float = 4.0  # SLO bound on modeled latency (wait + service)
    probe_every: int = 8  # run a real measured query every N ticks (0 = never)
    queue_cap: int = 100_000  # admission bound: arrivals beyond it are shed
    verify_every_event: bool = True  # bit-identity oracle after every event

    def __post_init__(self):
        if self.tick_s <= 0 or self.per_host_rate <= 0:
            raise ValueError("tick_s and per_host_rate must be > 0")
        if self.slo_s <= 0:
            raise ValueError("slo_s must be > 0")
        if self.probe_every < 0 or self.queue_cap < 1:
            raise ValueError("probe_every >= 0, queue_cap >= 1")


class ServeLoop:
    """The ingest-serve-autoscale worker loop on one virtual clock.

    Construct with a controller that already has a stream attached (and
    optionally an autoscaler); drive with ``run(ticks)`` or ``tick()``.
    The loop owns the clock: pass ``controller.clock`` a callable reading
    ``loop.now`` (see ``main()``), or any clock the caller advances.
    """

    def __init__(
        self,
        controller,
        workload,
        *,
        updates=None,
        config: ServeConfig = ServeConfig(),
        registry=None,
        query_engine: Optional[QueryEngine] = None,
    ):
        if controller.stream is None:
            raise ValueError("controller has no stream attached (attach_stream first)")
        self.controller = controller
        self.workload = workload
        self.updates = updates  # SyntheticStream (or None: serve-only loop)
        self.config = config
        self.metrics = OM.NULL if registry is None else registry
        self.queries = query_engine or QueryEngine(controller.stream, registry=registry)
        self.now = 0.0  # the virtual timeline (controller clock reads this)
        self.tick_index = 0
        self.queue: list = []  # FIFO of pending QueryArrival
        self._credit = 0.0  # fractional service capacity carried across ticks
        self.records: list = []  # retired QueryRecord, arrival order
        self.scale_events: list = []  # autoscaler-driven ScaleEvents
        self.scale_stats: list = []  # matching StreamRescaleStats (None if unexecuted)
        self.shed = 0  # arrivals dropped at the admission bound
        self.slo_violations = 0
        self._m_lat = self.metrics.histogram("serve.latency_s")
        self._m_queue = self.metrics.gauge("serve.queue_depth")
        self._m_viol = self.metrics.counter("serve.slo_violations")
        self._m_shed = self.metrics.counter("serve.shed")

    # ---------------------------------------------------------------- phases
    def _ingest_phase(self) -> None:
        if self.updates is not None:
            self.controller.ingest(self.updates.batch())
            if self.config.verify_every_event:
                self.controller.stream.verify_bit_identity()

    def _admit_phase(self) -> None:
        for arr in self.workload.arrivals(self.tick_index):
            if len(self.queue) >= self.config.queue_cap:
                self.shed += 1
                self._m_shed.inc()
                continue
            self.queue.append(arr)

    def _serve_phase(self) -> None:
        c = self.config
        # Deterministic G/G/k service: k lanes × per_host_rate, fractional
        # capacity carried forward so non-integer rates average out exactly.
        self._credit += self.controller.k * c.per_host_rate
        probe_due = c.probe_every > 0 and self.tick_index % c.probe_every == 0
        service_s = c.tick_s / c.per_host_rate
        while self._credit >= 1.0 and self.queue:
            self._credit -= 1.0
            arr = self.queue.pop(0)
            waited = (self.tick_index - arr.tick) * c.tick_s
            latency = waited + service_s
            measured = 0.0
            if probe_due:
                # One real run of the query being retired on the device —
                # measured latency alongside the modeled number; the pack it
                # reads is whatever layout the last event left live.
                _, measured = self.queries.query(arr.kind, source=arr.source)
                probe_due = False
            violated = latency > c.slo_s
            if violated:
                self.slo_violations += 1
                self._m_viol.inc()
            self._m_lat.observe(latency)
            self.records.append(
                QueryRecord(
                    tick=self.tick_index, arrival_tick=arr.tick, kind=arr.kind,
                    latency_s=latency, violated=violated, measured_s=measured,
                )
            )
        # Unused capacity does not bank across an idle period: an empty queue
        # resets the carry to its fractional part, so a quiet night cannot
        # absorb the morning burst for free.
        if not self.queue:
            self._credit = self._credit % 1.0

    def _autoscale_phase(self) -> None:
        depth = len(self.queue)
        self._m_queue.set(depth)
        self.controller.note_backlog(depth)
        ev = self.controller.autoscale()
        if ev is not None:
            self.scale_events.append(ev)
            self.scale_stats.append(
                self.controller.rescale_stats[-1] if ev.executed else None
            )
            if self.config.verify_every_event:
                self.controller.stream.verify_bit_identity()

    # ------------------------------------------------------------------- api
    def tick(self) -> None:
        """One unit of the worker loop: advance the shared clock, ingest the
        next update batch, admit this tick's arrivals, retire what capacity
        allows (probing the live pack), then let the autoscaler act on the
        backlog it can now see."""
        self.now += self.config.tick_s
        self._ingest_phase()
        self._admit_phase()
        self._serve_phase()
        self._autoscale_phase()
        self.tick_index += 1

    def run(self, ticks: int) -> dict:
        for _ in range(int(ticks)):
            self.tick()
        return self.summary()

    def drain(self, max_ticks: int = 10_000) -> None:
        """Retire the remaining backlog (no new arrivals or ingest) so
        end-of-run percentiles include every admitted query."""
        for _ in range(max_ticks):
            if not self.queue:
                return
            self.now += self.config.tick_s
            self._serve_phase()
            self._autoscale_phase()
            self.tick_index += 1

    def summary(self) -> dict:
        lat = self._m_lat
        served = len(self.records)
        k_path = [self.scale_events[0].k_old] if self.scale_events else [self.controller.k]
        for ev in self.scale_events:
            k_path.append(ev.k_new)
        return {
            "k_path": k_path,
            "ticks": self.tick_index,
            "served": served,
            "shed": self.shed,
            "backlog": len(self.queue),
            "k": self.controller.k,
            "latency_p50_s": lat.percentile(50),
            "latency_p99_s": lat.percentile(99),
            "slo_violations": self.slo_violations,
            "slo_frac": self.slo_violations / max(1, served),
            "scale_outs": sum(1 for e in self.scale_events if e.kind == "scale_out"),
            "scale_ins": sum(1 for e in self.scale_events if e.kind == "scale_in"),
            "migrated_bytes_per_decision": [
                int(e.cross_device_bytes) for e in self.scale_events
            ],
            # cross_device_bytes is honestly 0 on a world of one; the
            # edge-movement view is layout-level and meaningful everywhere.
            "moved_edges_per_decision": [
                int(s.moved_edges) if s is not None else 0 for s in self.scale_stats
            ],
            "probe_p50_s": self.queries._m_measured.percentile(50),
            "probe_p99_s": self.queries._m_measured.percentile(99),
        }


def main(argv=None) -> None:
    """Live demo: a diurnal+bursty day of traffic over a streaming RMAT
    graph, with the autoscaler moving k both directions. Runs on the card
    unless ``--device cpu``; asking for the card without one raises
    ``RuntimeError`` before any work."""
    from ..core import ordering
    from ..core.graph import rmat_graph
    from ..elastic import autoscale as EA
    from ..elastic import controller as ec
    from ..stream import IncrementalOrderer, StreamingEngine, SyntheticStream
    from ..stream.workload import OpenLoopWorkload

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=9, help="RMAT scale (2^scale vertices)")
    ap.add_argument("--ticks", type=int, default=96)
    ap.add_argument("--k0", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = rmat_graph(args.scale, 8, seed=args.seed)
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)
    orderer = IncrementalOrderer(src, dst, g.num_vertices, regions=args.k0)
    engine = StreamingEngine(orderer, device=device)

    registry = OM.MetricsRegistry()
    loop_ref = []
    ctl = ec.ElasticController(
        args.k0, clock=lambda: loop_ref[0].now if loop_ref else 0.0,
        metrics_registry=registry,
    )
    ctl.attach_stream(engine)
    ctl.attach_autoscaler(
        EA.AutoscalePolicy(
            EA.AutoscaleConfig(
                k_min=2, k_max=12, queue_high_per_host=3.0, queue_low=0.5,
                out_cooldown_s=8.0, in_cooldown_s=24.0, ema=0.6,
            )
        )
    )
    workload = OpenLoopWorkload(
        num_vertices=g.num_vertices, base_rate=args.k0 * 2.0, day_ticks=args.ticks,
        diurnal_amp=0.8, burst_every=24, burst_factor=3.0, seed=args.seed,
    )
    updates = SyntheticStream(g, batch_size=32, seed=args.seed)
    loop = ServeLoop(ctl, workload, updates=updates, registry=registry)
    loop_ref.append(loop)
    loop.queries.warm()

    t0 = time.perf_counter()
    loop.run(args.ticks)
    loop.drain()
    wall = time.perf_counter() - t0  # single read: every print below reuses it
    s = loop.summary()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"served {s['served']} queries over {s['ticks']} ticks in {wall:.2f}s "
        f"({s['served'] / wall:,.0f} queries/s wall) on {where}"
    )
    print(
        f"  modeled latency p50 {s['latency_p50_s']:.2f}s p99 {s['latency_p99_s']:.2f}s "
        f"(virtual), SLO violations {s['slo_violations']} "
        f"({100 * s['slo_frac']:.1f}%), backlog {s['backlog']}, shed {s['shed']}"
    )
    print(
        f"  measured probe p50 {s['probe_p50_s'] * 1e3:.1f}ms "
        f"p99 {s['probe_p99_s'] * 1e3:.1f}ms on {where}"
    )
    print(
        f"  autoscaler: {s['scale_outs']} out + {s['scale_ins']} in, final k={s['k']}, "
        f"migrated bytes per decision {s['migrated_bytes_per_decision']}"
    )
    for ev in loop.scale_events:
        print(f"    seq {ev.seq}: {ev.kind} {ev.k_old}->{ev.k_new} — {ev.reason}")


if __name__ == "__main__":
    main()
