"""Traffic-driven autoscaling policy for the elastic controller.

Everything before this module rescales when *told to*; production rescales
because *load changed* (Spinner's cloud-elasticity scenario, xDGP's
adapt-to-workload loop — PAPERS.md). ``AutoscalePolicy`` closes that loop:
it reads the observability registry the runtime already publishes to
(DESIGN.md §13 — the ``controller.queue_depth`` / ``controller.events_per_s``
gauges and the ``controller.batch_wall_s`` latency histogram were added for
exactly this consumer) and turns load into ``k``:

* **scale out** when the smoothed queue backlog per alive host exceeds
  ``queue_high_per_host``, the event rate exceeds ``rate_high``, or the
  recent-window p99 of the wall histogram exceeds ``p99_high_s`` (the SLO);
* **scale in** only when EVERY signal sits under its low watermark —
  backlog at/below ``queue_low``, rate under ``rate_low``, p99 under
  ``p99_low_frac · p99_high_s`` — and at least one wall observation exists
  (an idle registry that has never seen load is "no signal", not "no load").

Hysteresis is modeled on the escalation ladder's ``partial_cooldown``
(stream/incremental.py): per-direction cooldown windows on the controller's
injected clock, and EVERY decision arms both — a reversal (out→in or in→out)
is therefore always separated by at least the smaller cooldown, which is
what makes "zero flap pairs" a structural property of the policy rather
than a lucky trajectory (bench_serve gates on it). A scale-out arms the
(typically longer) in-window in full; a scale-in arms the out-window in
full, delaying a post-shrink spike response by at most ``out_cooldown_s``.
Signals are EMA-smoothed (``ema`` = weight of the newest
reading, like the rebuild-dispatch anticipation's drift EMA) so one bursty
batch cannot whipsaw k. Thresholds are strict (``>`` high / ``<`` low);
cooldown expiry is inclusive (``now - last >= cooldown`` re-arms) — the
boundary tests pin both.

Decisions are (k_new, reason) tuples; ``ElasticController.autoscale()``
executes them through the same ``_execute`` path membership changes use, so
a policy-driven rescale is the same on-device migration as a preemption-driven
one — migrated bytes per decision come for free from
``ScaleEvent.cross_device_bytes``, and the bit-identity oracle covers it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds + hysteresis of a traffic-driven policy.

    The defaults read the controller's own metrics; serving front ends point
    ``wall_metric`` at their query-latency histogram instead (launch/serve.py
    uses ``serve.latency_s``) so the p99 signal tracks what the SLO actually
    covers.
    """

    k_min: int = 1  # clamp floor (>= the controller's eviction floor)
    k_max: int = 64  # clamp ceiling
    step_out: int = 2  # hosts provisioned per scale-out decision
    step_in: int = 1  # hosts retired per scale-in decision (shrink cautiously)
    queue_high_per_host: float = 4.0  # backlog / k that triggers scale-out
    # Total smoothed backlog at/below which scale-in is allowed. Must be > 0
    # in any config that smooths (ema < 1): the EMA decays geometrically and
    # never reaches exactly zero after load, so a 0.0 watermark would
    # permanently veto scale-in.
    queue_low: float = 0.5
    rate_high: float = math.inf  # events/s high watermark (inf = signal off)
    rate_low: float = math.inf  # events/s low watermark (inf = never blocks in)
    p99_high_s: float = math.inf  # recent-p99 SLO on the wall histogram
    p99_low_frac: float = 0.5  # scale-in needs p99 < p99_low_frac * p99_high_s
    p99_window: int = 256  # newest samples the p99 readout covers
    ema: float = 0.5  # weight of the newest reading (1.0 = unsmoothed)
    out_cooldown_s: float = 10.0  # min seconds between scale-outs
    in_cooldown_s: float = 30.0  # min seconds between scale-ins (and after an out)
    queue_metric: str = "controller.queue_depth"
    rate_metric: str = "controller.events_per_s"
    wall_metric: str = "controller.batch_wall_s"

    def __post_init__(self):
        if not 1 <= self.k_min <= self.k_max:
            raise ValueError(f"need 1 <= k_min <= k_max, got [{self.k_min}, {self.k_max}]")
        if self.step_out < 1 or self.step_in < 1:
            raise ValueError("step_out and step_in must be >= 1")
        if not 0.0 < self.ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        if self.out_cooldown_s < 0 or self.in_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if not 0.0 <= self.p99_low_frac <= 1.0:
            raise ValueError("p99_low_frac must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class AutoscaleSignals:
    """One ``decide()`` evaluation's smoothed inputs + raw readings —
    appended to ``AutoscalePolicy.log`` so a bench can show WHY each
    decision (or non-decision) happened."""

    now: float
    k: int
    queue: float  # EMA-smoothed queue depth
    rate: float  # EMA-smoothed events/s
    p99_s: float  # recent-window p99 of the wall histogram (unsmoothed:
    # a percentile over a window is already an aggregate)
    raw_queue: float
    raw_rate: float
    wall_total: int  # lifetime wall observations (0 = no load signal yet)
    decision: str  # "scale_out" | "scale_in" | "" (held)
    held_by: str  # "" | "cooldown" | "clamp" | "no_signal" | "steady"


class AutoscalePolicy:
    """Stateful watermark policy: EMA-smoothed signals, per-direction
    cooldowns, k clamps. One instance per controller (it carries the EMA and
    cooldown state); ``decide`` is pure in (k, now, registry) given that
    state, so a fake clock + a hand-fed registry drive it deterministically
    in tests."""

    def __init__(self, config: AutoscaleConfig = AutoscaleConfig()):
        self.config = config
        self._ema_queue: Optional[float] = None
        self._ema_rate: Optional[float] = None
        self._next_out_t = -math.inf
        self._next_in_t = -math.inf
        self.log: list = []  # AutoscaleSignals, one per decide() call

    def _smooth(self, prev: Optional[float], new: float) -> float:
        a = self.config.ema
        return new if prev is None else (1.0 - a) * prev + a * new

    def note_external_scale(self, now: float) -> None:
        """An EXTERNAL actor changed k (a failure shrink through
        ``ElasticController.report_failure``, an operator override): arm both
        cooldown windows exactly like a policy decision would. Without this,
        a failure shrink looks like free headroom and the policy may bounce k
        right back out (or pile a policy shrink on top) while the cluster is
        still re-committing the restored pack — the same flap the
        double-armed windows exist to prevent. Never shortens a window
        already armed further out."""
        c = self.config
        self._next_out_t = max(self._next_out_t, now + c.out_cooldown_s)
        self._next_in_t = max(self._next_in_t, now + c.in_cooldown_s)

    def decide(self, *, k: int, now: float, registry) -> Optional[tuple[int, str]]:
        """At most one decision per call: (k_new, reason) or None. Reads the
        registry's current values, advances the EMAs, honors cooldowns and
        clamps. The reason string carries the signal values that fired, so
        the emitted ScaleEvent is self-explaining in the event log."""
        c = self.config
        wall = registry.histogram(c.wall_metric)
        raw_queue = float(registry.gauge(c.queue_metric).value)
        raw_rate = float(registry.gauge(c.rate_metric).value)
        wall_total = int(wall.total)
        p99 = float(wall.percentile(99, window=c.p99_window))
        self._ema_queue = self._smooth(self._ema_queue, raw_queue)
        self._ema_rate = self._smooth(self._ema_rate, raw_rate)
        queue, rate = self._ema_queue, self._ema_rate

        overloaded = (
            queue > c.queue_high_per_host * max(1, k)
            or rate > c.rate_high
            or p99 > c.p99_high_s
        )
        # Scale-in demands every signal calm AND at least one wall
        # observation: a registry that never saw load is silence, not idleness.
        underloaded = (
            wall_total > 0
            and queue <= c.queue_low
            and rate < c.rate_low
            and (math.isinf(c.p99_high_s) or p99 < c.p99_low_frac * c.p99_high_s)
        )

        decision, held = "", "steady"
        k_new, reason = k, ""
        if overloaded:
            if now < self._next_out_t:
                held = "cooldown"
            elif k >= c.k_max:
                held = "clamp"
            else:
                k_new = min(c.k_max, k + c.step_out)
                decision, held = "scale_out", ""
                reason = (
                    f"autoscale out {k}->{k_new}: queue {queue:.1f} "
                    f"(> {c.queue_high_per_host:g}/host)"
                    if queue > c.queue_high_per_host * max(1, k)
                    else f"autoscale out {k}->{k_new}: "
                    + (f"rate {rate:.1f}/s > {c.rate_high:g}" if rate > c.rate_high
                       else f"p99 {p99 * 1e3:.1f}ms > {c.p99_high_s * 1e3:.0f}ms")
                )
                # An out arms BOTH windows: capacity just provisioned must
                # not be torn down before it absorbed anything.
                self._next_out_t = now + c.out_cooldown_s
                self._next_in_t = max(self._next_in_t, now + c.in_cooldown_s)
        elif underloaded:
            if now < self._next_in_t:
                held = "cooldown"
            elif k <= c.k_min:
                held = "clamp"
            else:
                k_new = max(c.k_min, k - c.step_in)
                decision, held = "scale_in", ""
                reason = (
                    f"autoscale in {k}->{k_new}: queue {queue:.1f} <= {c.queue_low:g}, "
                    f"p99 {p99 * 1e3:.1f}ms"
                )
                self._next_in_t = now + c.in_cooldown_s
                # Symmetric guard: an immediate out after an in would be a
                # flap pair — the shrink must stand for at least one
                # out-window before load may reverse it.
                self._next_out_t = max(self._next_out_t, now + c.out_cooldown_s)
        elif wall_total == 0 and raw_queue == 0.0 and raw_rate == 0.0:
            held = "no_signal"
        self.log.append(
            AutoscaleSignals(
                now=now, k=k, queue=queue, rate=rate, p99_s=p99,
                raw_queue=raw_queue, raw_rate=raw_rate, wall_total=wall_total,
                decision=decision, held_by=held,
            )
        )
        return (k_new, reason) if decision else None
