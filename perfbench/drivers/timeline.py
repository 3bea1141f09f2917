"""The general driver: plays a mix's timeline of scale events and queries.

A mix (``mixes/<name>.json``) gives:

* ``scale_events``: ``{"every_s": null}`` for scale events back to back, one
  starting as the last ends, for the whole window; or ``{"every_s": s}`` for
  one due every s seconds. Each event draws its k_new: with ``small_share``
  it adds or removes 1 to ``small_max`` workers, else it scales k by a
  factor drawn log-uniform in ``factor``; k_new is clamped to the
  configuration's ``k_range`` and never equals k.
* ``queries``: ``rate_per_s`` (0 for none), the kinds' weights ``mix`` and
  the programs' parameters. Arrivals are one Poisson process at that rate,
  each query's kind drawn by the weights.
* ``schedule_seed``: draws the first k, the walk of k_new, the arrivals and
  the set of SSSP sources (vertices with an edge), one for each SSSP query
  due in the window, so that every run offers the same work (a walk, an
  arrival order or a set of sources of its own would change the work from
  seed to seed more than the program changes between two runs). The run's
  seed draws the order in which the SSSP queries take those sources and the
  packs the check compares slot by slot.

One worker serves the timeline in due order, first in, first out: a query
never overlaps a scale event. An item is timed from when it was due (a back
to back event: from its start) to its result on the card after a
synchronize. The worker waits for an item's due time by sleeping to within
``SPIN_S`` of it and polling the clock for the rest: a sleep wakes late by a
part of a millisecond that varies with the host's load, and that lateness
would count in every query that found the worker idle. Every item due in the window is served, the last ones after
its close; one that cannot start within ``GRACE_S`` of the close counts as
failed.

Over several ranks (``ranks.World``) every rank plays the same timeline, and
each item ends in ``World.settle``: rank 0's clock decides when the back to
back events stop and when the grace has run out, and an item ends when
every rank has its result. There an item that raises ends the run: the
other ranks would wait for it in their collectives.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from perfbench import ranks

GRACE_S = 60.0  # how long past the window's close an item due in it may start
SPIN_S = 0.005  # the last stretch of a wait for a due time, spent polling the clock


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of the run's seed, one stream for each kind of draw."""
    return np.random.default_rng([int(seed) % 2**63, stream])


class ScaleSteps:
    """The k_new of successive scale events, drawn from the schedule's seed."""

    def __init__(self, params: dict, k_range, schedule_seed: int):
        self.small_share = float(params["small_share"])
        self.small_max = int(params["small_max"])
        self.lo, self.hi = (math.log(float(f)) for f in params["factor"])
        self.k_min, self.k_max = (int(k) for k in k_range)
        self.rng = rng(schedule_seed, 1)

    def next(self, k: int) -> int:
        r = self.rng
        if r.random() < self.small_share:
            step = int(r.integers(1, self.small_max + 1))
            k_new = k + (step if r.random() < 0.5 else -step)
        else:
            k_new = int(round(k * math.exp(r.uniform(self.lo, self.hi))))
        k_new = min(max(k_new, self.k_min), self.k_max)
        if k_new == k:
            k_new = k + 1 if k < self.k_max else k - 1
        return k_new


def first_k(k_range, mix: dict) -> int:
    return int(rng(mix["schedule_seed"], 3).integers(int(k_range[0]), int(k_range[1]) + 1))


def wait_until(deadline: float) -> None:
    """Returns once ``time.perf_counter()`` reads ``deadline``: sleeps to
    within ``SPIN_S`` of it, then polls."""
    left = deadline - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < deadline:
        pass


def sssp_sources(mix: dict, present: np.ndarray, n: int) -> np.ndarray:
    """The schedule's ``n`` SSSP sources, drawn from ``present`` (the vertices
    with an edge) by the schedule's seed."""
    return present[rng(mix["schedule_seed"], 2).integers(present.shape[0], size=n)]


def query_schedule(mix: dict, seconds: float) -> list:
    """``[(due_s, kind), ...]`` of the queries due in ``[0, seconds)``."""
    params = mix["queries"]
    rate = float(params.get("rate_per_s", 0.0))
    if rate <= 0:
        return []
    r = rng(mix["schedule_seed"], 0)
    kinds = sorted(params["mix"])
    weights = np.asarray([float(params["mix"][k]) for k in kinds])
    out, t = [], 0.0
    while True:
        t += float(r.exponential(1.0 / rate))
        if t >= seconds:
            return out
        out.append((t, kinds[int(r.choice(len(kinds), p=weights / weights.sum()))]))


class Player:
    """Serves a mix on a ``sut.System`` and records every item."""

    def __init__(self, system, mix: dict, config: dict, *, seed: int, present: np.ndarray, annotate: bool,
                 hold: int = 3, hold_among: int = 32, world: ranks.World | None = None):
        self.system, self.mix = system, mix
        self.world = world or ranks.World()
        self.k_range = config["k_range"]
        self.steps = ScaleSteps(mix["scale_events"], self.k_range, mix["schedule_seed"])
        self.sources = rng(seed, 2)
        self.pool = []  # the window's SSSP sources, in the order they are taken
        self.present = present
        self.annotate = annotate
        picks = rng(seed, 4).choice(hold_among, size=min(hold, hold_among), replace=False)
        self.hold_at = set(int(i) for i in picks)  # rescale events whose pack is kept for the check
        self.held = []  # (data, k asked for) of the packs kept for the check
        self.rescales = 0
        self.k = None  # the k the last successful scale event asked for
        self.warm_items = []  # the warm-up's items: one that failed fails the run

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()

    def _sync(self) -> None:
        if self.system.device.type == "cuda":
            torch.cuda.synchronize(self.system.device)

    def source(self) -> int:
        """The next SSSP source: in the window, the next of the schedule's
        sources; in the warm-up, a vertex with an edge drawn by the run's seed."""
        if self.pool:
            return self.pool.pop()
        return int(self.present[int(self.sources.integers(self.present.shape[0]))])

    # ------------------------------------------------------------ one item
    def rescale(self, data, k_new: int, event: dict):
        event.update(kind="rescale", k_old=int(data.k), k_new=int(k_new))
        try:
            with self._span("perfbench.rescale"):
                new, stats = self.system.rescale(data, k_new)
                self._sync()
        except Exception as exc:  # a failed event counts against `failed`, and the run goes on
            if self.world.ranked:
                raise
            event.update(ok=False, error=f"{type(exc).__name__}: {exc}")
            return data
        event.update(ok=True, k_out=int(new.k), mirrors=int(new.mirrors), migrate_s=stats.elapsed_s,
                     recheck_s=stats.recheck_s, cross_bytes=stats.cross_device_bytes)
        if self.rescales in self.hold_at:
            self.held.append((new, int(k_new)))
        self.rescales += 1
        self.k = int(k_new)
        return new

    def query(self, data, kind: str, event: dict) -> None:
        source = self.source() if kind == "sssp" else 0
        event.update(kind=kind, source=source, k=int(data.k))
        try:
            with self._span(f"perfbench.{kind}"):
                answer, sweeps = self.system.query(kind, data, source)
                self._sync()
        except Exception as exc:
            if self.world.ranked:
                raise
            event.update(ok=False, error=f"{type(exc).__name__}: {exc}")
            return
        event.update(ok=True, answer=answer, sweeps=sweeps)

    # ------------------------------------------------------------ warm-up
    def warm(self, data, k0: int):
        """Every shape the mix uses, before the window: rescales from the
        first k (``k0``) to both ends of the range and back, and one query of
        each kind it sends. Their records go to ``warm_items``."""
        self.k = int(k0)
        at = self.k
        for k in (int(self.k_range[0]), int(self.k_range[1]), self.k):
            if k != at:
                data = self.rescale(data, k, ev := {})
                self.warm_items.append(ev)
                at = int(data.k)
        if float(self.mix["queries"].get("rate_per_s", 0.0)) > 0:
            for kind in sorted(self.mix["queries"]["mix"]):
                self.query(data, kind, ev := {})
                ev.pop("answer", None)
                self.warm_items.append(ev)
        self.k, self.rescales, self.held = int(k0), 0, []
        self._sync()
        return data

    # ------------------------------------------------------------ the window
    def play(self, data, seconds: float):
        """Serve the window; returns ``(final data, events, lateness_s, window_s)``."""
        events, lateness = [], []
        every = self.mix["scale_events"].get("every_s")
        with self._span("perfbench.window"):
            t0 = time.perf_counter()
            if every is None:
                done = False
                while not done:
                    ev = {"due": time.perf_counter() - t0}
                    ev["start"] = ev["due"]
                    data = self.rescale(data, self.steps.next(self.k), ev)
                    done = self.world.settle(time.perf_counter() - t0 >= seconds)
                    ev["end"] = time.perf_counter() - t0
                    events.append(ev)
            else:
                items = query_schedule(self.mix, seconds)
                items += [(every * j, "scale") for j in range(1, int(math.ceil(seconds / every)))
                          if every * j < seconds]
                items.sort(key=lambda it: (it[0], it[1] != "scale"))
                pool = sssp_sources(self.mix, self.present, sum(1 for _, kind in items if kind == "sssp"))
                self.pool = [int(v) for v in self.sources.permutation(pool)]
                late = False  # rank 0's clock read past the grace as the last item ended: none starts now
                for due, kind in items:
                    ev = {"due": due}
                    if due > time.perf_counter() - t0:
                        with self._span("perfbench.wait"):
                            wait_until(t0 + due)
                        lateness.append(time.perf_counter() - t0 - due)
                    ev["start"] = time.perf_counter() - t0
                    if late:
                        ev.update(kind=kind, ok=False, error="not started within the grace after the close")
                    elif kind == "scale":
                        data = self.rescale(data, self.steps.next(self.k), ev)
                    else:
                        self.query(data, kind, ev)
                    late = self.world.settle(late or time.perf_counter() - t0 > seconds + GRACE_S)
                    ev["end"] = time.perf_counter() - t0
                    events.append(ev)
            window_s = time.perf_counter() - t0
        return data, events, lateness, window_s
