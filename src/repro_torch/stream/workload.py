"""Open-loop query workload: deterministic bursty + diurnal arrival process.

The serving benchmark needs a traffic model, not just an update stream: an
OPEN-loop arrival process (arrivals don't wait for completions — the
millions-of-users regime, where load is exogenous) whose intensity moves
enough to exercise the autoscaler in both directions. ``OpenLoopWorkload``
composes three deterministic factors per tick:

* a **diurnal ramp** — one sinusoid period over ``day_ticks``, swinging the
  base rate by ``diurnal_amp`` (the scale-out morning and scale-in night);
* **bursts** — every ``burst_every``-th tick multiplies the rate by
  ``burst_factor`` (flash crowds; what hysteresis must NOT chase);
* **hash jitter** — ±``jitter`` of the tick's rate, drawn from the same
  stateless splitmix hash the update stream uses.

Everything is a pure function of (seed, tick) via ``core.baselines.mix_hash``
— the SyntheticStream contract — so any process replays the identical
workload: same arrival counts, same query kinds, same SSSP sources. No RNG
state, no wall clock; the serve loop supplies its own (virtual) timeline.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.baselines import mix_hash

__all__ = ["OpenLoopWorkload", "QueryArrival"]


@dataclasses.dataclass(frozen=True)
class QueryArrival:
    """One query landing in the serve queue: what to run, against whom."""

    tick: int  # arrival tick (the open-loop timeline index)
    kind: str  # "pagerank" | "sssp" | "wcc"
    source: int  # SSSP source vertex (hash-drawn; ignored by other kinds)


class OpenLoopWorkload:
    """Deterministic open-loop arrival generator.

    ``arrivals(t)`` returns the queries landing during tick ``t`` — a pure
    function of (seed, t), so ticks may be generated in any order or by any
    process. ``rate(t)`` exposes the modeled intensity (queries/tick, before
    integer rounding) for plots and assertions.
    """

    def __init__(
        self,
        *,
        num_vertices: int,
        base_rate: float = 4.0,
        day_ticks: int = 64,
        diurnal_amp: float = 0.75,
        burst_every: int = 0,
        burst_factor: float = 4.0,
        burst_len: int = 1,
        jitter: float = 0.25,
        mix: tuple = (("pagerank", 2), ("sssp", 5), ("wcc", 3)),
        seed: int = 0,
    ):
        if base_rate < 0:
            raise ValueError("base_rate must be >= 0")
        if day_ticks < 1:
            raise ValueError("day_ticks must be >= 1")
        if not 0.0 <= diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")
        if burst_every < 0 or burst_factor < 1.0 or burst_len < 1:
            raise ValueError("burst_every >= 0, burst_factor >= 1, burst_len >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        weights = [int(w) for _, w in mix]
        if not mix or any(w < 0 for w in weights) or sum(weights) == 0:
            raise ValueError("mix must carry at least one positive weight")
        self.num_vertices = int(num_vertices)
        self.base_rate = float(base_rate)
        self.day_ticks = int(day_ticks)
        self.diurnal_amp = float(diurnal_amp)
        self.burst_every = int(burst_every)
        self.burst_factor = float(burst_factor)
        self.burst_len = int(burst_len)
        self.jitter = float(jitter)
        self.seed = int(seed)
        # Flatten the kind mix into a weight-replicated pick table: a single
        # hash mod len(table) draws the kind with the configured odds.
        self._kinds: tuple = tuple(k for k, w in mix for _ in range(int(w)))

    # ------------------------------------------------------------------ model
    def is_burst(self, t: int) -> bool:
        """Ticks ``[n*burst_every, n*burst_every + burst_len)`` for n >= 1 are
        burst ticks — a pure function of the index, like SyntheticStream's."""
        if self.burst_every <= 0:
            return False
        return t >= self.burst_every and (t % self.burst_every) < self.burst_len

    def rate(self, t: int) -> float:
        """Modeled arrival intensity at tick ``t`` (queries/tick, fractional).

        base × diurnal sinusoid × burst multiplier × hash jitter. The
        sinusoid starts at the trough (tick 0 = deepest night) so a workload
        opens calm, ramps through the day, and falls back — one scale-out and
        one scale-in per day by construction.
        """
        phase = 2.0 * math.pi * (t % self.day_ticks) / self.day_ticks
        diurnal = 1.0 - self.diurnal_amp * math.cos(phase)
        r = self.base_rate * diurnal
        if self.is_burst(t):
            r *= self.burst_factor
        if self.jitter > 0.0:
            h = int(mix_hash(self.seed, t, 0, 11)) % 10_000
            r *= 1.0 + self.jitter * (h / 5_000.0 - 1.0)  # ±jitter, hash-drawn
        return r

    def count(self, t: int) -> int:
        """Integer arrivals during tick ``t``: floor(rate) plus one more with
        probability frac(rate), decided by hash — so the long-run mean equals
        the modeled rate without any RNG state."""
        r = self.rate(t)
        n = int(r)
        frac = r - n
        if frac > 0.0 and (int(mix_hash(self.seed, t, 1, 13)) % 10_000) < frac * 10_000:
            n += 1
        return n

    # ------------------------------------------------------------------- api
    def arrivals(self, t: int) -> list:
        """The queries landing during tick ``t`` (possibly empty)."""
        out = []
        for i in range(self.count(t)):
            h = int(mix_hash(self.seed, t, i, 17))
            kind = self._kinds[h % len(self._kinds)]
            source = int(mix_hash(self.seed, t, i, 19)) % max(1, self.num_vertices)
            out.append(QueryArrival(tick=int(t), kind=kind, source=source))
        return out
