"""Metrics registry: counters, gauges, latency histograms.

The registry is the runtime's numeric observability surface (DESIGN.md §13):
per-phase latency histograms with exact p50/p90/p99 and byte counters for
device traffic (``rescale.migrate_s``, ``rescale.migrated_bytes``).

Every metric snapshots to float64 values — a scalar for counters/gauges, a
fixed-length bucket vector (+ count + sum) for histograms — so snapshots of
several processes sum: ``snapshot_global`` sums them over the ranks of a
``GraphGroup`` in one ``all_reduce``.

Histograms use fixed log-spaced bucket bounds (identical on every process,
hence summable) plus a bounded ring of exact samples: while no sample has
been dropped the percentile readout is EXACT (``np.percentile`` over the
ring); after overflow it degrades to conservative bucket-upper-bound
interpolation. Default bounds span 1 µs … 100 s, 4 buckets/decade.

``NULL`` is a no-op registry: components default to it, so uninstrumented
runs pay one attribute access per would-be observation.
"""
from __future__ import annotations

import bisect
import collections
import resource
import sys

import numpy as np

from ..launch import multihost as MH

__all__ = [
    "DEFAULT_BUCKETS",
    "BYTE_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL",
    "peak_rss_mb",
    "record_process_gauge",
    "record_peak_rss",
]

# 1e-6 … 1e2 seconds, 4 per decade: 33 bounds → 34 bucket slots (the last is
# the overflow bucket). Derived from integers, so bit-identical everywhere.
DEFAULT_BUCKETS: tuple = tuple(10.0 ** (-6 + i / 4) for i in range(33))
# 1 B … 1 GiB-ish, 2 per decade — for size distributions (spill blocks,
# transfer payloads) rather than latencies.
BYTE_BUCKETS: tuple = tuple(10.0 ** (i / 2) for i in range(19))


class Counter:
    """Monotonic accumulator (events, bytes)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar (queue depth, resident MB)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram with an exact-sample ring.

    ``observe`` is the hot call: one bisect + three scalar updates + a deque
    append. Percentiles are exact while ``total <= sample_cap`` (no ring
    eviction yet); beyond that they fall back to the bucket upper bound at
    the target rank — a conservative (never-understating) estimate.
    """

    __slots__ = ("bounds", "counts", "total", "sum", "_samples")

    def __init__(self, bounds: tuple = DEFAULT_BUCKETS, sample_cap: int = 8192):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0
        self._samples: collections.deque = collections.deque(maxlen=int(sample_cap))

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v
        self._samples.append(v)

    @property
    def exact(self) -> bool:
        """True while the sample ring still holds every observation."""
        return self.total <= self._samples.maxlen

    def percentile(self, q: float, *, window: int | None = None) -> float:
        """q-th percentile (q in [0, 100]); exact until the ring overflows,
        then the upper bucket bound at the target rank. 0.0 when empty.

        ``window`` restricts the readout to the newest ``window`` retained
        samples — the load-signal view (an autoscaler reacting to the last N
        observations, not the lifetime distribution). Always exact over what
        the ring retains: the ring evicts oldest-first, so the newest
        ``window <= sample_cap`` samples are exactly the newest ``window``
        observations once at least that many have landed."""
        if self.total == 0:
            return 0.0
        if window is not None and window > 0 and len(self._samples) > 0:
            n = min(int(window), len(self._samples))
            recent = list(self._samples)[-n:]
            return float(np.percentile(np.asarray(recent), q))
        if self.exact:
            return float(np.percentile(np.asarray(self._samples), q))
        rank = q / 100.0 * self.total
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank, side="left"))
        # Overflow bucket has no upper bound — answer the largest retained
        # sample (the best true-value witness available).
        if idx >= len(self.bounds):
            return float(max(self._samples))
        return self.bounds[idx]

    def percentiles(self) -> dict:
        return {"p50": self.percentile(50), "p90": self.percentile(90), "p99": self.percentile(99)}


class MetricsRegistry:
    """Named get-or-create store of Counters/Gauges/Histograms."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def percentiles(self, name: str) -> dict:
        return self.histogram(name).percentiles()

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Flat name → float64 value/vector view of every metric.

        Counters and gauges flatten to scalars; a histogram ``h`` flattens to
        ``h.count`` / ``h.sum`` scalars plus a ``h.buckets`` vector — every
        entry sum-aggregatable across processes."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[f"{name}.count"] = float(m.total)
                out[f"{name}.sum"] = float(m.sum)
                out[f"{name}.buckets"] = m.counts.astype(np.float64)
            else:
                out[name] = float(m.value)
        return out

    def snapshot_global(self, group) -> dict:
        """The snapshot summed over every rank of ``group`` — ONE
        ``psum_host`` collective for the whole registry (the local snapshot
        packs into a single flat float64 vector; every rank must call this
        at the same point with the same metric names/shapes)."""
        local = self.snapshot()
        parts = [np.atleast_1d(np.asarray(local[k], np.float64)) for k in sorted(local)]
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float64)
        summed = MH.psum_host(flat, group)
        out: dict = {}
        off = 0
        for k in sorted(local):
            n = np.atleast_1d(np.asarray(local[k])).shape[0]
            chunk = summed[off : off + n]
            out[k] = chunk if n > 1 else float(chunk[0])
            off += n
        return out


class _NullMetric:
    """Accepts every mutation, stores nothing. One instance serves every
    name of a NullRegistry."""

    __slots__ = ()
    value = 0.0
    total = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float, *, window: int | None = None) -> float:
        return 0.0

    def percentiles(self) -> dict:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The disabled path: every lookup answers the shared inert metric, so
    instrumentation points never branch on "is observability on"."""

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, bounds: tuple = DEFAULT_BUCKETS) -> _NullMetric:
        return _NULL_METRIC

    def names(self) -> list:
        return []

    def percentiles(self, name: str) -> dict:
        return _NULL_METRIC.percentiles()

    def snapshot(self) -> dict:
        return {}

    def snapshot_global(self, group) -> dict:
        return {}


NULL = NullRegistry()


def peak_rss_mb() -> float:
    """Peak resident-set size of THIS process in MB (ru_maxrss; kilobytes on
    Linux, bytes on macOS)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    scale = 1024.0 * 1024.0 if sys.platform == "darwin" else 1024.0
    return peak / scale


def record_process_gauge(value: float, registry, name: str, *, process_index: int, process_count: int) -> float:
    """Publish a per-process value as a process-indexed gauge family.

    Registers ``<name>.p{i}`` for EVERY process index — own index carries the
    measured value, the others zero — so the sum-aggregated global snapshot
    (``snapshot_global``'s one ``psum_host``) reads back each process's value
    individually. Each rank is one OS process, so a rank passes its group
    rank and size. Returns ``value``."""
    v = float(value)
    for i in range(int(process_count)):
        registry.gauge(f"{name}.p{i}").set(v if i == int(process_index) else 0.0)
    return v


def record_peak_rss(registry, *, process_index: int, process_count: int) -> float:
    """Surface this process's peak RSS as the ``process.peak_rss_mb.p{i}``
    process-indexed gauge family (see ``record_process_gauge``). Returns the
    measured MB."""
    return record_process_gauge(
        peak_rss_mb(), registry, "process.peak_rss_mb",
        process_index=process_index, process_count=process_count,
    )
