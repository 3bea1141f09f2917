"""Near-zero-overhead span tracing for the runtime (DESIGN.md §13).

A ``Tracer`` records nested host spans — ``with tracer.span("rescale.migrate")``
— into a bounded per-process ring buffer using the monotonic
``time.perf_counter`` clock. The design constraints, in order:

* **Disabled = one branch.** ``span()`` on a disabled tracer returns a shared
  no-op context manager without allocating anything; instrumented hot paths
  (per-rescale migration) pay a single attribute check.
* **Enabled = bounded.** Records are 4-tuples in a ``deque(maxlen=capacity)``
  — a long-lived serving process can trace forever without growing; the
  ``dropped`` property says how many spans the ring evicted.
* **Cross-process alignable.** Each tracer captures a paired
  (``perf_counter``, wall-clock) epoch at construction, so every process's
  spans can be placed on one absolute microsecond timeline.
* **Device-correlatable.** ``Tracer(annotate=True)`` additionally enters a
  ``torch.profiler.record_function`` range for every span, so host spans line
  up with device kernels inside a ``torch.profiler`` capture.

The phase of a span defaults to the dotted prefix of its name
(``"rescale.migrate"`` → phase ``"rescale"``).

Components take ``tracer=None`` and fall back to the module-level default
(``get_tracer()`` / ``set_tracer()``), which starts DISABLED — an
uninstrumented run records nothing and pays (almost) nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import time

__all__ = [
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
]


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span, on the tracer's ``perf_counter`` timeline."""

    name: str
    phase: str
    t0: float  # perf_counter at entry
    t1: float  # perf_counter at exit

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op context manager — what a disabled tracer's ``span()``
    returns. One instance for the whole process; no allocation per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_phase", "_t0", "_annot")

    def __init__(self, tracer: "Tracer", name: str, phase):
        self._tracer = tracer
        self._name = name
        self._phase = phase
        self._annot = None

    def __enter__(self):
        if self._tracer.annotate:
            import torch

            self._annot = torch.profiler.record_function(self._name)
            self._annot.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        self._tracer._record(self._name, self._phase, self._t0, t1)
        return False


class Tracer:
    """Bounded span recorder. See the module docstring for the contract."""

    __slots__ = ("enabled", "annotate", "_ring", "recorded", "pc0", "wall0")

    def __init__(self, capacity: int = 65536, *, enabled: bool = True, annotate: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self._ring: collections.deque = collections.deque(maxlen=int(capacity))
        self.recorded = 0  # total spans ever recorded (ring may have dropped)
        # Paired epoch: perf_counter timestamps map to absolute wall time as
        # wall0 + (t - pc0). Captured back-to-back so the pairing error is the
        # two clock reads themselves, far under trace resolution.
        self.pc0 = time.perf_counter()
        self.wall0 = time.time()

    # ------------------------------------------------------------- recording
    def span(self, name: str, phase: str | None = None):
        """Context manager timing one span. THE hot call: a disabled tracer
        answers with the shared null span after one branch."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, phase)

    def _record(self, name: str, phase, t0: float, t1: float) -> None:
        self.recorded += 1
        self._ring.append((name, phase, t0, t1))

    # -------------------------------------------------------------- readout
    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring (recorded minus retained)."""
        return self.recorded - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self) -> list[SpanRecord]:
        """Retained spans, oldest first, with phases resolved (a span's phase
        defaults to the dotted prefix of its name)."""
        return [
            SpanRecord(name, phase if phase is not None else name.split(".", 1)[0], t0, t1)
            for name, phase, t0, t1 in self._ring
        ]

    def clear(self) -> None:
        self._ring.clear()
        self.recorded = 0


# A permanently-disabled default so uninstrumented runs record nothing; its
# tiny capacity is irrelevant (a disabled tracer never touches its ring).
_DEFAULT = Tracer(capacity=1, enabled=False)
_tracer: Tracer = _DEFAULT


def get_tracer() -> Tracer:
    """The process-global tracer components fall back to when constructed
    without an explicit one."""
    return _tracer


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install (or, with None, reset) the process-global tracer; returns the
    now-active tracer."""
    global _tracer
    _tracer = tracer if tracer is not None else _DEFAULT
    return _tracer


def span(name: str, phase: str | None = None):
    """``get_tracer().span(...)`` — for module-level instrumentation points
    that have no component to hang a tracer off."""
    return _tracer.span(name, phase)
