"""Structured-log (JSONL) serialization of the controller's event stream.

Every event the elastic controller emits — ``ScaleEvent`` / ``IngestEvent`` /
``RebuildEvent`` — shares one monotonic ``seq``, so the event list IS the
total order of what happened to the runtime. This module turns it into one
JSON object per line (and back), which is what lets bench runs and the
multi-process acceptance harness diff event logs TEXTUALLY:

* ``events_jsonl(events)`` — one line per event in list order, keys sorted,
  an ``"event"`` field carrying the dataclass name.
* ``drop_timings=True`` zeroes every wall-clock field (``*_s`` floats):
  per-process timings are the only nondeterministic event content on a
  deterministic-replica run, so with them zeroed two processes' logs must be
  byte-identical — the harness asserts exactly that.
* ``events_from_jsonl`` round-trips back to the frozen dataclasses
  (tuple-valued fields restored), so a persisted log replays as first-class
  events.
"""
from __future__ import annotations

import dataclasses
import json

__all__ = ["event_to_dict", "event_from_dict", "events_jsonl", "events_from_jsonl"]


def _event_types() -> dict:
    # Imported lazily: controller imports obs.log inside its own method, so a
    # module-level import here would be a cycle.
    from ..elastic import controller as C

    return {
        "ScaleEvent": C.ScaleEvent,
        "IngestEvent": C.IngestEvent,
        "RebuildEvent": C.RebuildEvent,
        "FailureEvent": C.FailureEvent,
    }


def event_to_dict(ev, *, drop_timings: bool = False) -> dict:
    """Plain-JSON dict of one event; ``drop_timings`` zeroes the wall-clock
    (``*_s``) fields — see the module docstring."""
    d = dataclasses.asdict(ev)
    d["event"] = type(ev).__name__
    if drop_timings:
        for k, v in d.items():
            if k.endswith("_s") and isinstance(v, float):
                d[k] = 0.0
    if "lost_hosts" in d:
        d["lost_hosts"] = list(d["lost_hosts"])
    return d


def event_from_dict(d: dict):
    """Inverse of ``event_to_dict`` — reconstructs the frozen dataclass."""
    d = dict(d)
    name = d.pop("event")
    types = _event_types()
    if name not in types:
        raise ValueError(f"unknown event type {name!r}")
    if "lost_hosts" in d:
        d["lost_hosts"] = tuple(d["lost_hosts"])
    return types[name](**d)


def events_jsonl(events, *, drop_timings: bool = False) -> str:
    """One sorted-key JSON object per line, in list (= seq) order."""
    return "\n".join(
        json.dumps(event_to_dict(ev, drop_timings=drop_timings), sort_keys=True)
        for ev in events
    )


def events_from_jsonl(text: str) -> list:
    return [event_from_dict(json.loads(line)) for line in text.splitlines() if line.strip()]
