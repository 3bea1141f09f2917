"""Chrome-trace / Perfetto JSON export for ``obs.trace`` span rings.

The exported object is the Trace Event Format's JSON-object flavor:
``{"traceEvents": [...], "displayTimeUnit": "ms", ...}`` where every span is
a complete ("X") event and metadata ("M") events name the tracks:

* **pid** = the runtime process index (the rank of a ``GraphGroup`` over
  several processes; the caller passes it), named via a ``process_name``
  metadata event.
* **tid** = one track per span *phase* (the dotted prefix of the span name by
  default: ``ingest`` / ``rung`` / ``rebuild`` / ``rescale`` / ``transfer``),
  named via ``thread_name`` metadata events, so a merged multi-process trace
  renders as process → phase swimlanes.
* **ts / dur** in microseconds, on the ABSOLUTE wall timeline reconstructed
  from the tracer's paired (perf_counter, wall) epoch — which is what makes
  fragments from different processes line up when ``merge_traces`` puts them
  side by side. ``merge_traces`` rebases the merged events to the earliest
  timestamp so viewers don't start at epoch-scale offsets.

``validate_chrome_trace`` is the well-formedness check of a trace artifact
(``chip_smoke.py`` runs it over the control plane's trace): structural
problems come back as a list of strings, empty = well formed.
"""
from __future__ import annotations

import json

from .trace import Tracer

__all__ = [
    "chrome_trace",
    "merge_traces",
    "write_chrome_trace",
    "validate_chrome_trace",
]


def chrome_trace(tracer: Tracer, *, process: int = 0, process_name: str | None = None) -> dict:
    """Export one tracer's retained spans as a Chrome-trace JSON object.

    ``process`` becomes the pid of every event (pass the rank on a group of
    several processes). Timestamps are absolute wall microseconds —
    fragments exported by different processes merge without any clock
    negotiation beyond the hosts' own wall clocks (adequate for localhost
    clusters; a real deployment would NTP-discipline them anyway).
    """
    spans = tracer.spans()
    phases = sorted({s.phase for s in spans})
    tid_of = {ph: i for i, ph in enumerate(phases)}
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": process,
            "tid": 0,
            "args": {"name": process_name or f"proc {process}"},
        }
    ]
    for ph, tid in tid_of.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": process,
                "tid": tid,
                "args": {"name": ph},
            }
        )
    base_us = (tracer.wall0 - tracer.pc0) * 1e6
    for s in spans:
        events.append(
            {
                "name": s.name,
                "cat": s.phase,
                "ph": "X",
                "pid": process,
                "tid": tid_of[s.phase],
                "ts": base_us + s.t0 * 1e6,
                "dur": (s.t1 - s.t0) * 1e6,
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "process": process,
            "spans_recorded": tracer.recorded,
            "spans_dropped": tracer.dropped,
        },
    }


def merge_traces(traces: list[dict]) -> dict:
    """Merge per-process trace fragments into ONE trace object.

    Events concatenate as-is (each fragment already carries its own pid);
    timestamps — absolute wall µs per ``chrome_trace`` — are rebased to the
    earliest "X" event across all fragments, preserving the cross-process
    alignment while keeping the viewer's time origin at ~0."""
    events: list[dict] = []
    other: dict = {}
    for tr in traces:
        events.extend(tr.get("traceEvents", []))
        meta = tr.get("otherData", {})
        proc = meta.get("process", "?")
        for k, v in meta.items():
            other[f"p{proc}.{k}"] = v
    ts0 = min((e["ts"] for e in events if e.get("ph") == "X"), default=0.0)
    rebased = [
        dict(e, ts=e["ts"] - ts0) if e.get("ph") == "X" else e for e in events
    ]
    return {"traceEvents": rebased, "displayTimeUnit": "ms", "otherData": other}


def write_chrome_trace(path: str, trace: dict) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)


def validate_chrome_trace(trace) -> list[str]:
    """Structural well-formedness problems of a trace object (empty list =
    valid). Checks what a viewer — and the CI gate — actually needs: a
    non-empty ``traceEvents`` list whose "X" events carry name/pid/tid and
    non-negative numeric ts/dur."""
    problems: list[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    complete = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in e:
                problems.append(f"event {i}: missing {key}")
        if ph == "X":
            complete += 1
            for key in ("ts", "dur"):
                v = e.get(key)
                if not isinstance(v, (int, float)):
                    problems.append(f"event {i}: {key} missing or non-numeric")
                elif key == "dur" and v < 0:
                    problems.append(f"event {i}: negative dur {v}")
    if complete == 0:
        problems.append("no complete ('X') span events")
    return problems
