"""Runtime observability: span tracing, metrics, trace export, event logs.

* ``trace``        — near-zero-overhead nested span recording into bounded
                     per-process rings (disabled = a single branch).
* ``trace_export`` — Chrome-trace/Perfetto JSON with one track per
                     process × phase; per-process fragments merge into one
                     aligned timeline.
* ``metrics``      — counters / gauges / fixed-bucket latency histograms
                     with exact p50/p90/p99, and a ``snapshot_global`` that
                     sums the whole registry over a ``GraphGroup``'s ranks in
                     one ``all_reduce``.
* ``log``          — the controller event stream as diffable JSONL.
"""
from .trace import SpanRecord, Tracer, get_tracer, set_tracer, span  # noqa: F401
from .metrics import (  # noqa: F401
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    peak_rss_mb,
    read_peak_rss,
    record_peak_rss,
    record_process_gauge,
)
from .trace_export import (  # noqa: F401
    chrome_trace,
    merge_traces,
    validate_chrome_trace,
    write_chrome_trace,
)
from .log import events_from_jsonl, events_jsonl  # noqa: F401
