"""Runtime observability: span tracing (``trace``) and the metrics registry (``metrics``)."""
from .trace import SpanRecord, Tracer, get_tracer, set_tracer, span  # noqa: F401
from .metrics import NULL, Counter, Gauge, Histogram, MetricsRegistry, NullRegistry  # noqa: F401
