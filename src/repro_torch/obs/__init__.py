"""Unified telemetry of the port: metrics registry, span tracing, sinks,
memory probes, and the run-artifact report CLI
(``python -m repro_torch.obs.report``). Port of ``repro/obs``, less the
reference's static HLO memory model (``modeled_peak_bytes``,
``modeled_peak_of``).

Everything records host-side on already-returned values: telemetry-on is
bitwise telemetry-off in every result, kernel launch and route;
telemetry-off (``NULL``) is a preallocated no-op object. See
``obs/telemetry.py``.
"""
from repro_torch.obs.memory import (
    MemoryProbe,
    device_memory_stats,
    live_array_bytes,
)
from repro_torch.obs.metrics import (
    DEFAULT_BYTES_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.sinks import (
    InMemorySink,
    JSONLSink,
    PrometheusTextfileSink,
    Sink,
)
from repro_torch.obs.telemetry import NULL, NullTelemetry, Telemetry, make_telemetry
from repro_torch.obs.trace import (
    SpanRecord,
    Tracer,
    chrome_trace_doc,
    load_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "NULL", "NullTelemetry", "Telemetry", "make_telemetry",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_BYTES_BUCKETS",
    "Sink", "JSONLSink", "InMemorySink", "PrometheusTextfileSink",
    "SpanRecord", "Tracer", "chrome_trace_doc", "write_chrome_trace",
    "load_chrome_trace",
    "MemoryProbe", "live_array_bytes", "device_memory_stats",
]
