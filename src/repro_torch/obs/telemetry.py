"""The telemetry facade: one object per run, threaded through the three
workloads (train / federate / serve). Port of ``repro/obs/telemetry.py``.

Contract (the whole point of the design):

* ALL recording is host-side, on values the program has already returned.
  ``Telemetry`` is never an input of a computation, so telemetry on leaves
  every result, kernel launch and route bitwise as with it off
  (tests/test_torch_telemetry.py; on the card, chip_smoke phases 7 and 8).
  A CUDA value is copied to the host (``.item()``, ``.tolist()``) only
  after the program has computed it: the copy waits for it, and never
  recomputes or changes it.
* Telemetry-off is ``NULL`` — a singleton whose instruments and spans are
  preallocated no-ops: a disabled hot loop does zero per-step allocation
  (``NULL.span(...)`` and ``NULL.counter(...)`` return module-level
  singletons; ``inc``/``observe``/``__enter__`` are empty methods).

Usage:

    tel = Telemetry(run_id="fed-0", sinks=[JSONLSink("run.jsonl")])
    c = tel.counter("fl.bytes_up")          # handle, create once
    with tel.span("fl.round", round=3):
        ...                                 # host work incl. kernel launches
    c.add(report.bytes_up)
    tel.event("round", round=3, loss=float(metrics["loss"]))
    tel.export_chrome_trace("trace.json")   # Perfetto-loadable
    tel.close()                             # final metrics snapshot event
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.sinks import (
    InMemorySink,
    JSONLSink,
    PrometheusTextfileSink,
    Sink,
)
from repro_torch.obs.trace import Tracer, write_chrome_trace


def _jsonable(v):
    """Coerce torch tensors, numpy scalars and containers to plain JSON
    types: a 0-d tensor through ``.item()``, any other through
    ``.tolist()`` (bf16 included). Conversion happens on HOST copies of
    already-computed values — it can wait for the device, never a
    recompute or a numeric change."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.Tensor):
        return _jsonable(v.item() if v.ndim == 0 else v.tolist())
    if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
        try:
            return _jsonable(v.item())
        except Exception:
            return str(v)
    if hasattr(v, "tolist"):
        return _jsonable(v.tolist())
    return str(v)


class _NullInstrument:
    """Counter/gauge/histogram no-op, one shared instance."""
    __slots__ = ()
    name = "null"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    add = inc

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot(self):
        return None


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_INSTRUMENT = _NullInstrument()
_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """Disabled telemetry: every method returns a preallocated no-op."""
    enabled = False
    run_id = None
    sinks: List[Sink] = []

    def counter(self, name: str):
        return _NULL_INSTRUMENT

    def gauge(self, name: str):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=None):
        return _NULL_INSTRUMENT

    def span(self, name: str, **args):
        return _NULL_SPAN

    def event(self, kind: str, **fields) -> None:
        pass

    def now(self) -> float:
        return 0.0

    def metrics_snapshot(self) -> Dict:
        return {}

    def emit_metrics(self) -> None:
        pass

    def export_chrome_trace(self, path: str) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullTelemetry()


class Telemetry:
    enabled = True

    def __init__(self, run_id: Optional[str] = None,
                 sinks: Sequence[Sink] = (), workload: Optional[str] = None):
        self.run_id = run_id or f"run-{int(time.time() * 1e3):x}"
        self.registry = MetricsRegistry()
        self.tracer = Tracer()
        self.sinks = list(sinks)
        for s in self.sinks:
            if isinstance(s, PrometheusTextfileSink):
                s.bind_registry(self.registry)
        self._closed = False
        if workload:
            self.event("run_meta", workload=workload)

    # -- instruments ---------------------------------------------------------

    def counter(self, name: str):
        return self.registry.counter(name)

    def gauge(self, name: str):
        return self.registry.gauge(name)

    def histogram(self, name: str, buckets=None):
        return self.registry.histogram(name, buckets)

    # -- spans / events ------------------------------------------------------

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def now(self) -> float:
        return time.perf_counter()

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "run_id": self.run_id, "kind": kind}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        for s in self.sinks:
            s.emit(rec)

    def metrics_snapshot(self) -> Dict:
        return self.registry.snapshot()

    def emit_metrics(self) -> None:
        self.event("metrics", metrics=self.metrics_snapshot())

    # -- lifecycle -----------------------------------------------------------

    def export_chrome_trace(self, path: str) -> None:
        write_chrome_trace(path, self.tracer.spans,
                           process_name=self.run_id)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        """Emit the final metrics snapshot and close every sink. Idempotent
        (runs that crash mid-way may close twice via finally blocks)."""
        if self._closed:
            return
        self._closed = True
        self.emit_metrics()
        for s in self.sinks:
            s.close()


def make_telemetry(jsonl: Optional[str] = None,
                   prometheus: Optional[str] = None,
                   in_memory: bool = False,
                   run_id: Optional[str] = None,
                   workload: Optional[str] = None):
    """Convenience constructor used by the launch CLIs. Returns ``NULL``
    when no sink is requested — callers hold one object either way."""
    sinks: List[Sink] = []
    if jsonl:
        sinks.append(JSONLSink(jsonl))
    if prometheus:
        sinks.append(PrometheusTextfileSink(prometheus))
    if in_memory:
        sinks.append(InMemorySink())
    if not sinks:
        return NULL
    return Telemetry(run_id=run_id, sinks=sinks, workload=workload)
