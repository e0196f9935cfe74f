"""Disabled telemetry. Port of ``NullTelemetry`` and ``NULL`` from
``repro/obs/telemetry.py``: every method returns a preallocated no-op, so
code instrumented for telemetry costs nothing with it off."""
from __future__ import annotations


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
    sinks: list = []

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

    def metrics_snapshot(self) -> dict:
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
