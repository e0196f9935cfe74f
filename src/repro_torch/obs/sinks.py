"""Pluggable event sinks. Port of ``repro/obs/sinks.py``.

Every telemetry event is one flat-ish JSON-safe dict with at least
``ts`` (unix seconds), ``run_id`` and ``kind``. Sinks receive events as
they are emitted:

  JSONLSink              append-only JSON-lines file — the exportable run
                         artifact ``repro_torch.obs.report`` renders
                         (the reference's schema check accepts it)
  PrometheusTextfileSink writes a metrics exposition snapshot on flush
                         (node-exporter textfile-collector format)
  InMemorySink           list of events, for tests and benches
"""
from __future__ import annotations

import json
import os
from typing import Dict, List


class Sink:
    def emit(self, event: Dict) -> None:     # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class InMemorySink(Sink):
    def __init__(self):
        self.events: List[Dict] = []

    def emit(self, event: Dict) -> None:
        self.events.append(event)

    def by_kind(self, kind: str) -> List[Dict]:
        return [e for e in self.events if e.get("kind") == kind]


class JSONLSink(Sink):
    """One JSON object per line, flushed per event (the run artifact must
    survive a crashed run — partial logs are still loadable)."""

    def __init__(self, path: str):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "w")

    def emit(self, event: Dict) -> None:
        self._f.write(json.dumps(event, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class PrometheusTextfileSink(Sink):
    """Metrics snapshot in Prometheus exposition format. Events pass
    through untouched; ``flush``/``close`` (called by ``Telemetry``)
    rewrite the textfile from the registry's current state."""

    def __init__(self, path: str):
        self.path = str(path)
        self._registry = None

    def bind_registry(self, registry) -> None:
        self._registry = registry

    def emit(self, event: Dict) -> None:
        pass

    def flush(self) -> None:
        if self._registry is None:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "w") as f:
            f.write(self._registry.prometheus_text())
