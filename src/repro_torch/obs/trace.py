"""Span-based tracing with Chrome-trace JSON export. Port of
``repro/obs/trace.py``.

Spans are host-side wall-clock intervals around work the host has issued
(kernel launches, and whatever device sync the program itself does,
included); opening or closing one adds no sync. Nesting comes from a plain
stack: spans opened inside an open span become its children in the
exported view (Chrome trace renders containment on one track).

The export is the Trace Event Format's complete-event ("ph": "X") JSON,
loadable in Perfetto / chrome://tracing: microsecond timestamps relative
to tracer start, one pid per run, tid 0 for the main host thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class SpanRecord:
    name: str
    t_start: float          # seconds since tracer start (perf_counter)
    dur: float              # seconds
    depth: int
    args: Dict = dataclasses.field(default_factory=dict)


class _SpanCtx:
    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._depth = len(self._tracer._stack)
        self._tracer._stack.append(self)
        self._t0 = time.perf_counter() - self._tracer._p0
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter() - self._tracer._p0
        stack = self._tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer.spans.append(SpanRecord(
            self.name, self._t0, t1 - self._t0, self._depth, self.args))
        return False


class Tracer:
    def __init__(self):
        self.spans: List[SpanRecord] = []
        self._stack: List[_SpanCtx] = []
        self._p0 = time.perf_counter()
        self.t_epoch = time.time()          # wall time of tracer start

    def span(self, name: str, **args) -> _SpanCtx:
        return _SpanCtx(self, name, args)


def chrome_trace_doc(spans: List[SpanRecord],
                     process_name: str = "repro",
                     pid: int = 0) -> Dict:
    """Trace Event Format document (Perfetto/chrome://tracing-loadable)."""
    events = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }, {
        "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
        "args": {"name": "host"},
    }]
    for s in spans:
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ts": round(s.t_start * 1e6, 3),
            "dur": round(s.dur * 1e6, 3),
            "pid": pid,
            "tid": 0,
            "args": s.args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[SpanRecord],
                       process_name: str = "repro") -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace_doc(spans, process_name=process_name), f)


def load_chrome_trace(path: str) -> Optional[Dict]:
    with open(path) as f:
        return json.load(f)
