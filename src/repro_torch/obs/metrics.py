"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.
Port of ``repro/obs/metrics.py``.

Instruments are plain Python objects mutated on values the program has
already returned: nothing here launches a kernel or feeds a computation,
which is the subsystem's core contract (telemetry on leaves every result,
kernel launch and route bitwise as with it off; tests/test_torch_telemetry).

Histograms use fixed buckets (Prometheus-style cumulative-le semantics)
so percentile queries are O(buckets) with bounded memory no matter how
many observations arrive: p50/p95/p99 are estimated by linear
interpolation inside the bucket containing the target rank — exact when
observations are unique bucket edges, conservative otherwise.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

# default latency buckets (seconds): 100us .. 100s, ~log-spaced. Wide
# enough for a CPU decode step and a full federation round.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)
# default byte-size buckets: 64B .. 4GiB, power-of-4 spaced
DEFAULT_BYTES_BUCKETS: Tuple[float, ...] = tuple(
    float(64 * 4 ** i) for i in range(14))


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    add = inc

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-set value."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram with cumulative-le counts.

    ``buckets`` are upper edges; an implicit +inf bucket catches the
    overflow. ``percentile(q)`` walks the cumulative counts to the bucket
    holding rank q and interpolates linearly between its edges (the lowest
    edge interpolates from ``min``, the overflow bucket reports ``max``).
    """
    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        bs = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)   # last = +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        lo, hi = 0, len(self.buckets)
        while lo < hi:                       # first edge >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """q in [0, 1]."""
        if not self.count:
            return float("nan")
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i == len(self.buckets):          # overflow bucket
                    return self.max
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i else min(self.min, hi)
                frac = (rank - prev_cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                # never report outside the observed range
                return max(self.min, min(self.max, est))
        return self.max

    def snapshot(self) -> Dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean if self.count else None,
            "p50": self.percentile(0.50) if self.count else None,
            "p95": self.percentile(0.95) if self.count else None,
            "p99": self.percentile(0.99) if self.count else None,
        }


class MetricsRegistry:
    """Name -> instrument, get-or-create. Creating the same name twice
    returns the same object (instrument handles are cached by callers at
    init time; re-lookup must not fork the series)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, buckets)
            return self._histograms[name]

    def snapshot(self) -> Dict:
        return {
            "counters": {n: c.snapshot() for n, c in self._counters.items()},
            "gauges": {n: g.snapshot() for n, g in self._gauges.items()
                       if g.value == g.value},      # skip never-set NaN
            "histograms": {n: h.snapshot()
                           for n, h in self._histograms.items()},
        }

    def prometheus_text(self) -> str:
        """Prometheus textfile-collector exposition (one snapshot)."""
        def esc(name):
            return name.replace(".", "_").replace("-", "_")

        lines = []
        for n, c in sorted(self._counters.items()):
            lines.append(f"# TYPE {esc(n)} counter")
            lines.append(f"{esc(n)} {c.value}")
        for n, g in sorted(self._gauges.items()):
            if g.value != g.value:
                continue
            lines.append(f"# TYPE {esc(n)} gauge")
            lines.append(f"{esc(n)} {g.value}")
        for n, h in sorted(self._histograms.items()):
            base = esc(n)
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for edge, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{base}_bucket{{le="{edge}"}} {cum}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{base}_sum {h.sum}")
            lines.append(f"{base}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")
