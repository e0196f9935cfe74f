"""Deterministic event-driven simulation for asynchronous federation.

Copy of ``repro/fl/runtime/events.py`` (host-only numpy): for the same
seeds every decision equals the reference's.

Two layers live here:

``EventHeap``
    A virtual-clock priority queue ordered by ``(time, seq)`` with a
    monotonically assigned sequence number, so ties break identically on
    every replay. Entries are JSON-serializable dicts — the async engine
    checkpoints the heap (buffer + event clock, never wall time) and a
    restored heap pops in exactly the original order, which is what makes
    kill-and-resume bitwise.

``simulate_sync_utilization`` / ``simulate_async_utilization``
    Pure event simulators over ``ClientPopulation``'s device tiers +
    diurnal availability at up to 10^6 logical clients. No gradients are
    computed — only the *shape* of the traffic: per-dispatch compute and
    uplink durations from the population's two-part latency model, and the
    server's aggregation policy (deadline cutoff vs FedBuff buffer). They
    measure what the round-synchronous engine throws away: a straggler past
    the reporting deadline has burned its full local epoch, but its update
    never lands. The async buffer banks that same update into the next
    aggregation instead, so useful-compute utilization approaches 1.

All randomness is drawn through stateless ``SeedSequence`` keys per
(client, dispatch) — the same pattern as ``population._rng`` — so both
simulators replay bit-identically from any point.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.fl.runtime.population import ClientPopulation, _rng

# entropy tags for the simulators' draws (disjoint from population/faults)
_T_PICK, _T_DROP = 0xA51C, 0xA5D0


class EventHeap:
    """Virtual-clock event queue with deterministic (time, seq) ordering.

    ``push`` assigns each entry the next sequence number, so two events at
    the same virtual time pop in insertion order — heapq never compares the
    payloads themselves. ``snapshot``/``restore`` round-trip the full queue
    (including the seq counter) through JSON-able structures.
    """

    def __init__(self):
        self._heap: List[tuple] = []
        self._next_seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, payload: Dict[str, Any]) -> int:
        seq = self._next_seq
        self._next_seq += 1
        heapq.heappush(self._heap, (float(time), seq, payload))
        return seq

    def pop(self):
        """-> (time, seq, payload) of the earliest event."""
        return heapq.heappop(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def snapshot(self) -> Dict[str, Any]:
        entries = [{"t": t, "seq": s, "payload": p}
                   for t, s, p in sorted(self._heap, key=lambda e: e[:2])]
        return {"next_seq": self._next_seq, "entries": entries}

    @classmethod
    def restore(cls, snap: Dict[str, Any]) -> "EventHeap":
        out = cls()
        out._next_seq = int(snap["next_seq"])
        out._heap = [(float(e["t"]), int(e["seq"]), e["payload"])
                     for e in snap["entries"]]
        heapq.heapify(out._heap)
        return out


def sample_available(pop: ClientPopulation, tick: int, draw: int,
                     seed: int, max_probe: int = 64) -> int:
    """One available client id, rejection-sampled from the population at
    diurnal tick ``tick``. Deterministic in (seed, tick, draw); falls back
    to the last probe when the window is (nearly) empty so dispatch never
    stalls."""
    rng = _rng(seed, _T_PICK, tick, draw)
    cand = 0
    for _ in range(max_probe):
        cand = int(rng.integers(0, pop.n_clients))
        if pop.available(cand, tick):
            return cand
    return cand


@dataclasses.dataclass
class UtilizationReport:
    """What one simulated policy did with the fleet's compute."""
    mode: str                     # 'sync' | 'async'
    n_clients: int
    updates_applied: int          # updates that reached an aggregation
    updates_discarded: int        # computed but thrown away
    server_steps: int
    useful_compute_s: float       # Σ compute of applied updates
    total_compute_s: float        # Σ compute of every dispatched client
    sim_wall_s: float             # virtual seconds of server wall clock
    staleness_mean: float = 0.0
    staleness_max: int = 0

    @property
    def utilization(self) -> float:
        return self.useful_compute_s / max(self.total_compute_s, 1e-12)

    def to_doc(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["utilization"] = self.utilization
        d["updates_per_sim_hour"] = (
            3600.0 * self.updates_applied / max(self.sim_wall_s, 1e-12))
        return d


def simulate_sync_utilization(pop: ClientPopulation, *, cohort: int,
                              rounds: int, over_select: float = 1.25,
                              deadline_quantile: float = 0.9,
                              dropout_rate: float = 0.0,
                              work_s: float = 60.0,
                              seed: int = 0) -> UtilizationReport:
    """Round-synchronous policy: every round over-selects an available
    cohort, waits until the reporting deadline (a quantile of THIS cohort's
    completion times, mirroring ``CohortScheduler``'s cutoff), and discards
    every straggler's fully-computed update. Wall clock advances to the
    deadline whenever anyone was cut, else to the slowest survivor."""
    useful = total = wall = 0.0
    applied = discarded = 0
    target = int(math.ceil(cohort * over_select))
    for r in range(rounds):
        ids = [sample_available(pop, r, d, seed) for d in range(target)]
        comp = np.asarray([pop.compute_seconds(c, r, work_s) for c in ids])
        fin = comp + np.asarray([pop.uplink_seconds(c, r) for c in ids])
        deadline = float(np.quantile(fin, deadline_quantile))
        keep = fin <= deadline
        if dropout_rate > 0.0:
            keep &= _rng(seed, _T_DROP, r).random(len(ids)) >= dropout_rate
        total += float(comp.sum())
        useful += float(comp[keep].sum())
        applied += int(keep.sum())
        discarded += int((~keep).sum())
        wall += deadline if not keep.all() else float(fin.max())
    return UtilizationReport(
        mode="sync", n_clients=pop.n_clients, updates_applied=applied,
        updates_discarded=discarded, server_steps=rounds,
        useful_compute_s=useful, total_compute_s=total, sim_wall_s=wall)


def simulate_async_utilization(pop: ClientPopulation, *, concurrency: int,
                               buffer_size: int, server_steps: int,
                               dropout_rate: float = 0.0,
                               work_s: float = 60.0, seed: int = 0,
                               max_staleness: Optional[int] = None
                               ) -> UtilizationReport:
    """FedBuff policy: keep ``concurrency`` clients in flight; every
    arrival lands in the buffer (stragglers included — their work is merely
    STALE, not discarded); each ``buffer_size`` validated arrivals trigger a
    server step. Only dropouts and beyond-``max_staleness`` arrivals waste
    compute."""
    heap = EventHeap()
    clock = 0.0
    version = 0
    dispatched = 0
    buffered = 0
    useful = total = 0.0
    applied = discarded = 0
    staleness: List[int] = []

    def dispatch():
        nonlocal dispatched
        d = dispatched
        dispatched += 1
        tick = int(clock // max(work_s, 1e-9))
        cid = sample_available(pop, tick, d, seed)
        comp = pop.compute_seconds(cid, d, work_s)
        up = pop.uplink_seconds(cid, d)
        lost = (dropout_rate > 0.0 and
                _rng(seed, _T_DROP, cid, d).random() < dropout_rate)
        heap.push(clock + comp + up,
                  {"dispatch_version": version, "compute_s": comp,
                   "lost": lost})

    while version < server_steps:
        while len(heap) < concurrency:
            dispatch()
        clock, _, ev = heap.pop()
        # compute is accounted when the work has actually happened (at
        # arrival), so in-flight work at termination never skews the ratio
        total += float(ev["compute_s"])
        s = version - int(ev["dispatch_version"])
        if ev["lost"] or (max_staleness is not None and s > max_staleness):
            discarded += 1
            continue
        staleness.append(s)
        useful += float(ev["compute_s"])
        applied += 1
        buffered += 1
        if buffered >= buffer_size:
            buffered = 0
            version += 1
    return UtilizationReport(
        mode="async", n_clients=pop.n_clients, updates_applied=applied,
        updates_discarded=discarded, server_steps=version,
        useful_compute_s=useful, total_compute_s=total, sim_wall_s=clock,
        staleness_mean=float(np.mean(staleness)) if staleness else 0.0,
        staleness_max=int(np.max(staleness)) if staleness else 0)
