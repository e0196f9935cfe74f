"""Client population + cohort scheduling for the federation runtime.

Copy of ``repro/fl/runtime/population.py`` (host-only numpy); the unit
mask comes from the port's ``core/assignment`` as a numpy array.

``ClientPopulation`` models millions of *logical* clients over a finite
labelled dataset without materializing anything per client up front:

  * data shard    — lazily materialized on first touch: client c draws its
                    class mixture from Dir(alpha) with an rng seeded by
                    (seed, c), then samples its shard from the global
                    per-class pools (the Hsu et al. protocol the paper cites,
                    evaluated pointwise instead of as a global partition).
                    An LRU cache bounds resident shards.
  * device tier   — commodity-edge heterogeneity (Chen et al. 2025 style):
                    each client hashes into a tier with a compute-speed
                    multiplier; per-round latency adds lognormal jitter.
  * availability  — a deterministic diurnal trace: each client has a phase
                    offset and sinusoidal availability rate over rounds.

``CohortScheduler`` turns a population into per-round ``CohortPlan``s:
over-select ``ceil(cohort_size * over_select)`` available clients, build the
cyclic unit assignment over the selected cohort, and mark stragglers
(simulated latency beyond the deadline) and mid-round dropouts. Dropped
clients still *compute* in the simulator but their updates never arrive —
the engine re-averages each unit with corrected counts (which the fixed-M
``client_counts`` of the in-process step cannot express).

Everything is deterministic in (seed, client_id, round_idx) — the same plan
is produced on replay, which is what makes dropout-corrected aggregation
testable against an explicit re-run with the dropped client excluded.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.assignment import assignment_matrix
from repro_torch.fl.runtime.messages import TaskAssignment


def _rng(*entropy) -> np.random.Generator:
    """Deterministic per-key generator (order-sensitive integer entropy)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(e) & 0x7FFFFFFF for e in entropy]))


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    name: str
    flops_scale: float       # relative client compute speed
    base_latency: float      # mean round-trip seconds at scale 1.0
    crash_scale: float = 1.0  # multiplier on the FaultInjector's crash rate


DEFAULT_TIERS: Tuple[DeviceTier, ...] = (
    DeviceTier("hi_end_phone", 1.0, 4.0, crash_scale=0.5),
    DeviceTier("mid_phone", 0.5, 8.0, crash_scale=1.0),
    DeviceTier("iot_board", 0.2, 20.0, crash_scale=2.5),
)
DEFAULT_TIER_PROBS: Tuple[float, ...] = (0.3, 0.5, 0.2)


class ClientPopulation:
    """Logical clients over (x, y); shards materialize lazily."""

    def __init__(self, x: np.ndarray, y: np.ndarray, n_clients: int,
                 alpha: float = 0.1, seed: int = 0, shard_size: int = 64,
                 cache_size: int = 4096,
                 tiers: Sequence[DeviceTier] = DEFAULT_TIERS,
                 tier_probs: Sequence[float] = DEFAULT_TIER_PROBS,
                 avail_base: float = 0.7, avail_swing: float = 0.25,
                 avail_period: int = 48):
        self.x, self.y = x, np.asarray(y)
        self.n_clients = int(n_clients)
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.shard_size = int(shard_size)
        self.tiers = tuple(tiers)
        self.tier_probs = np.asarray(tier_probs, np.float64)
        self.tier_probs = self.tier_probs / self.tier_probs.sum()
        self.avail_base = avail_base
        self.avail_swing = avail_swing
        self.avail_period = avail_period
        n_classes = int(self.y.max()) + 1
        self._class_pools = [np.flatnonzero(self.y == c)
                             for c in range(n_classes)]
        self._shards: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_size = int(cache_size)

    # -- data ---------------------------------------------------------------

    def shard(self, client_id: int) -> np.ndarray:
        """Indices of this client's (lazily materialized) Dirichlet shard."""
        cid = int(client_id)
        if cid in self._shards:
            self._shards.move_to_end(cid)
            return self._shards[cid]
        rng = _rng(self.seed, 0xD1A, cid)
        p = rng.dirichlet(np.full(len(self._class_pools), self.alpha))
        counts = rng.multinomial(self.shard_size, p)
        parts = []
        for pool, n in zip(self._class_pools, counts):
            if n == 0 or len(pool) == 0:
                continue
            parts.append(rng.choice(pool, size=n, replace=len(pool) < n))
        idx = (np.sort(np.concatenate(parts)) if parts
               else rng.integers(0, len(self.y), size=self.shard_size))
        self._shards[cid] = idx
        if len(self._shards) > self._cache_size:
            self._shards.popitem(last=False)
        return idx

    def client_batch(self, client_id: int, round_idx: int, batch_size: int):
        """One deterministic local minibatch for (client, round)."""
        idx = self.shard(client_id)
        rng = _rng(self.seed, 0xBA7, client_id, round_idx)
        take = rng.choice(idx, size=batch_size, replace=len(idx) < batch_size)
        return self.x[take], self.y[take]

    # -- device / availability simulation ------------------------------------

    def device_tier(self, client_id: int) -> DeviceTier:
        u = _rng(self.seed, 0x7E1, client_id).random()
        return self.tiers[int(np.searchsorted(np.cumsum(self.tier_probs), u))]

    def latency(self, client_id: int, round_idx: int) -> float:
        """Simulated seconds until this client's update arrives."""
        tier = self.device_tier(client_id)
        jitter = _rng(self.seed, 0x1A7, client_id, round_idx).lognormal(
            mean=0.0, sigma=0.5)
        return tier.base_latency * jitter

    # two-part latency model for the event-driven async simulator: local
    # compute time (tier flops scale + jitter) and uplink transit time are
    # drawn SEPARATELY per (client, task) so the async engine can account
    # useful-vs-wasted client compute. Seeded per (client, task_idx) —
    # replay after a resume redraws identical values. The sync ``latency``
    # stream above is untouched (different entropy tags).

    def compute_seconds(self, client_id: int, task_idx: int,
                        work_s: float = 60.0) -> float:
        """Seconds of local compute for one dispatch: ``work_s`` is the
        nominal local-epoch wall time on a flops_scale=1.0 device."""
        tier = self.device_tier(client_id)
        jitter = _rng(self.seed, 0xC0F0, client_id, task_idx).lognormal(
            mean=0.0, sigma=0.35)
        return work_s / tier.flops_scale * jitter

    def uplink_seconds(self, client_id: int, task_idx: int) -> float:
        """Seconds in flight for one dispatch's uplink frame."""
        tier = self.device_tier(client_id)
        jitter = _rng(self.seed, 0x0971, client_id, task_idx).lognormal(
            mean=0.0, sigma=0.5)
        return tier.base_latency * jitter

    def availability_rate(self, client_id: int, round_idx: int) -> float:
        phase = _rng(self.seed, 0xFA5E, client_id).random()
        wave = math.sin(2 * math.pi * (round_idx / self.avail_period + phase))
        return float(np.clip(self.avail_base + self.avail_swing * wave,
                             0.05, 1.0))

    def available(self, client_id: int, round_idx: int) -> bool:
        u = _rng(self.seed, 0xA7A, client_id, round_idx).random()
        return u < self.availability_rate(client_id, round_idx)


# ---------------------------------------------------------------------------
# Cohort scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CohortPlan:
    """One round's marching orders: who runs, what units, who survives."""
    round_idx: int
    client_ids: np.ndarray          # (C,) logical population ids (selected)
    seed_ids: np.ndarray            # (C,) fold_in chain positions = arange(C)
    mask_matrix: np.ndarray         # (C, U) float32 unit assignment
    latencies: np.ndarray           # (C,) simulated completion seconds
    deadline: float                 # straggler cutoff
    keep: np.ndarray                # (C,) bool — update arrived in time
    assignments: List[TaskAssignment]
    n_requested: int                # cohort size before over-selection
    crash_scales: Optional[np.ndarray] = None  # (C,) per-tier fault scaling

    @property
    def cohort_size(self) -> int:
        return len(self.client_ids)

    @property
    def n_survivors(self) -> int:
        return int(self.keep.sum())

    def downlink_bytes(self) -> int:
        return sum(a.byte_size() for a in self.assignments)


class CohortScheduler:
    """Over-select, assign units cyclically, simulate stragglers/dropout."""

    def __init__(self, population: ClientPopulation, cohort_size: int,
                 over_select: float = 1.25, deadline: Optional[float] = None,
                 dropout_rate: float = 0.0, seed: int = 0,
                 max_probe: int = 4096):
        if over_select < 1.0:
            raise ValueError("over_select must be >= 1.0")
        self.population = population
        self.cohort_size = int(cohort_size)
        self.over_select = float(over_select)
        self.deadline = deadline
        self.dropout_rate = float(dropout_rate)
        self.seed = int(seed)
        self.max_probe = int(max_probe)

    def _select(self, round_idx: int) -> np.ndarray:
        """Rejection-sample available clients (scales to huge populations —
        never scans the full id space)."""
        pop = self.population
        target = int(math.ceil(self.cohort_size * self.over_select))
        target = min(target, pop.n_clients)
        rng = _rng(self.seed, 0x5E1, round_idx)
        chosen: List[int] = []
        seen = set()
        probes = 0
        while len(chosen) < target and probes < self.max_probe:
            cand = int(rng.integers(0, pop.n_clients))
            probes += 1
            if cand in seen:
                continue
            seen.add(cand)
            if pop.available(cand, round_idx):
                chosen.append(cand)
        if len(chosen) < target:      # degenerate availability: fill anyway
            for cand in range(pop.n_clients):
                if cand not in seen:
                    chosen.append(cand)
                if len(chosen) >= target:
                    break
        return np.asarray(chosen[:target], np.int64)

    def plan_round(self, round_idx: int, n_units: int, spry_seed: int,
                   hparams: Optional[dict] = None,
                   client_ids: Optional[np.ndarray] = None) -> CohortPlan:
        """Build the round plan. ``client_ids`` overrides selection (tests /
        full-participation replays)."""
        pop = self.population
        if client_ids is None:
            client_ids = self._select(round_idx)
        client_ids = np.asarray(client_ids, np.int64)
        C = len(client_ids)
        seed_ids = np.arange(C, dtype=np.int32)
        mask_matrix = assignment_matrix(n_units, C, round_idx % C).numpy()

        latencies = np.asarray(
            [pop.latency(int(c), round_idx) for c in client_ids], np.float64)
        if self.deadline is not None:
            deadline = float(self.deadline)
        else:
            # default cutoff: generous quantile of THIS cohort — drops the
            # heavy straggler tail, keeps the bulk
            deadline = float(np.quantile(latencies, 0.9)) if C > 1 \
                else float("inf")
        keep = latencies <= deadline
        if self.dropout_rate > 0.0:
            drop_rng = _rng(self.seed, 0xD0, round_idx)
            keep = keep & (drop_rng.random(C) >= self.dropout_rate)
        if not keep.any():
            keep = latencies <= latencies.min()   # never lose a whole round

        hparams = dict(hparams or {})
        assignments = []
        for i, cid in enumerate(client_ids):
            unit_ids = np.flatnonzero(mask_matrix[i] > 0).astype(np.int32)
            assignments.append(TaskAssignment(
                round_idx=int(round_idx), client_id=int(cid),
                seed_id=int(seed_ids[i]), cohort_size=C, seed=int(spry_seed),
                n_units=int(n_units), unit_ids=unit_ids, hparams=hparams))
        crash_scales = np.asarray(
            [pop.device_tier(int(c)).crash_scale for c in client_ids],
            np.float64)
        return CohortPlan(
            round_idx=int(round_idx), client_ids=client_ids,
            seed_ids=seed_ids, mask_matrix=mask_matrix, latencies=latencies,
            deadline=deadline, keep=keep, assignments=assignments,
            n_requested=self.cohort_size, crash_scales=crash_scales)

    def round_batch(self, plan: CohortPlan, batch_size: int):
        """Stack each planned client's local minibatch to (C, B, ...)."""
        xs, ys = [], []
        for cid in plan.client_ids:
            bx, by = self.population.client_batch(int(cid), plan.round_idx,
                                                  batch_size)
            xs.append(bx)
            ys.append(by)
        return np.stack(xs), np.stack(ys)
