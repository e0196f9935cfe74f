"""FedBuff-style asynchronous federation engine over the SPRY wire protocol.

Port of ``repro/fl/runtime/async_engine.py``. Instead of round-synchronous
cohorts with a straggler deadline, the server keeps ``concurrency`` clients
in flight at all times and aggregates the first ``buffer_size`` (B)
VALIDATED arrivals with staleness-weighted combination:

    w_i = 1 / (1 + s_i) ** staleness_decay

where ``s_i = server_version_now - server_version_at_dispatch``. A late
update is never thrown away (the round-synchronous engine's deadline cut):
it simply lands in the NEXT buffer with one more unit of staleness and a
correspondingly smaller relative weight. Aggregation is the dropout-
corrected per-unit weighted mean — with an all-fresh buffer (every s_i
equal) the weights cancel and the combination reduces to the synchronous
engine's unit average.

Time is virtual: an ``EventHeap`` orders (dispatch -> arrival) events by
``(virtual_seconds, seq)`` over ``population.py``'s two-part latency model
(per-tier compute seconds + uplink transit, both seeded per (client,
dispatch)), diurnal availability gates client selection, and every random
draw is stateless — so a run replays bit-identically, including across
kill-and-resume: ``snapshot()`` captures the buffer, the in-flight event
heap (frames and all), the virtual clock, and the dispatch counter;
``restore()`` resumes mid-buffer with zero drift. Wall time never enters.

Dispatched frames run the sync engine's fault gauntlet (tier-scaled crash
-> poison -> retry/loss -> corruption -> strict decode + quarantine ->
dedupe), and defensive validation (NaN/Inf + norm-outlier-vs-crowd) gates
entry into the aggregation — the B-arrivals trigger counts validated
updates only, the async analogue of the sync engine's quorum gate.

The per-iteration mode works unchanged because ``make_rebuild_fn`` uses
the peft only for SHAPES: the server rebuilds a stale update's gradient
from (base_version, seed_id, K jvp scalars) at aggregation time.

As the sync engine, the engine takes the round steps' optional
``perturbations`` (``perturbations[seed_id][iter]``; the seed id is the
global dispatch index, so each dispatch has its own), used by the clients
and by the per-iteration rebuild, so tests can inject the reference's draws.

Telemetry (``telemetry=``, default ``NULL``) records host-side: the
``fl.async.version`` span, the ``fl.async.*`` and fault counters as events
happen, the byte counters as each version's increment, and an
``async_round`` event after each server step. It is never an input of a
computation, so telemetry on is bitwise telemetry off.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.assignment import assignment_matrix, enumerate_units
from repro_torch.core.forward_grad import fold_in
from repro_torch.core.spry import (
    SpryState,
    aggregate_payloads,
    make_client_jvp_fn,
    make_client_update_fn,
    make_rebuild_fn,
)
from repro_torch.fl.runtime.engine import (
    WireConfig,
    WireHealth,
    poison_update,
    validate_updates,
)
from repro_torch.fl.runtime.events import EventHeap, sample_available
from repro_torch.fl.runtime.executor import _weighted
from repro_torch.fl.runtime.faults import FaultConfig, FaultInjector
from repro_torch.fl.runtime.messages import (
    ClientUpdate,
    TaskAssignment,
    WireError,
    as_float,
    decode_frame,
)
from repro_torch.fl.server import server_update
from repro_torch.obs import NULL
from repro_torch.utils.pytree import tree_leaves, tree_map

ASYNC_SNAPSHOT_SCHEMA = "repro.async/v1"


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the buffered-asynchronous aggregation policy."""
    buffer_size: int = 4          # B: validated arrivals per server step
    staleness_decay: float = 0.5  # a in w = 1/(1+s)^a  (0 = ignore staleness)
    concurrency: int = 8          # clients kept in flight
    max_staleness: Optional[int] = None   # drop updates staler than this
    work_seconds: float = 60.0    # nominal local-epoch wall time at scale 1.0
    seed: int = 0                 # dispatch/selection seed (not the algo seed)
    max_events_per_step: int = 100_000    # runaway-loop guard

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.concurrency < self.buffer_size:
            raise ValueError(
                f"concurrency ({self.concurrency}) must be >= buffer_size "
                f"({self.buffer_size}) or the buffer can never fill")
        if self.staleness_decay < 0.0:
            raise ValueError("staleness_decay must be >= 0")


@dataclasses.dataclass
class AsyncRoundReport:
    """One server step (version bump) of the async engine."""
    version: int                  # server version AFTER this step
    sim_time_s: float             # virtual clock at the step
    n_aggregated: int
    staleness: List[int]          # per aggregated update
    buffer_occupancy: int         # left in the buffer after the step
    in_flight: int
    bytes_down: int               # cumulative TaskAssignment bytes
    bytes_up: int                 # cumulative uplink bytes (all attempts)
    useful_compute_s: float       # cumulative client compute aggregated
    discarded_compute_s: float    # cumulative client compute wasted
    events_processed: int
    health: Optional[WireHealth] = None

    @property
    def utilization(self) -> float:
        total = self.useful_compute_s + self.discarded_compute_s
        return self.useful_compute_s / max(total, 1e-12)


class AsyncFederationEngine:
    """Event-driven FedBuff server over ``ClientPopulation``.

    ``run_version(state, batch_size)`` advances the simulation until ONE
    server step has been applied and returns ``(state', metrics, report)``
    — the same call shape as ``FederationEngine.run_round``, so the
    training loop drives either engine interchangeably.
    """

    def __init__(self, cfg, spry_cfg, population, task: str = "cls",
                 comm_mode: Optional[str] = None,
                 async_cfg: Optional[AsyncConfig] = None,
                 wire: Optional[WireConfig] = None, telemetry=None,
                 faults=None, norm_outlier_mult: float = 100.0,
                 perturbations=None):
        self.cfg = cfg
        self.spry_cfg = spry_cfg
        self.population = population
        self.task = task
        self.async_cfg = async_cfg or AsyncConfig()
        self.wire = wire or WireConfig()
        if isinstance(faults, FaultConfig):
            faults = FaultInjector(faults)
        self.faults: Optional[FaultInjector] = faults
        self.norm_outlier_mult = float(norm_outlier_mult)
        self.perturbations = perturbations
        self.comm_mode = comm_mode or spry_cfg.comm_mode
        if self.comm_mode not in ("per_epoch", "per_iteration"):
            raise ValueError(self.comm_mode)
        if self.comm_mode == "per_epoch":
            self._client_fn = make_client_update_fn(cfg, spry_cfg, task)
        else:
            self._client_fn = make_client_jvp_fn(cfg, spry_cfg, task)
            self._rebuild_fn = make_rebuild_fn()

        # -- virtual-time state (everything snapshot() captures) ----------
        self.heap = EventHeap()
        self.clock = 0.0
        self.version: Optional[int] = None    # locked to state.round_idx
        self.dispatched = 0                   # global dispatch counter
        self.buffer: List[Dict[str, Any]] = []
        self.bytes_up = 0
        self.bytes_down = 0
        self.useful_compute_s = 0.0
        self.discarded_compute_s = 0.0
        self.updates_used = 0
        self.updates_discarded = 0
        self.events_processed = 0

        self._n_units: Optional[int] = None
        self._assign_rows: Dict[int, np.ndarray] = {}
        # cumulative totals already pushed to the byte counters (the report
        # carries running totals; telemetry must only see each version's
        # increment)
        self._bytes_up_reported = 0
        self._bytes_down_reported = 0

        # host-side telemetry ONLY: no computation takes this object, so
        # telemetry on computes the same versions
        tel = telemetry if telemetry is not None else NULL
        self.telemetry = tel
        self._tc_steps = tel.counter("fl.async.server_steps")
        self._tc_dispatches = tel.counter("fl.async.dispatches")
        self._tc_used = tel.counter("fl.async.updates_used")
        self._tc_discarded = tel.counter("fl.async.updates_discarded")
        self._tc_useful_s = tel.counter("fl.async.useful_compute_s")
        self._tc_wasted_s = tel.counter("fl.async.discarded_compute_s")
        self._tc_bytes_up = tel.counter("fl.bytes_up")
        self._tc_bytes_down = tel.counter("fl.bytes_down")
        self._tg_buffer = tel.gauge("fl.async.buffer")
        self._tg_loss = tel.gauge("fl.loss")
        self._th_staleness = tel.histogram(
            "fl.async.staleness", buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
        self._tc_quarantined = tel.counter("fl.quarantined")
        self._tc_lost = tel.counter("fl.lost_updates")
        self._tc_crashed = tel.counter("fl.crashed_clients")
        self._tc_dups = tel.counter("fl.duplicate_frames")
        self._tc_invalid = tel.counter("fl.invalid_payloads")

    # ------------------------------------------------------------------
    # dispatch / arrival
    # ------------------------------------------------------------------

    def _ensure_static(self, state) -> None:
        if self.version is None:
            self.version = int(state.round_idx)
        if self._n_units is None:
            self._n_units = enumerate_units(state.peft).n_units

    def _mask_row(self, d: int) -> np.ndarray:
        """Cyclic unit assignment by dispatch index: every ``buffer_size``
        consecutive dispatches tile all units, with a rotating offset so
        unit->client pairings vary across buffers."""
        A = max(int(self.async_cfg.buffer_size), 1)
        offset = (d // A) % max(A, 1)
        if offset not in self._assign_rows:
            self._assign_rows[offset] = assignment_matrix(
                self._n_units, A, offset).numpy()
        return self._assign_rows[offset][d % A]

    def _dispatch(self, state, batch_size: int, health: WireHealth) -> None:
        cfg = self.async_cfg
        pop = self.population
        d = self.dispatched
        self.dispatched += 1
        tick = int(self.clock // max(cfg.work_seconds, 1e-9))
        cid = sample_available(pop, tick, d, cfg.seed)
        tier = pop.device_tier(cid)
        comp = pop.compute_seconds(cid, d, cfg.work_seconds)
        uplink = pop.uplink_seconds(cid, d)
        row = self._mask_row(d)
        unit_ids = np.flatnonzero(row > 0).astype(np.int32)
        assignment = TaskAssignment(
            round_idx=self.version, client_id=cid, seed_id=d,
            cohort_size=cfg.concurrency, seed=self.spry_cfg.seed,
            n_units=self._n_units, unit_ids=unit_ids, hparams={})
        self.bytes_down += assignment.byte_size()
        self._tc_dispatches.inc()

        ev: Dict[str, Any] = {"client_id": cid, "dispatch_version":
                              self.version, "compute_s": float(comp),
                              "crashed": False, "frames": []}
        inj = self.faults
        if inj is not None and inj.crashes(cid, d, tier.crash_scale):
            ev["crashed"] = True
            # the device died mid-epoch: the slot frees when the work would
            # have finished, the server just never hears from it
            self.heap.push(self.clock + comp, ev)
            return

        # the client's local work happens EAGERLY against the current
        # model (round key: the fold-in chain keyed by the server version
        # at dispatch); the resulting frame rides the event so a checkpoint
        # of the heap preserves in-flight updates byte-for-byte
        dev = tree_leaves(state.peft)[0].device
        bx, by = pop.client_batch(cid, d, batch_size)
        rk = fold_in(self.spry_cfg.seed, self.version)
        out = self._client_fn(
            state.base, state.peft, rk, d, torch.as_tensor(row, device=dev),
            {"tokens": torch.as_tensor(bx, device=dev),
             "labels": torch.as_tensor(by, device=dev)}, self.perturbations)
        if self.comm_mode == "per_epoch":
            delta, loss, _jvps = out
            u = ClientUpdate.from_delta(
                delta, enumerate_units(state.peft), unit_ids,
                round_idx=self.version, client_id=cid, seed_id=d,
                wire=self.wire.dtype, loss=float(loss),
                include_head=self.wire.include_head)
        else:
            loss, jvps = out
            u = ClientUpdate.from_jvps(
                jvps, round_idx=self.version, client_id=cid,
                seed_id=d, wire=self.wire.dtype, loss=float(loss))
        u.base_version = self.version
        backoff = 0.0
        if inj is not None:
            mode = inj.poison_mode(cid, d)
            if mode is not None:
                poison_update(inj, u, mode)
            frame = u.to_bytes()
            health.sent += 1
            delivered, attempts, backoff = inj.transmit(frame, cid, d)
            self.bytes_up += len(frame) * attempts
            health.transmissions += attempts
            health.retries += attempts - 1
        else:
            frame = u.to_bytes()
            health.sent += 1
            health.transmissions += 1
            delivered = [frame]
            self.bytes_up += len(frame)
        ev["frames"] = delivered
        self.heap.push(self.clock + comp + uplink + backoff, ev)

    def _on_arrival(self, ev: Dict[str, Any], health: WireHealth) -> None:
        comp = float(ev["compute_s"])
        if ev["crashed"]:
            health.crashed += 1
            self._waste(comp)
            self._tc_crashed.inc()
            return
        if not ev["frames"]:
            health.lost += 1
            self._waste(comp)
            self._tc_lost.inc()
            return
        buffered_ids = {e["update"].seed_id for e in self.buffer}
        landed = False
        for fb in ev["frames"]:
            health.delivered += 1
            try:
                dec = decode_frame(fb)
            except WireError as e:
                health.quarantined += 1
                health.failure_kinds[e.kind] = \
                    health.failure_kinds.get(e.kind, 0) + 1
                self._tc_quarantined.inc()
                continue
            if not isinstance(dec, ClientUpdate) \
                    or dec.seed_id in buffered_ids:
                health.duplicates += 1
                self._tc_dups.inc()
                continue
            buffered_ids.add(dec.seed_id)
            health.accepted += 1
            dv = dec.base_version if dec.base_version is not None \
                else dec.round_idx
            self.buffer.append({"update": dec, "dispatch_version": int(dv),
                                "compute_s": comp})
            landed = True
        if not landed:
            self._waste(comp)
        self._tg_buffer.set(len(self.buffer))

    def _waste(self, comp: float) -> None:
        self.discarded_compute_s += comp
        self.updates_discarded += 1
        self._tc_discarded.inc()
        self._tc_wasted_s.add(comp)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def _expire_stale(self, health: WireHealth) -> None:
        ms = self.async_cfg.max_staleness
        if ms is None:
            return
        kept = []
        for e in self.buffer:
            if self.version - e["dispatch_version"] > ms:
                health.invalid += 1
                self._waste(e["compute_s"])
            else:
                kept.append(e)
        self.buffer = kept

    def _try_aggregate(self, state, health: WireHealth):
        """If >= B validated updates are buffered, apply one server step.
        Returns (state', metrics-or-None)."""
        B = self.async_cfg.buffer_size
        while True:
            self._expire_stale(health)
            if len(self.buffer) < B:
                return state, None
            head = self.buffer[:B]
            valid = validate_updates(
                {i: e["update"] for i, e in enumerate(head)},
                self.norm_outlier_mult)
            if len(valid) < B:
                bad = set(range(B)) - valid
                health.invalid += len(bad)
                self._tc_invalid.add(len(bad))
                for i in sorted(bad):
                    self._waste(head[i]["compute_s"])
                self.buffer = [e for i, e in enumerate(self.buffer)
                               if i >= B or i in valid]
                continue
            health.validated += B
            return self._aggregate(state, head)

    def _weighted_mean(self, peft, trees, weights, mask_rows):
        """Per-unit staleness-weighted mean: Σ w_i m_iu x_i / Σ w_i m_iu.
        With equal weights this is exactly the sync engine's dropout-
        corrected unit average (weights cancel)."""
        index = enumerate_units(peft)
        counts = torch.clamp((mask_rows * weights[:, None]).sum(0), min=1e-8)
        head_count = float(torch.clamp(weights.sum(), min=1e-8))
        return aggregate_payloads(
            peft, index, [_weighted(t, weights[i]) for i, t in enumerate(trees)],
            counts, head_count)

    def _aggregate(self, state, entries: List[Dict[str, Any]]):
        a = self.async_cfg.staleness_decay
        stale = np.asarray([self.version - e["dispatch_version"]
                            for e in entries], np.int64)
        w64 = (1.0 + stale.astype(np.float64)) ** (-a)
        peft = state.peft
        dev = tree_leaves(peft)[0].device
        weights = torch.as_tensor(w64.astype(np.float32), device=dev)
        updates = [e["update"] for e in entries]
        losses = np.asarray([u.loss for u in updates], np.float64)

        if self.comm_mode == "per_epoch":
            index = enumerate_units(peft)
            mask_rows = np.zeros((len(updates), self._n_units), np.float32)
            for i, u in enumerate(updates):
                mask_rows[i, sorted(u.unit_payload or {})] = 1.0
            zeros = tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                             peft)
            trees = [u.to_delta(zeros, index) for u in updates]
        else:
            mask_rows = np.stack([self._mask_row(u.seed_id) for u in updates])
            trees = [self._rebuild_fn(
                peft, fold_in(self.spry_cfg.seed, e["dispatch_version"]),
                u.seed_id, torch.as_tensor(mask_rows[i], device=dev),
                torch.tensor(as_float(u.jvps), device=dev), self.perturbations)
                for i, (e, u) in enumerate(zip(entries, updates))]
        agg = self._weighted_mean(peft, trees, weights,
                                  torch.as_tensor(mask_rows, device=dev))
        if self.comm_mode == "per_iteration":
            delta = tree_map(lambda g: -self.spry_cfg.local_lr * g, agg)
        else:
            delta = agg
        new_peft, server = server_update(
            self.spry_cfg.server_opt, peft, delta, state.server,
            lr=self.spry_cfg.server_lr)
        new_state = SpryState(state.base, new_peft, server,
                              state.round_idx + 1)

        self.buffer = self.buffer[len(entries):]
        self.version += 1
        for e in entries:
            self.useful_compute_s += e["compute_s"]
            self.updates_used += 1
            self._tc_used.inc()
            self._tc_useful_s.add(e["compute_s"])
        for s in stale.tolist():
            self._th_staleness.observe(float(s))
        self._tc_steps.inc()

        metrics = {
            "loss": torch.tensor(np.float32(np.average(losses, weights=w64))),
            "delta_norm": torch.sqrt(sum(torch.sum(d * d)
                                         for d in tree_leaves(delta))),
            "staleness_mean": torch.tensor(np.float32(stale.mean())),
            "fused_route": torch.tensor(float(self.spry_cfg.fused_contraction)),
        }
        if self.comm_mode == "per_iteration":
            metrics["jvp_abs_mean"] = torch.tensor(np.float32(np.mean(np.abs(
                np.stack([np.asarray(as_float(u.jvps), np.float64)
                          for u in updates])))))
        return new_state, {"metrics": metrics,
                           "staleness": [int(s) for s in stale]}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def run_version(self, state, batch_size: int
                    ) -> Tuple[Any, Dict[str, Any], AsyncRoundReport]:
        """Advance the event simulation until ONE server step lands."""
        self._ensure_static(state)
        if self.version != int(state.round_idx):
            raise ValueError(
                f"engine version {self.version} out of step with "
                f"state.round_idx {int(state.round_idx)} — restore() the "
                f"matching snapshot when resuming")
        tel = self.telemetry
        t_wall = time.perf_counter()
        health = WireHealth()
        agg = None
        guard = 0
        with tel.span("fl.async.version", version=self.version,
                      comm_mode=self.comm_mode):
            while agg is None:
                guard += 1
                if guard > self.async_cfg.max_events_per_step:
                    raise RuntimeError(
                        f"no aggregation after {guard} events — buffer "
                        f"cannot fill (check max_staleness / faults)")
                while len(self.heap) < self.async_cfg.concurrency:
                    self._dispatch(state, batch_size, health)
                t, _, ev = self.heap.pop()
                self.clock = float(t)
                self.events_processed += 1
                self._on_arrival(ev, health)
                state, agg = self._try_aggregate(state, health)

        report = AsyncRoundReport(
            version=self.version, sim_time_s=self.clock,
            n_aggregated=self.async_cfg.buffer_size,
            staleness=agg["staleness"],
            buffer_occupancy=len(self.buffer), in_flight=len(self.heap),
            bytes_down=self.bytes_down, bytes_up=self.bytes_up,
            useful_compute_s=self.useful_compute_s,
            discarded_compute_s=self.discarded_compute_s,
            events_processed=self.events_processed, health=health)
        metrics = agg["metrics"]
        if tel.enabled:
            self._record_version(metrics, report,
                                 time.perf_counter() - t_wall)
        return state, metrics, report

    def _record_version(self, metrics, report: AsyncRoundReport,
                        wall_s: float) -> None:
        """Host-side recording on the version's RETURNED values (the float()
        conversions copy already-computed tensors to the host)."""
        host = {k: float(v) for k, v in metrics.items()}
        self._tg_loss.set(host["loss"])
        self._tc_bytes_up.add(report.bytes_up - self._bytes_up_reported)
        self._tc_bytes_down.add(report.bytes_down
                                - self._bytes_down_reported)
        self._bytes_up_reported = report.bytes_up
        self._bytes_down_reported = report.bytes_down
        self.telemetry.event(
            "async_round",
            version=report.version,
            comm_mode=self.comm_mode,
            loss=host["loss"],
            delta_norm=host.get("delta_norm"),
            staleness=report.staleness,
            staleness_mean=host.get("staleness_mean"),
            buffer_occupancy=report.buffer_occupancy,
            in_flight=report.in_flight,
            sim_time_s=round(report.sim_time_s, 6),
            bytes_up=report.bytes_up,
            bytes_down=report.bytes_down,
            useful_compute_s=round(report.useful_compute_s, 6),
            discarded_compute_s=round(report.discarded_compute_s, 6),
            utilization=round(report.utilization, 6),
            wall_s=round(wall_s, 6),
        )

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Raw snapshot of the virtual-time state (frames as raw bytes —
        use ``checkpoint.async_state.encode_async_snapshot`` to make it
        JSON-safe for the run manifest). Captures buffer + event clock,
        never wall time."""
        return {
            "schema": ASYNC_SNAPSHOT_SCHEMA,
            "clock": float(self.clock),
            "version": self.version,
            "dispatched": int(self.dispatched),
            "events_processed": int(self.events_processed),
            "bytes_up": int(self.bytes_up),
            "bytes_down": int(self.bytes_down),
            "useful_compute_s": float(self.useful_compute_s),
            "discarded_compute_s": float(self.discarded_compute_s),
            "updates_used": int(self.updates_used),
            "updates_discarded": int(self.updates_discarded),
            "heap": self.heap.snapshot(),
            "buffer": [{"frame": e["update"].to_bytes(),
                        "dispatch_version": int(e["dispatch_version"]),
                        "compute_s": float(e["compute_s"])}
                       for e in self.buffer],
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        """Rebuild the virtual-time state from a raw snapshot: the heap
        pops in the original order, buffered/in-flight frames are restored
        byte-for-byte, and every future draw re-keys identically — replay
        after restore is bitwise."""
        if snap.get("schema") != ASYNC_SNAPSHOT_SCHEMA:
            raise ValueError(
                f"unknown async snapshot schema {snap.get('schema')!r}")
        self.clock = float(snap["clock"])
        self.version = int(snap["version"])
        self.dispatched = int(snap["dispatched"])
        self.events_processed = int(snap["events_processed"])
        self.bytes_up = int(snap["bytes_up"])
        self.bytes_down = int(snap["bytes_down"])
        # don't re-emit pre-snapshot traffic to this process's counters
        self._bytes_up_reported = self.bytes_up
        self._bytes_down_reported = self.bytes_down
        self.useful_compute_s = float(snap["useful_compute_s"])
        self.discarded_compute_s = float(snap["discarded_compute_s"])
        self.updates_used = int(snap["updates_used"])
        self.updates_discarded = int(snap["updates_discarded"])
        self.heap = EventHeap.restore(snap["heap"])
        self.buffer = [
            {"update": ClientUpdate.from_bytes(e["frame"]),
             "dispatch_version": int(e["dispatch_version"]),
             "compute_s": float(e["compute_s"])}
            for e in snap["buffer"]]
