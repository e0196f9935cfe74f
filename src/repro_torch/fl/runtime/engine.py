"""Federation round engine: scheduler -> executor -> aggregator -> server.

Port of ``repro/fl/runtime/engine.py``. One ``FederationEngine`` drives
SPRY rounds through the runtime pieces for both communication modes:

  per_epoch      clients run local forward-gradient SGD and ship masked
                 deltas; the server re-averages each unit over the clients
                 whose update actually ARRIVED (dropout-corrected counts —
                 the fixed-M ``client_counts`` of the in-process step cannot
                 express a straggler whose payload never lands).
  per_iteration  clients ship K jvp scalars + seed ref; the server
                 regenerates the perturbations and rebuilds/aggregates the
                 gradients (paper §3.2 / Table 2).

Bit-identity contract: with full participation, no wire quantization
(wire simulation off or fp32) and the whole-cohort SerialExecutor,
``run_ideal`` / ``run_round`` equal ``core.spry.make_round_step`` /
``make_round_step_per_iteration`` bit for bit — the engine composes the
pieces those round steps are built from (make_client_update_fn /
make_client_jvp_fn / make_rebuild_fn / aggregate_payloads) with the same
aggregation ops in the same order. Every round takes the round steps'
optional ``perturbations`` (``perturbations[seed_id][iter]``), so tests can
inject the reference's draws.

Clients are computed one at a time, dropped and padded ones (keep=0)
included: requorum reuses a straggler's already computed update. So a
dropped client's aggregation equals an explicit re-run without it.

Wire simulation (``WireConfig(simulate=True)``) routes every surviving
client's payload through a real serialized ``ClientUpdate`` frame
(measured bytes, configurable fp32/bf16/fp16 scalar quantization) before
aggregation; fp32 framing is bit-exact.

Fault tolerance (``faults=`` + ``quorum=``): with a ``FaultInjector`` the
simulated wire becomes chaotic — crashes, corruption, loss-with-retry,
duplication, poisoned payloads — and the server side gains the full
defensive stack: strict decode quarantines bad frames (counted, never
aggregated), payload validation rejects NaN/Inf and norm-outlier updates,
dedupe drops duplicate deliveries, and quorum gating either re-extends the
cohort deterministically from the over-selection pool (stragglers whose
updates were already computed) or skips the server step and carries the
round forward. Dropout-corrected unit counts and all survivor metrics
derive from the VALIDATED survivor set only. With faults disabled the
engine takes the plain paths (bit-identity preserved).

Telemetry (``telemetry=``, default ``NULL``) records host-side, after the
round, on the values it returned: the ``fl.round`` span and its phases,
the ``fl.*`` counters, gauges and histograms, and the ``round`` and
``wire_health`` events. It is never an input of the round, so telemetry on
is bitwise telemetry off.
"""
from __future__ import annotations

import dataclasses
import math
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
    make_count_tree,
    make_rebuild_fn,
)
from repro_torch.fl.runtime.executor import SerialExecutor, _weighted, pad_cohort
from repro_torch.fl.runtime.faults import FaultConfig, FaultInjector
from repro_torch.fl.runtime.messages import (
    ClientUpdate,
    WireError,
    as_float,
    decode_frame,
)
from repro_torch.fl.runtime.population import CohortPlan
from repro_torch.fl.server import server_update
from repro_torch.obs import NULL
from repro_torch.utils.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Uplink wire behaviour. ``simulate=True`` packs/unpacks real frames
    (collect mode — test/accounting scale); False streams in-process and
    only *accounts* bytes from zero-filled template frames."""
    dtype: str = "fp32"
    simulate: bool = False
    include_head: bool = True


@dataclasses.dataclass
class WireHealth:
    """Per-round tally of the chaotic uplink and the server's defenses."""
    sent: int = 0            # frames serialized for transmission
    transmissions: int = 0   # uplink attempts (every one burns bytes)
    delivered: int = 0       # frames that reached the server at all
    accepted: int = 0        # strict-decoded OK after dedupe
    validated: int = 0       # passed defensive payload validation
    crashed: int = 0         # clients that died before transmitting
    lost: int = 0            # frames that exhausted every retry
    retries: int = 0         # attempts beyond the first
    backoff_s: float = 0.0   # total simulated retry backoff
    quarantined: int = 0     # delivered frames rejected by strict decode
    duplicates: int = 0      # deliveries deduped at the server
    invalid: int = 0         # decoded OK but failed payload validation
    requorumed: int = 0      # pool clients activated to reach quorum
    failure_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RoundReport:
    round_idx: int
    cohort_size: int                 # scheduled (over-selected) cohort
    n_requested: int
    n_survivors: int
    dropped_client_ids: List[int]
    deadline: float
    bytes_down: int                  # Σ TaskAssignment frames
    bytes_up: int                    # Σ surviving ClientUpdate frames
    wire: str
    executor: str
    n_devices: int
    agg_bytes_streaming: int         # accumulator bytes (O(peft) / device)
    agg_bytes_stacked: int           # (C, peft) materialization equivalent
    # fault-tolerance fields (defaulted: clean-path constructors unchanged)
    n_validated: int = -1            # survivors the aggregator actually used
    dropped_frame_ids: List[int] = dataclasses.field(default_factory=list)
    quorum: int = 0                  # resolved quorum (0 = ungated)
    quorum_met: bool = True
    round_skipped: bool = False      # below quorum: server step skipped
    health: Optional[WireHealth] = None

    def __post_init__(self):
        if self.n_validated < 0:
            self.n_validated = self.n_survivors


def update_payload_arrays(u: ClientUpdate) -> List[np.ndarray]:
    """Flat list of a ClientUpdate's payload arrays in canonical order
    (shared by the sync and async engines' defensive validation)."""
    arrs = []
    if u.mode == "delta":
        for uid in sorted(u.unit_payload or {}):
            arrs.extend(u.unit_payload[uid])
        if u.head_payload is not None:
            arrs.extend(u.head_payload)
    elif u.jvps is not None:
        arrs.append(u.jvps)
    return arrs


def poison_update(inj: FaultInjector, u: ClientUpdate, mode: str) -> None:
    """Client-side numeric poisoning BEFORE framing: the frame's CRC is
    valid — only defensive payload validation can catch these."""
    if u.mode == "delta":
        u.unit_payload = {
            k: [inj.poison_array(np.asarray(a), mode) for a in v]
            for k, v in (u.unit_payload or {}).items()}
        if u.head_payload is not None:
            u.head_payload = [inj.poison_array(np.asarray(a), mode)
                              for a in u.head_payload]
    else:
        u.jvps = inj.poison_array(np.asarray(u.jvps), mode)
    u.invalidate_encoding()


def validate_updates(accepted: Dict[int, ClientUpdate],
                     norm_outlier_mult: float) -> set:
    """Defensive payload validation: reject NaN/Inf outright; with a
    crowd (>= 4 finite updates) also reject norm outliers beyond
    ``norm_outlier_mult`` x the median survivor norm."""
    norms = {}
    for pos, u in accepted.items():
        sq, ok = 0.0, True
        for a in update_payload_arrays(u):
            a = np.asarray(as_float(a), np.float64)
            if not np.all(np.isfinite(a)):
                ok = False
                break
            sq += float(np.sum(a * a))
        norms[pos] = math.sqrt(sq) if ok else None
    valid = {p for p, n in norms.items() if n is not None}
    if len(valid) >= 4:
        med = float(np.median([norms[p] for p in valid]))
        if med > 0.0:
            valid = {p for p in valid
                     if norms[p] <= norm_outlier_mult * med}
    return valid


def _ideal_plan(round_idx: int, M: int, n_units: int) -> CohortPlan:
    """Full participation, no over-selection, everyone on time."""
    mask = assignment_matrix(n_units, M, round_idx % M).numpy()
    return CohortPlan(
        round_idx=round_idx, client_ids=np.arange(M, dtype=np.int64),
        seed_ids=np.arange(M, dtype=np.int32), mask_matrix=mask,
        latencies=np.zeros(M), deadline=float("inf"),
        keep=np.ones(M, bool), assignments=[], n_requested=M)


def _device(peft):
    return tree_leaves(peft)[0].device


def _metrics(spry_cfg, comm_mode, losses, jvps, keep, delta):
    """Round metrics over the kept clients: with everyone kept, the same
    values, ops and keys as the in-process round step's."""
    kept = keep > 0
    jv = jvps[kept]
    metrics = {"loss": losses[kept].mean(), "jvp_abs_mean": jv.abs().mean()}
    if comm_mode == "per_epoch":
        metrics["delta_norm"] = torch.sqrt(sum(torch.sum(d * d)
                                               for d in tree_leaves(delta)))
    metrics["jvps"] = jv
    metrics["fused_route"] = torch.tensor(float(spry_cfg.fused_contraction))
    return metrics


class FederationEngine:
    def __init__(self, cfg, spry_cfg, task: str = "cls",
                 comm_mode: Optional[str] = None, executor=None,
                 wire: Optional[WireConfig] = None, telemetry=None,
                 faults=None, quorum: Optional[float] = None,
                 norm_outlier_mult: float = 100.0):
        self.cfg = cfg
        self.spry_cfg = spry_cfg
        self.task = task
        self.wire = wire or WireConfig()
        if isinstance(faults, FaultConfig):
            faults = FaultInjector(faults)
        if faults is not None and not self.wire.simulate:
            raise ValueError(
                "fault injection perturbs serialized frames — it requires "
                "WireConfig(simulate=True)")
        self.faults: Optional[FaultInjector] = faults
        # quorum: fraction of the requested cohort in (0, 1], or an
        # absolute survivor count >= 1; None disables the gate
        if quorum is not None and quorum <= 0:
            raise ValueError(f"quorum must be positive, got {quorum}")
        self.quorum = quorum
        self.norm_outlier_mult = float(norm_outlier_mult)
        self.comm_mode = comm_mode or spry_cfg.comm_mode
        if self.comm_mode not in ("per_epoch", "per_iteration"):
            raise ValueError(self.comm_mode)
        self.executor = executor if executor is not None else SerialExecutor()
        # host-side telemetry on already-returned values only: no round
        # body takes this object, so telemetry on computes the same round
        tel = telemetry if telemetry is not None else NULL
        self.telemetry = tel
        self._tc_rounds = tel.counter("fl.rounds")
        self._tc_bytes_up = tel.counter("fl.bytes_up")
        self._tc_bytes_down = tel.counter("fl.bytes_down")
        self._tc_stragglers = tel.counter("fl.stragglers")
        self._tg_survivors = tel.gauge("fl.survivors")
        self._tg_mask_units = tel.gauge("fl.surviving_mask_units")
        self._tg_loss = tel.gauge("fl.loss")
        self._tg_jvp = tel.gauge("fl.jvp_abs_mean")
        self._tg_delta = tel.gauge("fl.delta_norm")
        self._th_round_s = tel.histogram("fl.round_seconds")
        # fault-tolerance observability (host-side, zero-cost when clean)
        self._tc_quarantined = tel.counter("fl.quarantined")
        self._tc_corrupt = tel.counter("fl.corrupt_frames")
        self._tc_lost = tel.counter("fl.lost_updates")
        self._tc_crashed = tel.counter("fl.crashed_clients")
        self._tc_dups = tel.counter("fl.duplicate_frames")
        self._tc_retried = tel.counter("fl.retried_attempts")
        self._tc_invalid = tel.counter("fl.invalid_payloads")
        self._tc_requorumed = tel.counter("fl.requorumed")
        self._tc_skipped = tel.counter("fl.rounds_skipped")
        self._th_retries = tel.histogram("fl.retries_per_round")
        # whole-cohort serial execution keeps the per-client payloads and
        # aggregates them with the round step's own aggregate_payloads
        # (bit-identity); a microbatched executor streams instead
        self.collect = (isinstance(self.executor, SerialExecutor)
                        and self.executor.microbatch is None)
        if self.comm_mode == "per_epoch":
            self._client_fn = make_client_update_fn(cfg, spry_cfg, task)
        else:
            self._client_fn = make_client_jvp_fn(cfg, spry_cfg, task)
            self._rebuild_fn = make_rebuild_fn()
        self._uplink_cache: Dict[tuple, int] = {}
        self._zeros_peft = None

    # ------------------------------------------------------------------
    # round bodies
    # ------------------------------------------------------------------

    def _kernels(self, perturbations):
        if self.comm_mode == "per_epoch":
            def kernel(base, peft, rk, sid, row, cb):
                delta, loss, jvps = self._client_fn(base, peft, rk, sid, row,
                                                    cb, perturbations)
                return delta, (loss, jvps)
            return kernel, None

        def kernel(base, peft, rk, sid, row, cb):
            loss, jvps = self._client_fn(base, peft, rk, sid, row, cb,
                                         perturbations)
            return None, (loss, jvps)

        def rebuild_kernel(base, peft, rk, sid, row, jvps):
            return self._rebuild_fn(peft, rk, sid, row, jvps, perturbations), ()
        return kernel, rebuild_kernel

    def _round_key(self, state):
        return fold_in(self.spry_cfg.seed, int(state.round_idx))

    def _finish(self, state, index, payload, counts, keep, losses, jvps,
                stacked: bool):
        """Shared tail: unit-averaged payload -> server update + metrics.
        ``payload`` is the list of keep-weighted client trees (``stacked``)
        or their streamed sum."""
        peft = state.peft
        head_count = float(keep.sum())
        if stacked:
            agg = aggregate_payloads(peft, index, payload, counts, head_count)
        else:
            count_tree = make_count_tree(peft, index, counts, head_count)
            agg = tree_map(lambda s, c: s / c, payload, count_tree)
        if self.comm_mode == "per_iteration":
            delta = tree_map(lambda g: -self.spry_cfg.local_lr * g, agg)
        else:
            delta = agg
        new_peft, server = server_update(
            self.spry_cfg.server_opt, peft, delta, state.server,
            lr=self.spry_cfg.server_lr)
        metrics = _metrics(self.spry_cfg, self.comm_mode, losses, jvps, keep,
                           delta)
        return SpryState(state.base, new_peft, server,
                         state.round_idx + 1), metrics

    def _inputs(self, state, seed_ids, mask_rows, keep):
        dev = _device(state.peft)
        return ([int(s) for s in seed_ids],
                torch.tensor(np.asarray(mask_rows, np.float32), device=dev),
                torch.as_tensor(np.asarray(keep, np.float32), device=dev))

    def _round_direct(self, state, seed_ids, mask_rows, keep, batch,
                      perturbations):
        """Whole round in process (wire simulation off)."""
        base, peft = state.base, state.peft
        index = enumerate_units(peft)
        rk = self._round_key(state)
        kernel, rebuild_kernel = self._kernels(perturbations)
        sids, rows, kp = self._inputs(state, seed_ids, mask_rows, keep)
        counts = torch.clamp((rows * kp[:, None]).sum(0), min=1.0)
        payload, (losses, jvps) = self.executor.run(
            kernel, base, peft, rk, sids, rows, batch, kp, collect=self.collect)
        if self.comm_mode == "per_iteration":
            payload, _ = self.executor.run(
                rebuild_kernel, base, peft, rk, sids, rows, jvps, kp,
                collect=self.collect)
        if self.collect:
            payload = [_weighted(p, kp[i]) for i, p in enumerate(payload)]
        return self._finish(state, index, payload, counts, kp, losses, jvps,
                            stacked=self.collect)

    def _clients(self, state, seed_ids, mask_rows, keep, batch, perturbations):
        """Wire-sim phase 1: per-client payloads + losses and jvps."""
        kernel, _ = self._kernels(perturbations)
        sids, rows, kp = self._inputs(state, seed_ids, mask_rows, keep)
        payload, (losses, jvps) = self.executor.run(
            kernel, state.base, state.peft, self._round_key(state), sids, rows,
            batch, kp, collect=True)
        return payload, losses, jvps

    def _aggregate(self, state, arrived, seed_ids, mask_rows, keep, losses,
                   jvps, perturbations):
        """Wire-sim phase 2: aggregate what arrived (a list of client trees,
        or the (C, K) jvps the server rebuilds from)."""
        peft = state.peft
        index = enumerate_units(peft)
        sids, rows, kp = self._inputs(state, seed_ids, mask_rows, keep)
        counts = torch.clamp((rows * kp[:, None]).sum(0), min=1.0)
        if self.comm_mode == "per_iteration":
            _, rebuild_kernel = self._kernels(perturbations)
            arrived, _ = self.executor.run(
                rebuild_kernel, state.base, peft, self._round_key(state), sids,
                rows, arrived, kp, collect=True)
        payload = [_weighted(p, kp[i]) for i, p in enumerate(arrived)]
        return self._finish(state, index, payload, counts, kp, losses, jvps,
                            stacked=True)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def run_ideal(self, state, batch, perturbations=None
                  ) -> Tuple[Any, Dict[str, Any]]:
        """Full-participation round on a stacked (M, B, ...) batch —
        the in-process ``make_round_step`` executed through the runtime
        (bit-identical with the default whole-cohort executor)."""
        M = batch["tokens"].shape[0]
        index = enumerate_units(state.peft)
        plan = _ideal_plan(int(state.round_idx), M, index.n_units)
        state, metrics, _ = self.run_round(state, plan, batch, perturbations)
        return state, metrics

    def _resolve_quorum(self, plan: CohortPlan) -> int:
        """Resolve the quorum knob to an absolute validated-survivor count:
        a float <= 1.0 is a fraction of the REQUESTED cohort, anything else
        an absolute count. 0 = gate disabled."""
        if self.quorum is None:
            return 0
        q = self.quorum
        if isinstance(q, float) and q <= 1.0:
            return int(math.ceil(q * plan.n_requested))
        return int(q)

    def _requorum(self, plan: CohortPlan, quorum_n: int):
        """Clean-path quorum: deterministically re-extend the survivor set
        from the over-selection pool in latency order (the next-fastest
        stragglers — their compute exists, only their deadline was missed).
        Returns (effective_keep, n_requorumed, quorum_met)."""
        keep = np.asarray(plan.keep, bool).copy()
        requorumed = 0
        if quorum_n and int(keep.sum()) < quorum_n:
            pool = np.flatnonzero(~keep)
            pool = pool[np.argsort(plan.latencies[pool], kind="stable")]
            for i in pool:
                if int(keep.sum()) >= quorum_n:
                    break
                keep[i] = True
                requorumed += 1
        met = (not quorum_n) or int(keep.sum()) >= quorum_n
        return keep, requorumed, met

    def _skip_round(self, state):
        """Below quorum with the pool exhausted: skip the server step and
        carry the round index forward (the caller sees NaN metrics)."""
        new_state = SpryState(state.base, state.peft, state.server,
                              state.round_idx + 1)
        nan = torch.tensor(float("nan"))
        metrics = {"loss": nan, "jvp_abs_mean": nan,
                   "fused_route": torch.tensor(
                       float(self.spry_cfg.fused_contraction))}
        if self.comm_mode == "per_epoch":
            metrics["delta_norm"] = nan
        return new_state, metrics

    def run_round(self, state, plan: CohortPlan, batch, perturbations=None):
        """Execute one scheduled round. ``batch`` leaves (tensors on the
        model's device) lead with the plan's cohort axis. Returns (state,
        metrics, RoundReport)."""
        tel = self.telemetry
        t_round = time.perf_counter()
        index = enumerate_units(state.peft)
        quorum_n = self._resolve_quorum(plan)
        extra: Dict[str, Any] = {}
        if self.faults is None:
            keep_eff, requorumed, quorum_met = self._requorum(plan, quorum_n)
        else:  # the chaos path re-quorums after validation
            keep_eff, requorumed, quorum_met = (
                np.asarray(plan.keep, bool), 0, True)
        keep = np.asarray(keep_eff, np.float32)
        seed_ids, mask_rows, batch_p, keep_p, C = pad_cohort(
            self.executor, np.asarray(plan.seed_ids, np.int32),
            plan.mask_matrix, batch, keep)

        with tel.span("fl.round", round=int(plan.round_idx),
                      cohort=plan.cohort_size, comm_mode=self.comm_mode):
            if self.faults is not None:
                new_state, metrics, bytes_up, extra = self._run_chaos(
                    state, seed_ids, mask_rows, keep_p, batch_p, plan,
                    quorum_n, perturbations)
            elif not quorum_met:
                new_state, metrics = self._skip_round(state)
                bytes_up = 0
            elif self.wire.simulate:
                new_state, metrics, bytes_up = self._run_simulated(
                    state, seed_ids, mask_rows, keep_p, batch_p, plan,
                    keep_eff, perturbations)
            else:
                with tel.span("fl.execute"):
                    new_state, metrics = self._round_direct(
                        state, seed_ids, mask_rows, keep_p, batch_p,
                        perturbations)
                bytes_up = self._estimate_uplink(state.peft, index, plan,
                                                 keep_override=keep_eff)

        if self.faults is None:
            skipped = not quorum_met
            n_validated = 0 if skipped else int(keep_eff.sum())
            health = None
            dropped_frame_ids: List[int] = []
            if quorum_n:
                health = WireHealth(validated=n_validated,
                                    requorumed=requorumed)
        else:
            skipped = extra["round_skipped"]
            quorum_met = extra["quorum_met"]
            n_validated = extra["n_validated"]
            health = extra["health"]
            dropped_frame_ids = extra["dropped_frame_ids"]

        peft_bytes = sum(x.numel() for x in tree_leaves(state.peft)) * 4
        m = self.executor.microbatch or len(seed_ids)
        report = RoundReport(
            round_idx=int(plan.round_idx),
            cohort_size=plan.cohort_size,
            n_requested=plan.n_requested,
            n_survivors=plan.n_survivors,
            dropped_client_ids=[int(c) for c, k in
                                zip(plan.client_ids, plan.keep) if not k],
            deadline=float(plan.deadline),
            bytes_down=plan.downlink_bytes(),
            bytes_up=int(bytes_up),
            wire=self.wire.dtype,
            executor=type(self.executor).__name__,
            n_devices=self.executor.n_devices,
            agg_bytes_streaming=(m + 1) * peft_bytes,
            agg_bytes_stacked=len(seed_ids) * peft_bytes,
            n_validated=n_validated,
            dropped_frame_ids=dropped_frame_ids,
            quorum=quorum_n,
            quorum_met=bool(quorum_met),
            round_skipped=bool(skipped),
            health=health,
        )
        if tel.enabled:
            self._record_round(plan, metrics, report,
                               time.perf_counter() - t_round)
        return new_state, metrics, report

    def _record_round(self, plan: CohortPlan, metrics, report: RoundReport,
                      wall_s: float) -> None:
        """Host-side recording on the round's RETURNED values: the float()
        conversions below copy already-computed tensors to the host (waiting
        for them on the card), never a recompute — the metrics handed back
        to the caller are untouched (bitwise identity asserted in tests).
        The clients' ``jvps`` are not a scalar and not recorded."""
        host = {k: float(v) for k, v in metrics.items() if k != "jvps"}
        # survivors/stragglers derive from the VALIDATED survivor set the
        # aggregator actually used (n_validated == n_survivors on the clean
        # path), so telemetry can never drift from the aggregation
        stragglers = report.cohort_size - report.n_validated
        mask_units = float(
            np.asarray(plan.mask_matrix)[np.asarray(plan.keep, bool)].sum())
        self._tc_rounds.inc()
        self._tc_bytes_up.add(report.bytes_up)
        self._tc_bytes_down.add(report.bytes_down)
        self._tc_stragglers.add(stragglers)
        self._tg_survivors.set(report.n_validated)
        self._tg_mask_units.set(mask_units)
        self._tg_loss.set(host["loss"])
        if "jvp_abs_mean" in host:
            self._tg_jvp.set(host["jvp_abs_mean"])
        if "delta_norm" in host:
            self._tg_delta.set(host["delta_norm"])
        self._th_round_s.observe(wall_s)
        if report.round_skipped:
            self._tc_skipped.inc()
        h = report.health
        if h is not None:
            self._tc_quarantined.add(h.quarantined)
            self._tc_corrupt.add(h.failure_kinds.get("corrupt", 0)
                                 + h.failure_kinds.get("truncated", 0))
            self._tc_lost.add(h.lost)
            self._tc_crashed.add(h.crashed)
            self._tc_dups.add(h.duplicates)
            self._tc_retried.add(h.retries)
            self._tc_invalid.add(h.invalid)
            self._tc_requorumed.add(h.requorumed)
            self._th_retries.observe(h.retries)
            self.telemetry.event(
                "wire_health",
                round=report.round_idx,
                quorum=report.quorum,
                quorum_met=report.quorum_met,
                round_skipped=report.round_skipped,
                dropped_frame_ids=report.dropped_frame_ids,
                **dataclasses.asdict(h),
            )
        self.telemetry.event(
            "round",
            round=report.round_idx,
            comm_mode=self.comm_mode,
            route=("fused" if host.get("fused_route") else "standard"),
            loss=host["loss"],
            jvp_abs_mean=host.get("jvp_abs_mean"),
            delta_norm=host.get("delta_norm"),
            bytes_up=report.bytes_up,
            bytes_down=report.bytes_down,
            cohort=report.cohort_size,
            survivors=report.n_validated,
            stragglers=stragglers,
            dropped=report.dropped_client_ids,
            surviving_mask_units=mask_units,
            executor=report.executor,
            wire=report.wire,
            n_devices=report.n_devices,
            wall_s=round(wall_s, 6),
        )

    # -- wire simulation ------------------------------------------------

    def _arrived(self, payload, jvps, index, rows, C):
        """What ARRIVED, per cohort position: ``rows`` maps position ->
        decoded ClientUpdate; everyone else gets zeros. Per-epoch a list of
        client trees, per-iteration the (C, K) jvps."""
        if self.comm_mode == "per_epoch":
            zeros = tree_map(torch.zeros_like, payload[0])
            return [rows[i].to_delta(zeros, index) if i in rows else zeros
                    for i in range(C)]
        arr = np.zeros((C,) + tuple(jvps.shape[1:]), np.float32)
        for pos, u in rows.items():
            arr[pos] = as_float(u.jvps)
        return torch.as_tensor(arr, device=jvps.device)

    def _run_simulated(self, state, seed_ids, mask_rows, keep, batch, plan,
                       keep_eff, perturbations):
        tel = self.telemetry
        with tel.span("fl.clients"):
            payload, losses, jvps = self._clients(
                state, seed_ids, mask_rows, keep, batch, perturbations)
        with tel.span("fl.wire", n_survivors=int(keep_eff.sum())):
            updates = self.pack_updates(state.peft, payload, jvps, losses,
                                        plan, keep_override=keep_eff)
            bytes_up = sum(u.byte_size() for u in updates)
            # the server only sees what arrived: unpack frames back into
            # the cohort (zeros for dropped clients). Frames carry the
            # fold-in seed_id; cohort POSITION comes from keep order
            # (pack_updates emits survivors in plan order).
            survivor_pos = np.flatnonzero(keep_eff)
            rows = {int(pos): u for pos, u in zip(survivor_pos, updates)}
            arrived = self._arrived(payload, jvps,
                                    enumerate_units(state.peft), rows,
                                    len(seed_ids))
        with tel.span("fl.aggregate"):
            new_state, metrics = self._aggregate(
                state, arrived, seed_ids, mask_rows, keep, losses, jvps,
                perturbations)
        return new_state, metrics, bytes_up

    def _pack_one(self, index, payload, jvps, losses, plan: CohortPlan,
                  i: int) -> ClientUpdate:
        """Serialize cohort row ``i``'s uplink frame."""
        cid, sid = int(plan.client_ids[i]), int(plan.seed_ids[i])
        if self.comm_mode == "per_epoch":
            unit_ids = np.flatnonzero(plan.mask_matrix[i] > 0)
            return ClientUpdate.from_delta(
                payload[i], index, unit_ids, round_idx=plan.round_idx,
                client_id=cid, seed_id=sid, wire=self.wire.dtype,
                loss=float(losses[i]), include_head=self.wire.include_head)
        return ClientUpdate.from_jvps(
            jvps[i], round_idx=plan.round_idx, client_id=cid,
            seed_id=sid, wire=self.wire.dtype, loss=float(losses[i]))

    def pack_updates(self, peft, payload, jvps, losses, plan: CohortPlan,
                     keep_override=None) -> List[ClientUpdate]:
        """Serialize every SURVIVING client's uplink frame."""
        index = enumerate_units(peft)
        keep_vec = plan.keep if keep_override is None else keep_override
        return [self._pack_one(index, payload, jvps, losses, plan, i)
                for i in range(len(plan.client_ids)) if keep_vec[i]]

    # -- chaos path -----------------------------------------------------

    def _run_chaos(self, state, seed_ids, mask_rows, keep, batch, plan,
                   quorum_n, perturbations):
        """Wire simulation under fault injection: every kept client's frame
        runs the full gauntlet (crash -> poison -> retry/loss -> corrupt ->
        strict decode -> dedupe -> validate), quorum re-extends from the
        over-selection pool through the SAME gauntlet, and aggregation sees
        only validated survivors. Returns (state', metrics, bytes_up,
        extra-dict for the RoundReport)."""
        tel = self.telemetry
        inj = self.faults
        inj.take_counters()          # fresh per-round injector tally
        with tel.span("fl.clients"):
            payload, losses, jvps = self._clients(
                state, seed_ids, mask_rows, keep, batch, perturbations)
        index = enumerate_units(state.peft)
        health = WireHealth()
        accepted: Dict[int, ClientUpdate] = {}
        attempted: List[int] = []
        bytes_up = 0

        def push(i: int) -> None:
            nonlocal bytes_up
            cid = int(plan.client_ids[i])
            attempted.append(i)
            scale = (float(plan.crash_scales[i])
                     if plan.crash_scales is not None else 1.0)
            if inj.crashes(cid, plan.round_idx, scale):
                health.crashed += 1
                return
            u = self._pack_one(index, payload, jvps, losses, plan, i)
            mode = inj.poison_mode(cid, plan.round_idx)
            if mode is not None:
                poison_update(inj, u, mode)
            frame = u.to_bytes()
            health.sent += 1
            delivered, attempts, _ = inj.transmit(frame, cid, plan.round_idx)
            bytes_up += len(frame) * attempts   # every attempt burns uplink
            health.transmissions += attempts
            health.retries += attempts - 1
            if not delivered:
                health.lost += 1
                return
            for fb in delivered:
                health.delivered += 1
                if i in accepted:       # at-least-once delivery: dedupe
                    health.duplicates += 1
                    continue
                try:
                    dec = decode_frame(fb)
                except WireError as e:
                    health.quarantined += 1
                    health.failure_kinds[e.kind] = \
                        health.failure_kinds.get(e.kind, 0) + 1
                    continue
                accepted[i] = dec

        with tel.span("fl.wire", chaos=True):
            for i in np.flatnonzero(np.asarray(plan.keep, bool)):
                push(int(i))
            valid = validate_updates(accepted, self.norm_outlier_mult)
            # quorum gate: re-extend deterministically from the
            # over-selection pool in latency order; pool clients run the
            # same chaotic gauntlet (they may crash/corrupt too)
            pool = np.flatnonzero(~np.asarray(plan.keep, bool))
            pool = pool[np.argsort(plan.latencies[pool], kind="stable")]
            pi = 0
            while quorum_n and len(valid) < quorum_n and pi < len(pool):
                i = int(pool[pi])
                pi += 1
                health.requorumed += 1
                push(i)
                valid = validate_updates(accepted, self.norm_outlier_mult)

        health.accepted = len(accepted)
        health.validated = len(valid)
        health.invalid = len(accepted) - len(valid)
        health.backoff_s = inj.take_counters().backoff_s
        quorum_met = (not quorum_n) or len(valid) >= quorum_n
        extra = {
            "n_validated": len(valid),
            "dropped_frame_ids": sorted(int(plan.seed_ids[i])
                                        for i in attempted if i not in valid),
            "quorum_met": quorum_met,
            "round_skipped": not quorum_met,
            "health": health,
        }
        if not quorum_met:
            new_state, metrics = self._skip_round(state)
            return new_state, metrics, bytes_up, extra
        keep_valid = np.zeros(len(seed_ids), np.float32)
        keep_valid[sorted(valid)] = 1.0
        rows = {p: accepted[p] for p in valid}
        arrived = self._arrived(payload, jvps, index, rows, len(seed_ids))
        with tel.span("fl.aggregate"):
            new_state, metrics = self._aggregate(
                state, arrived, seed_ids, mask_rows, keep_valid, losses,
                jvps, perturbations)
        return new_state, metrics, bytes_up, extra

    def _estimate_uplink(self, peft, index, plan: CohortPlan,
                         keep_override=None) -> int:
        """Measured frame size of zero-filled template updates. Frame size
        depends only on the unit-id set and the header-int digit widths, so
        sizes are memoized — no per-round O(|peft|) serialization."""
        if self._zeros_peft is None:
            self._zeros_peft = tree_map(
                lambda x: np.zeros(tuple(x.shape), np.float32), peft)
        total = 0
        K = self.spry_cfg.k_perturbations
        keep_vec = plan.keep if keep_override is None else keep_override
        for i, (cid, k) in enumerate(zip(plan.client_ids, keep_vec)):
            if not k:
                continue
            sid = int(plan.seed_ids[i])
            if self.comm_mode == "per_epoch":
                unit_ids = np.flatnonzero(plan.mask_matrix[i] > 0)
                ckey = (tuple(unit_ids.tolist()),)
            else:
                unit_ids = None
                ckey = (K,)
            ckey += (len(str(int(plan.round_idx))), len(str(int(cid))),
                     len(str(sid)))
            if ckey not in self._uplink_cache:
                if self.comm_mode == "per_epoch":
                    u = ClientUpdate.from_delta(
                        self._zeros_peft, index, unit_ids,
                        round_idx=plan.round_idx, client_id=int(cid),
                        seed_id=sid, wire=self.wire.dtype,
                        include_head=self.wire.include_head)
                else:
                    u = ClientUpdate.from_jvps(
                        np.zeros((K,), np.float32),
                        round_idx=plan.round_idx, client_id=int(cid),
                        seed_id=sid, wire=self.wire.dtype)
                self._uplink_cache[ckey] = u.byte_size()
            total += self._uplink_cache[ckey]
        return total
