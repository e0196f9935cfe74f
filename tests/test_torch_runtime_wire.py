"""The port's wire protocol, fault injector, client population, cohort
scheduler and event heap against the JAX package's, and the engine's
defensive stack inside the port.

Against the reference (exact: bytes, ints, floats compared with ==):
  * ``ClientUpdate`` frames from the same numpy payloads, delta and jvp
    modes, fp32 / bf16 / fp16 wire, and ``TaskAssignment`` frames from the
    same plan, byte for byte; Table 2's payload counts equal;
  * strict decode classifies the same mangled frames the same way;
  * every ``FaultInjector`` decision (crash, poison, loss, retry, mangle,
    duplicate) and ``FaultConfig.parse`` for the same seeds and specs;
  * population shards, batches, tiers, latencies and availability, and
    ``CohortScheduler.plan_round`` (client ids, seed ids, mask, latencies,
    keep, deadline) for the same seeds;
  * ``EventHeap`` snapshots and pop order, ``sample_available``, and both
    utilization simulators.

Inside the port, bitwise: a chaos engine with every rate 0 equals the clean
simulated wire; each targeted bad client (corrupt frame, NaN payload,
norm-outlier payload) equals that client excluded, a duplicated frame the
clean round; the clean requorum equals the manually extended plan.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core.assignment import enumerate_units as jenumerate_units
from repro.fl import comm_cost as jcomm_cost
from repro.fl.runtime import events as jevents
from repro.fl.runtime import faults as jfaults
from repro.fl.runtime import messages as jmsg
from repro.fl.runtime import population as jpop
from repro.peft import init_peft as jinit_peft
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.core import enumerate_units, init_state
from repro_torch.core.assignment import assignment_matrix
from repro_torch.fl import comm_cost
from repro_torch.fl.runtime import (
    ClientPopulation,
    ClientUpdate,
    CohortPlan,
    CohortScheduler,
    EventHeap,
    FaultConfig,
    FaultInjector,
    FederationEngine,
    TaskAssignment,
    WireConfig,
    WireError,
    decode_frame,
    sample_available,
    simulate_async_utilization,
    simulate_sync_utilization,
)
from repro_torch.fl.runtime import messages as tmsg
from repro_torch.fl.runtime.messages import as_float
from repro_torch.models import get_model
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def peft_np():
    """The reference's reduced-roberta peft tree as numpy, its unit index,
    and a random delta of the same shapes (numpy, fp32)."""
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    jpeft = jax.tree.map(np.asarray, jax.jit(jinit_peft, static_argnums=(0, 2))(
        jc, jax.random.PRNGKey(0), jcfgs.SpryConfig()))
    rng = np.random.default_rng(5)
    delta = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                         jpeft)
    return jpeft, delta, jenumerate_units(jpeft)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("wire", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("mode", ["delta", "jvp"])
def test_update_frames_byte_identical(peft_np, wire, mode):
    jpeft, delta, jindex = peft_np
    tdelta = _torch_tree(delta)
    tindex = enumerate_units(tdelta)
    assert tindex.units == jindex.units
    kw = dict(round_idx=7, client_id=123456, seed_id=3, wire=wire, loss=0.625)
    if mode == "delta":
        unit_ids = np.array([0, 2, 3])
        ref = jmsg.ClientUpdate.from_delta(delta, jindex, unit_ids, **kw)
        got = ClientUpdate.from_delta(tdelta, tindex, unit_ids, **kw)
    else:
        jv = np.random.default_rng(1).standard_normal(8).astype(np.float32)
        ref = jmsg.ClientUpdate.from_jvps(jv, **kw)
        got = ClientUpdate.from_jvps(torch.from_numpy(jv), **kw)
    assert got.to_bytes() == ref.to_bytes()
    assert got.byte_size() == ref.byte_size()
    assert got.payload_byte_size() == ref.payload_byte_size()
    assert got.payload_byte_size(False) == ref.payload_byte_size(False)
    ref.base_version, got.base_version = 5, 5        # the async staleness tag
    ref.invalidate_encoding()
    got.invalidate_encoding()
    assert got.to_bytes() == ref.to_bytes()
    # the reference's frame decodes in the port to the reference's values
    dec = decode_frame(ref.to_bytes())
    assert isinstance(dec, ClientUpdate) and dec.base_version == 5
    if mode == "delta":
        want = ref.to_delta(jpeft, jindex)
        have = dec.to_delta(_torch_tree(jpeft), tindex)
        for a, b in zip(jax.tree.leaves(want), tree_leaves(have)):
            assert np.array_equal(np.asarray(a), b.numpy())
    else:
        assert np.array_equal(as_float(dec.jvps),
                              np.asarray(ref.jvps, np.float32))


def _plans(**kw):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, size=(512, 16))
    y = rng.integers(0, 4, size=(512,))
    ref = jpop.CohortScheduler(jpop.ClientPopulation(x, y, 100_000, seed=4), **kw)
    got = CohortScheduler(ClientPopulation(x, y, 100_000, seed=4), **kw)
    return ref, got


@pytest.mark.parametrize("deadline,dropout", [(None, 0.25), (9.0, 0.0)])
def test_scheduler_plans_equal_reference(deadline, dropout):
    ref, got = _plans(cohort_size=8, over_select=1.5, deadline=deadline,
                      dropout_rate=dropout, seed=2)
    for r in range(4):
        a = ref.plan_round(r, n_units=48, spry_seed=1, hparams={"lr": 0.5})
        b = got.plan_round(r, n_units=48, spry_seed=1, hparams={"lr": 0.5})
        for f in ("client_ids", "seed_ids", "mask_matrix", "latencies", "keep",
                  "crash_scales"):
            ga, gb = getattr(a, f), getattr(b, f)
            assert ga.dtype == gb.dtype and np.array_equal(ga, gb), f
        assert (a.deadline, a.n_requested) == (b.deadline, b.n_requested)
        assert [x.to_bytes() for x in a.assignments] == \
            [x.to_bytes() for x in b.assignments]
        assert a.downlink_bytes() == b.downlink_bytes()
        for u, v in zip(ref.round_batch(a, 4), got.round_batch(b, 4)):
            assert np.array_equal(u, v)
    back = TaskAssignment.from_bytes(b.assignments[1].to_bytes())
    assert np.array_equal(back.mask_row(), b.mask_matrix[1])


def test_population_equal_reference():
    ref, got = _plans(cohort_size=4)
    rp, gp = ref.population, got.population
    for c in (0, 17, 99_999):
        assert np.array_equal(rp.shard(c), gp.shard(c))
        assert (dataclasses.asdict(rp.device_tier(c))
                == dataclasses.asdict(gp.device_tier(c)))
        for r in (0, 5, 47, 48):
            assert rp.latency(c, r) == gp.latency(c, r)
            assert rp.compute_seconds(c, r) == gp.compute_seconds(c, r)
            assert rp.uplink_seconds(c, r) == gp.uplink_seconds(c, r)
            assert rp.available(c, r) == gp.available(c, r)
            for u, v in zip(rp.client_batch(c, r, 3), gp.client_batch(c, r, 3)):
                assert np.array_equal(u, v)


def test_table2_byte_counts_equal_reference(peft_np):
    """per-epoch uplink = w_l * max(L/M, 1) scalars, per-iteration K
    scalars (Table 2), in the port as in the reference."""
    _, delta, jindex = peft_np
    U, M = jindex.n_units, 2
    A = delta["layers"]["wq"]["A"]               # (L, d, r): one unit's A
    w_l = 2 * A.shape[1] * A.shape[2]            # LoRA A and B of one unit
    analytic = comm_cost("spry", "per_epoch", w_l, U, M).client_to_server
    assert analytic == jcomm_cost("spry", "per_epoch", w_l, U, M).client_to_server
    tdelta = _torch_tree(delta)
    u = ClientUpdate.from_delta(tdelta, enumerate_units(tdelta), np.arange(U // M),
                                round_idx=0, client_id=0, seed_id=0,
                                include_head=False)
    ref = jmsg.ClientUpdate.from_delta(delta, jindex, np.arange(U // M),
                                       round_idx=0, client_id=0, seed_id=0,
                                       include_head=False)
    assert u.n_payload_scalars() == ref.n_payload_scalars() == int(analytic)
    assert u.payload_byte_size() == ref.payload_byte_size() == int(analytic) * 4
    per_iter = comm_cost("spry", "per_iteration", w_l, U, M).client_to_server
    v = ClientUpdate.from_jvps(np.zeros(1, np.float32), round_idx=0,
                               client_id=0, seed_id=0)
    assert v.n_payload_scalars() == int(per_iter) == 1
    assert v.byte_size() == jmsg.ClientUpdate.from_jvps(
        np.zeros(1, np.float32), round_idx=0, client_id=0, seed_id=0).byte_size()


def _kind(mod, frame):
    try:
        mod.decode_frame(frame)
        return "ok"
    except mod.WireError as e:
        return e.kind


def test_strict_decode_classifies_as_reference(peft_np):
    _, delta, jindex = peft_np
    frame = jmsg.ClientUpdate.from_delta(delta, jindex, [1], round_idx=1,
                                         client_id=2, seed_id=1).to_bytes()
    rng = np.random.default_rng(3)
    cases = [frame, frame[:5], frame[:11], frame[:len(frame) // 2], frame[:-1],
             frame + b"\x00", b"SPU1" + frame[4:], b"XXXX" + frame[4:],
             b"SPA2" + frame[4:], frame[:8] + b"{" + frame[9:]]
    for _ in range(40):
        buf = bytearray(frame)
        buf[int(rng.integers(0, len(buf)))] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(buf))
    kinds = [_kind(jmsg, f) for f in cases]
    assert kinds == [_kind(tmsg, f) for f in cases]
    assert kinds[0] == "ok" and {"truncated", "corrupt", "version_mismatch",
                                 "bad_magic", "shape_mismatch"} <= set(kinds)
    with pytest.raises(WireError):
        decode_frame(cases[1])


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["off", "mild", "aggressive",
                                  "crash_rate=0.3,max_retries=5,seed=9", ""])
def test_fault_config_parse_equals_reference(spec):
    assert dataclasses.asdict(FaultConfig.parse(spec, seed=4)) == \
        dataclasses.asdict(jfaults.FaultConfig.parse(spec, seed=4))
    for bad in ("nope=1", "crash_rate", "crash_rate=2"):
        with pytest.raises(ValueError):
            FaultConfig.parse(bad)


def test_fault_injector_decisions_equal_reference():
    spec = dict(crash_rate=0.2, corrupt_rate=0.4, loss_rate=0.3, nan_rate=0.1,
                blowup_rate=0.1, max_retries=3, seed=11)
    ref = jfaults.FaultInjector(jfaults.FaultConfig(**spec))
    got = FaultInjector(FaultConfig(**spec))
    frame = bytes(np.random.default_rng(0).integers(0, 256, 300, np.uint8))
    arr = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    for c in range(40):
        for r in range(3):
            assert ref.crashes(c, r, 2.5) == got.crashes(c, r, 2.5)
            mode = ref.poison_mode(c, r)
            assert mode == got.poison_mode(c, r)
            if mode is not None:
                assert np.array_equal(ref.poison_array(arr, mode),
                                      got.poison_array(arr, mode), equal_nan=True)
            assert ref.transmit(frame, c, r) == got.transmit(frame, c, r)
    assert dataclasses.asdict(ref.take_counters()) == \
        dataclasses.asdict(got.take_counters())


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

def test_event_heap_and_simulators_equal_reference():
    ref, got = jevents.EventHeap(), EventHeap()
    times = [3.0, 1.0, 1.0, 2.5, 1.0, 0.5]
    for i, t in enumerate(times):
        ref.push(t, {"i": i})
        got.push(t, {"i": i})
    assert got.snapshot() == ref.snapshot()
    restored = EventHeap.restore(got.snapshot())
    order = [restored.pop() for _ in times]
    assert order == [ref.pop() for _ in times]
    assert [p["i"] for _, _, p in order] == [5, 1, 2, 4, 3, 0]

    rpop, gpop = _plans(cohort_size=4)
    rpop, gpop = rpop.population, gpop.population
    assert [sample_available(gpop, t, d, 3) for t in range(3) for d in range(5)] == \
        [jevents.sample_available(rpop, t, d, 3) for t in range(3) for d in range(5)]
    kw = dict(cohort=6, rounds=3, over_select=1.5, dropout_rate=0.1, seed=2)
    assert simulate_sync_utilization(gpop, **kw).to_doc() == \
        jevents.simulate_sync_utilization(rpop, **kw).to_doc()
    kw = dict(concurrency=6, buffer_size=3, server_steps=4, dropout_rate=0.1,
              seed=2, max_staleness=2)
    assert simulate_async_utilization(gpop, **kw).to_doc() == \
        jevents.simulate_async_utilization(rpop, **kw).to_doc()


# ---------------------------------------------------------------------------
# the engine's defensive stack (inside the port, bitwise)
# ---------------------------------------------------------------------------

J = 4          # target client: shares unit 0 with client 0 (M=5 > U=4)


def _plan(M, n_units, keep=None, latencies=None):
    return CohortPlan(
        round_idx=0, client_ids=np.arange(M, dtype=np.int64),
        seed_ids=np.arange(M, dtype=np.int32),
        mask_matrix=assignment_matrix(n_units, M, 0).numpy(),
        latencies=(np.zeros(M) if latencies is None
                   else np.asarray(latencies, np.float64)),
        deadline=float("inf"),
        keep=np.ones(M, bool) if keep is None else np.asarray(keep, bool),
        assignments=[], n_requested=M)


@pytest.fixture(scope="module")
def ctx():
    cfg = reduce_config(get_config("roberta-large-lora"))
    sc = SpryConfig(n_clients_per_round=5, local_iters=1, local_lr=1e-2,
                    server_lr=1e-2, k_perturbations=2)
    gen = torch.Generator().manual_seed(0)
    state = init_state(get_model(cfg).init_base(cfg, gen), init_peft(cfg, gen, sc))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (5, 2, 16))),
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes, (5, 2)))}
    U = enumerate_units(state.peft).n_units
    keep = np.ones(5, bool)
    keep[J] = False
    ref = FederationEngine(cfg, sc, wire=WireConfig(simulate=True))
    chaos = FederationEngine(cfg, sc, wire=WireConfig(simulate=True),
                             faults=FaultConfig(seed=3))
    return dict(cfg=cfg, sc=sc, state=state, batch=batch, U=U, ref=ref,
                chaos=chaos, full=ref.run_round(state, _plan(5, U), batch),
                excl=ref.run_round(state, _plan(5, U, keep), batch))


def _arm(eng, faults=None, quorum=None):
    eng.faults = FaultInjector(faults) if isinstance(faults, FaultConfig) else faults
    eng.quorum = quorum
    return eng


def assert_rounds_equal(a, b):
    (sa, ma, _), (sb, mb, _) = a, b
    for x, y in zip(tree_leaves(sa.peft) + tree_leaves(sa.server.m)
                    + tree_leaves(sa.server.v) + [ma[k] for k in sorted(ma)],
                    tree_leaves(sb.peft) + tree_leaves(sb.server.m)
                    + tree_leaves(sb.server.v) + [mb[k] for k in sorted(mb)]):
        assert torch.equal(x, y)
    assert sorted(ma) == sorted(mb)


def test_zero_rate_chaos_bitwise_equals_clean_wire(ctx):
    got = _arm(ctx["chaos"], FaultConfig(seed=3)).run_round(
        ctx["state"], _plan(5, ctx["U"]), ctx["batch"])
    assert_rounds_equal(got, ctx["full"])
    rep = got[2]
    assert rep.health.validated == rep.n_validated == 5
    assert rep.health.quarantined == 0 and rep.dropped_frame_ids == []
    assert rep.bytes_up == ctx["full"][2].bytes_up


class _TargetCorrupt(FaultInjector):
    def __init__(self, target):
        super().__init__(FaultConfig(seed=0))
        self.target = target

    def transmit(self, frame, client_id, round_idx):
        if client_id == self.target:
            bad = bytearray(frame)
            bad[len(bad) // 2] ^= 0x10
            return [bytes(bad)], 1, 0.0
        return [frame], 1, 0.0


class _TargetPoison(FaultInjector):
    def __init__(self, target, mode="nan", **kw):
        super().__init__(FaultConfig(seed=0, **kw))
        self.target, self.mode = target, mode

    def poison_mode(self, client_id, round_idx):
        return self.mode if client_id == self.target else None


class _TargetDuplicate(FaultInjector):
    def __init__(self, target):
        super().__init__(FaultConfig(seed=0))
        self.target = target

    def transmit(self, frame, client_id, round_idx):
        return ([frame, frame] if client_id == self.target else [frame]), 1, 0.0


@pytest.mark.parametrize("make,field", [
    (lambda: _TargetCorrupt(J), "quarantined"),
    (lambda: _TargetPoison(J, "nan"), "invalid"),
    (lambda: _TargetPoison(J, "blowup", blowup_scale=1e8), "invalid"),
    (lambda: _TargetDuplicate(J), "duplicates")],
    ids=["corrupt", "nan", "blowup", "duplicate"])
def test_bad_client_bitwise_equals_excluded_client(ctx, make, field):
    """A quarantined or rejected client is aggregated exactly as if its
    update never arrived; a duplicated frame dedupes to the clean round."""
    got = _arm(ctx["chaos"], make()).run_round(ctx["state"], _plan(5, ctx["U"]),
                                               ctx["batch"])
    rep = got[2]
    assert getattr(rep.health, field) == 1
    if field == "duplicates":
        assert rep.n_validated == 5
        assert_rounds_equal(got, ctx["full"])
    else:
        assert rep.n_validated == 4 and rep.dropped_frame_ids == [J]
        assert_rounds_equal(got, ctx["excl"])


def test_all_poisoned_round_skips_server_step(ctx):
    s2, m2, r2 = _arm(ctx["chaos"], FaultConfig(nan_rate=1.0, seed=0),
                      quorum=1.0).run_round(ctx["state"], _plan(5, ctx["U"]),
                                            ctx["batch"])
    assert r2.round_skipped and not r2.quorum_met and r2.quorum == 5
    assert r2.n_validated == 0 and r2.health.invalid == 5
    for a, b in zip(tree_leaves(s2.peft), tree_leaves(ctx["state"].peft)):
        assert torch.equal(a, b)
    assert s2.round_idx == 1 and np.isnan(float(m2["loss"]))


def test_clean_requorum_bitwise_equals_manual_extension(ctx):
    """Below quorum, the clean path re-extends the survivors from the pool
    in latency order — the round of a plan that kept those clients."""
    lat = np.array([1.0, 2.0, 3.0, 9.0, 4.0])
    keep = np.array([True, True, False, False, False])
    got = _arm(ctx["ref"], quorum=4).run_round(
        ctx["state"], _plan(5, ctx["U"], keep, lat), ctx["batch"])
    _arm(ctx["ref"])
    manual = ctx["ref"].run_round(
        ctx["state"], _plan(5, ctx["U"], [True, True, True, False, True], lat),
        ctx["batch"])
    rep = got[2]
    assert rep.health.requorumed == 2 and rep.quorum_met
    assert rep.n_validated == 4 and not rep.round_skipped
    assert_rounds_equal(got, manual)
    assert rep.bytes_up == manual[2].bytes_up
    skipped = _arm(ctx["ref"], quorum=6).run_round(
        ctx["state"], _plan(5, ctx["U"]), ctx["batch"])
    _arm(ctx["ref"])
    assert skipped[2].round_skipped and skipped[2].bytes_up == 0
