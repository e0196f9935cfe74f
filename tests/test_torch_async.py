"""The port's FedBuff-style async engine (``AsyncFederationEngine``), inside
the port, bitwise (the peft's content hash, losses and virtual clocks
compared with ==):

  * two fresh engines over the same population replay identically, under
    the fault schedule;
  * a snapshot taken mid-run (through JSON, as the manifest stores it) and
    restored into a fresh engine continues exactly as the uninterrupted
    run, per-epoch and per-iteration, under the fault schedule;
  * the first server step (an all-fresh buffer, every weight 1) equals the
    synchronous engine's round over the same clients, seed ids, unit rows
    and batches;
  * a run killed after 1 of 2 server versions and resumed through
    ``run_training`` ends where the straight run ends.

Against the JAX package's ``AsyncFederationEngine``, at reduced roberta
with the reference's perturbations injected (keyed by dispatch index), both
comm modes, 3 server versions under the fault schedule with late arrivals:

  * exactly: every version's aggregated client ids and seed ids, staleness
    list, virtual clock, byte totals, ``WireHealth``, useful and discarded
    compute, events, buffer and in-flight counts, also with a
    ``max_staleness`` that discards an update;
  * loss within 1e-5 relative, the final PEFT within 1e-5 of its largest
    entry (as the sync engine's cross-package test);
  * ``_aggregate`` alone, on the reference's own decoded frames of a buffer
    with staleness > 0 and from the reference's state before that step:
    the new PEFT within 1e-5 of its largest entry, the update itself
    (new - old) within 1e-4 relative, staleness and loss as above. This
    holds the staleness weights (1+s)^-a, the unit rows of the per-epoch
    frames and the per-iteration rebuild with a stale version tag.

The event simulation's own draws (population, events, faults) are held
against the reference in test_torch_runtime_wire.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import forward_grad as jfg
from repro.core.spry import init_state as jinit_state
from repro.fl import runtime as jrt
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch.checkpoint import (
    decode_async_snapshot,
    encode_async_snapshot,
    read_manifest,
    tree_content_hash,
)
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.convert import from_reference, peft_from_reference
from repro_torch.core import SpryState, init_state
from repro_torch.fl.server import ServerState
from repro_torch.fl.runtime import (
    AsyncConfig,
    AsyncFederationEngine,
    ClientPopulation,
    CohortPlan,
    FaultConfig,
    FederationEngine,
    WireConfig,
    decode_frame,
)
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)
_CHAOS = FaultConfig(crash_rate=0.1, loss_rate=0.1, corrupt_rate=0.05,
                     nan_rate=0.05, blowup_rate=0.05, seed=3)


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_config(get_config("roberta-large-lora"))
    sc = SpryConfig(n_clients_per_round=4, local_iters=1, local_lr=1e-2,
                    server_lr=1e-2, k_perturbations=2)
    gen = torch.Generator().manual_seed(0)
    state = init_state(get_model(cfg).init_base(cfg, gen), init_peft(cfg, gen, sc))
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.vocab, size=(256, 16), dtype=np.int64)
    y = rng.integers(0, cfg.n_classes, size=(256,), dtype=np.int64)
    return cfg, sc, state, x, y


def _engine(setup, mode="per_epoch", faults=None, **overrides):
    cfg, sc, _, x, y = setup
    kw = dict(buffer_size=2, staleness_decay=0.5, concurrency=4, seed=11)
    kw.update(overrides)
    return AsyncFederationEngine(cfg, sc, ClientPopulation(x, y, 1000, seed=7),
                                 comm_mode=mode, async_cfg=AsyncConfig(**kw),
                                 wire=WireConfig(simulate=True), faults=faults)


def _run(eng, state, n):
    s, losses, clocks, stale = state, [], [], []
    for _ in range(n):
        s, m, rep = eng.run_version(s, batch_size=2)
        losses.append(float(m["loss"]))
        clocks.append(rep.sim_time_s)
        stale.append(rep.staleness)
    return s, losses, clocks, stale


def test_async_replay_is_bitwise(setup):
    runs = []
    for _ in range(2):
        s, losses, clocks, stale = _run(_engine(setup, faults=_CHAOS), setup[2], 3)
        runs.append((tree_content_hash(s), losses, clocks, stale))
    assert runs[0] == runs[1]
    assert any(x > 0 for st in runs[0][3] for x in st)     # late arrivals landed


@pytest.mark.parametrize("mode", ["per_epoch", "per_iteration"])
def test_async_kill_and_resume_bitwise_under_chaos(setup, mode):
    state = setup[2]
    ref, ref_losses, ref_clocks, _ = _run(_engine(setup, mode, _CHAOS), state, 3)
    a = _engine(setup, mode, _CHAOS)
    s, _, _, _ = _run(a, state, 1)
    doc = json.loads(json.dumps(encode_async_snapshot(a.snapshot())))
    b = _engine(setup, mode, _CHAOS)
    b.restore(decode_async_snapshot(doc))
    s, losses, clocks, _ = _run(b, s, 2)
    assert tree_content_hash(s) == tree_content_hash(ref)
    assert losses == ref_losses[1:] and clocks == ref_clocks[1:]


def test_async_version_mismatch_and_max_staleness(setup):
    state = setup[2]
    eng = _engine(setup)
    eng.run_version(state, batch_size=2)          # the engine is at version 1
    with pytest.raises(ValueError, match="out of step"):
        eng.run_version(state, batch_size=2)
    strict = _engine(setup, max_staleness=0)
    _, _, _, stale = _run(strict, state, 3)
    assert all(x == 0 for st in stale for x in st)
    loose = _engine(setup)
    _run(loose, state, 3)
    assert strict.discarded_compute_s > loose.discarded_compute_s
    with pytest.raises(ValueError, match="concurrency"):
        AsyncConfig(buffer_size=4, concurrency=2)


def test_fresh_buffer_equals_sync_round_over_the_same_clients(setup):
    """Version 0 -> 1 aggregates two fresh updates (weights 1): the sync
    engine's wire-simulated round over those two clients (seed id = dispatch
    index, the async unit rows, the population's batches) gives the same
    new peft and server state, bit for bit."""
    cfg, sc, state, _, _ = setup
    eng = _engine(setup, staleness_decay=0.9)
    taken = []
    real = eng._aggregate
    eng._aggregate = lambda st, entries: (taken.extend(entries), real(st, entries))[1]
    s_async, _, rep = eng.run_version(state, batch_size=2)
    assert rep.staleness == [0, 0]
    ds = [e["update"].seed_id for e in taken]
    cids = [e["update"].client_id for e in taken]
    batches = [eng.population.client_batch(c, d, 2) for c, d in zip(cids, ds)]
    plan = CohortPlan(
        round_idx=0, client_ids=np.asarray(cids, np.int64),
        seed_ids=np.asarray(ds, np.int32),
        mask_matrix=np.stack([eng._mask_row(d) for d in ds]),
        latencies=np.zeros(2), deadline=float("inf"), keep=np.ones(2, bool),
        assignments=[], n_requested=2)
    batch = {"tokens": torch.as_tensor(np.stack([b[0] for b in batches])),
             "labels": torch.as_tensor(np.stack([b[1] for b in batches]))}
    s_sync, _, _ = FederationEngine(cfg, sc, wire=WireConfig(simulate=True)
                                    ).run_round(state, plan, batch)
    for a, b in zip(tree_leaves(s_async.peft) + tree_leaves(s_async.server.v),
                    tree_leaves(s_sync.peft) + tree_leaves(s_sync.server.v)):
        assert torch.equal(a, b)


def test_async_run_training_kill_and_resume_bitwise(tmp_path):
    kw = dict(rounds=2, clients_per_round=4, total_clients=16, batch_size=2,
              k_perturbations=2, eval_every=1, async_mode=True, buffer_size=2,
              async_concurrency=4, max_staleness=2, faults="mild",
              device="cpu", log=lambda *a: None)
    a, b = str(tmp_path / "straight"), str(tmp_path / "killed")
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    full = ttrain.run_training(checkpoint_dir=a, **kw)
    ttrain.run_training(checkpoint_dir=b, **dict(kw, rounds=1))
    resumed = ttrain.run_training(checkpoint_dir=b, resume=True, **kw)

    def hist(h):
        return json.dumps([{k: v for k, v in e.items()
                            if k not in ("t", "round_s", "round_peak_bytes")}
                           for e in h], sort_keys=True)
    assert hist(full) == hist(resumed)
    assert read_manifest(a).content_hash == read_manifest(b).content_hash
    assert "async" in read_manifest(b).extra and full[-1]["bytes_up"] > 0


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

MODES = ("per_epoch", "per_iteration")
VERSIONS = 3
# (comm mode, max_staleness): the third case discards the staleness-2 update
CASES = (("per_epoch", None), ("per_iteration", None), ("per_epoch", 1))
_ASYNC = dict(buffer_size=2, staleness_decay=0.5, concurrency=4, seed=11)
_CHAOS_KW = dict(crash_rate=0.1, loss_rate=0.1, corrupt_rate=0.05,
                 nan_rate=0.05, blowup_rate=0.05, seed=3)


def _recorded(eng, log):
    """Record each ``_aggregate`` call of ``eng`` (its version, the state it
    starts from, the entries as frames, and what it returns) and each
    dispatch's server version."""
    real_agg, real_dispatch = eng._aggregate, eng._dispatch

    def aggregate(state, entries):
        version = eng.version
        out = real_agg(state, entries)
        log["aggs"].append(dict(
            version=version, state=state, out=out,
            entries=[(e["update"].to_bytes(), e["dispatch_version"], e["compute_s"])
                     for e in entries],
            client_ids=[e["update"].client_id for e in entries],
            seed_ids=[e["update"].seed_id for e in entries]))
        return out

    def dispatch(state, batch_size, health):
        log["dispatch_version"][eng.dispatched] = eng.version
        return real_dispatch(state, batch_size, health)
    eng._aggregate, eng._dispatch = aggregate, dispatch
    return eng


def _versions(eng, state, log):
    out = []
    for _ in range(VERSIONS):
        state, m, rep = eng.run_version(state, batch_size=2)
        agg = log["aggs"][-1]
        out.append(dict(client_ids=agg["client_ids"], seed_ids=agg["seed_ids"],
                        staleness=rep.staleness, sim_time_s=rep.sim_time_s,
                        bytes_up=rep.bytes_up, bytes_down=rep.bytes_down,
                        health=dataclasses.asdict(rep.health),
                        useful_compute_s=rep.useful_compute_s,
                        discarded_compute_s=rep.discarded_compute_s,
                        events=rep.events_processed, in_flight=rep.in_flight,
                        buffered=rep.buffer_occupancy,
                        loss=float(m["loss"])))
    return state, out


@pytest.fixture(scope="module")
def reference_async():
    """The reference engine's 3 versions a case, recorded, and its
    perturbations keyed by dispatch index for the port."""
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    jsc = jcfgs.SpryConfig(n_clients_per_round=4, local_iters=1, local_lr=5e-3,
                           server_lr=1e-2, k_perturbations=2, seed=3)
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1), jsc)
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(
            k, jpeft["layers"][t]["B"].shape)
    rng = np.random.default_rng(0)
    x = rng.integers(0, jc.vocab, size=(256, 16), dtype=np.int64)
    y = rng.integers(0, jc.n_classes, size=(256,), dtype=np.int64)
    peft32 = jax.tree.map(lambda a: a.astype(jnp.float32), jpeft)
    draw = jax.jit(jfg.stacked_perturbations)
    out, jitted = {}, {}
    for mode, max_staleness in CASES:
        log = {"aggs": [], "dispatch_version": {}}
        eng = _recorded(jrt.AsyncFederationEngine(
            jc, jsc, jrt.ClientPopulation(x, y, n_clients=1000, seed=7),
            comm_mode=mode, async_cfg=jrt.AsyncConfig(
                max_staleness=max_staleness, **_ASYNC),
            wire=jrt.WireConfig(simulate=True),
            faults=jrt.FaultInjector(jrt.FaultConfig(**_CHAOS_KW))), log)
        # a mode's jitted client and aggregation read only the configs that
        # the cases share: compile them once a mode
        eng._client_jit, eng._agg_jit = jitted.setdefault(
            mode, (eng._client_jit, eng._agg_jit))
        state, versions = _versions(eng, jinit_state(jbase, jpeft), log)
        base_key = jax.random.PRNGKey(jsc.seed)
        perts = {d: [tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(
            np.asarray, draw(jax.random.fold_in(jax.random.fold_in(
                jax.random.fold_in(base_key, v), d), 0), peft32,
                jnp.arange(jsc.k_perturbations))))]
            for d, v in log["dispatch_version"].items()}
        out[mode, max_staleness] = dict(state=state, versions=versions, aggs=log["aggs"],
                         dispatch_version=log["dispatch_version"], perts=perts)
    return dict(jc=jc, jsc=jsc, jbase=jbase, jpeft=jpeft, x=x, y=y, modes=out)


def _port(ref, mode, max_staleness=None):
    tc = reduce_config(get_config("roberta-large-lora"))
    tsc = SpryConfig(**dataclasses.asdict(ref["jsc"]))
    eng = AsyncFederationEngine(
        tc, tsc, ClientPopulation(ref["x"], ref["y"], 1000, seed=7),
        comm_mode=mode, async_cfg=AsyncConfig(max_staleness=max_staleness, **_ASYNC),
        wire=WireConfig(simulate=True), faults=FaultConfig(**_CHAOS_KW),
        perturbations=ref["modes"][mode, max_staleness]["perts"])
    return tc, eng


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_port_state(tc, jstate):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    base, peft = from_reference(tc, np_tree(jstate.base), np_tree(jstate.peft), "cpu")
    server = ServerState(int(jstate.server.count),
                         peft_from_reference(tc, np_tree(jstate.server.m), "cpu"),
                         peft_from_reference(tc, np_tree(jstate.server.v), "cpu"))
    return SpryState(base, peft, server, int(jstate.round_idx))


@pytest.mark.parametrize("mode,max_staleness", CASES)
def test_async_versions_match_reference_engine(reference_async, mode, max_staleness):
    ref = reference_async
    r = ref["modes"][mode, max_staleness]
    tc, eng = _port(ref, mode, max_staleness)
    log = {"aggs": [], "dispatch_version": {}}
    _recorded(eng, log)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, ref["jbase"]),
                                  jax.tree.map(np.asarray, ref["jpeft"]), "cpu")
    ts, got = _versions(eng, init_state(tbase, tpeft), log)
    assert log["dispatch_version"] == r["dispatch_version"]
    exact = ("client_ids", "seed_ids", "staleness", "sim_time_s", "bytes_up",
             "bytes_down", "health", "useful_compute_s", "discarded_compute_s",
             "events", "in_flight", "buffered")
    for g, w in zip(got, r["versions"]):
        assert {k: g[k] for k in exact} == {k: w[k] for k in exact}
        assert _rel(g["loss"], w["loss"]) <= 1e-5
    assert any(s > 0 for v in got for s in v["staleness"])      # late arrivals
    if max_staleness is not None:                   # an update was too stale
        assert all(s <= max_staleness for v in got for s in v["staleness"])
        assert got[-1]["discarded_compute_s"] > ref["modes"][mode, None][
            "versions"][-1]["discarded_compute_s"]
    assert sum(v["health"]["crashed"] + v["health"]["quarantined"]
               + v["health"]["invalid"] for v in got) > 0       # faults landed
    for t_new, j_new in zip(tree_leaves(ts.peft), jax.tree.leaves(r["state"].peft)):
        assert _rel(t_new.numpy(), j_new) <= 1e-5
    assert ts.round_idx == int(r["state"].round_idx) == VERSIONS


@pytest.mark.parametrize("mode", MODES)
def test_async_aggregate_matches_reference_on_stale_buffer(reference_async, mode):
    ref = reference_async
    r = ref["modes"][mode, None]
    agg = next(a for a in r["aggs"] if any(
        a["version"] - dv > 0 for _, dv, _ in a["entries"]))
    tc, eng = _port(ref, mode)
    tstate = _to_port_state(tc, agg["state"])
    eng._ensure_static(tstate)
    eng.version = agg["version"]
    entries = [{"update": decode_frame(fb), "dispatch_version": dv, "compute_s": cs}
               for fb, dv, cs in agg["entries"]]
    eng.buffer = list(entries)
    new, out = eng._aggregate(tstate, entries)
    jnew, jout = agg["out"]
    assert out["staleness"] == jout["staleness"] and max(out["staleness"]) > 0
    assert len(set(out["staleness"])) > 1            # the weights differ
    assert _rel(out["metrics"]["loss"], jout["metrics"]["loss"]) <= 1e-5
    for t_new, j_new, old in zip(tree_leaves(new.peft), jax.tree.leaves(jnew.peft),
                                 jax.tree.leaves(agg["state"].peft)):
        assert _rel(t_new.numpy(), j_new) <= 1e-5
        old = np.asarray(old, np.float64)
        assert _rel(t_new.double().numpy() - old,
                    np.asarray(j_new, np.float64) - old) <= 1e-4
    assert new.server.count == int(jnew.server.count) and eng.version == agg["version"] + 1
