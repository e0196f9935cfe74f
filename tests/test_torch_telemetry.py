"""The port's telemetry wired through the federation engines, ``run_training``
and the serving engine, against the JAX package's and against telemetry off.

Against the reference (``Telemetry(sinks=[InMemorySink()])`` on both sides):
  * ``FederationEngine.run_round``, reduced roberta, both comm modes, the
    same state (``convert.from_reference``), a plan with one client dropped,
    the same batch, the reference's perturbations injected, a seeded fault
    schedule on the simulated wire (``wire_health`` fires) and a quorum that
    pulls the dropped client back: the same event kinds in the same order,
    the same keys in each event, integer fields equal, float fields within
    1e-5 relative (``ts`` and ``wall_s`` aside), equal counter values and
    histogram counts in the final ``metrics`` snapshot;
  * ``AsyncFederationEngine``, 3 versions under the fault schedule of
    test_torch_async with the reference's perturbations keyed by dispatch
    index: the ``async_round`` events and the ``fl.async.*`` and fault
    counters the same way;
  * ``run_training``, reduced, in process, 2 rounds, eval every round (the
    telemetry-on run of the neutrality test's standard case, a module
    fixture): the same event kinds in the same order and the same keys in
    each (the values
    differ: the port draws its perturbations from a ``torch.Generator``; the
    reference's personalized accuracy, whose value is not compared, is a
    constant to save its ~30 s of eager forward gradients);
  * a reduced llama2 ``ServingEngine`` through ``run_engine``: the same
    ``request`` event keys, equal ``serve.*`` and ``adapter_cache.*``
    counters.

Inside the port, telemetry on against off: the engine round's state and
metrics bitwise; ``run_training`` in process on both estimator routes, on
the runtime with ``faults="mild"`` and async: histories equal (timings
aside) and the checkpoint's content hash equal; served token ids equal.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import obs as jobs
from repro.core import forward_grad as jfg
from repro.core.assignment import assignment_matrix as jassignment_matrix
from repro.core.assignment import enumerate_units as jenumerate_units
from repro.core.spry import init_state as jinit_state
from repro.fl import runtime as jrt
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch.checkpoint import read_manifest
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.convert import from_reference
from repro_torch.core import init_state
from repro_torch.fl.runtime import (
    AsyncConfig,
    AsyncFederationEngine,
    ClientPopulation,
    CohortPlan,
    FaultConfig,
    FederationEngine,
    WireConfig,
)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.obs import InMemorySink, Telemetry
from repro_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
MODES = ("per_epoch", "per_iteration")
RTOL = 1e-5
_UNTIMED = ("ts", "wall_s")


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _close(got, want, where):
    """Integers, strings, bools and None equal; floats within RTOL
    relative (NaN equals NaN); containers element by element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        g, w = float(got), float(want)
        assert (math.isnan(g) and math.isnan(w)) or (
            abs(g - w) <= RTOL * max(abs(w), 1e-30)), (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _metrics_match(got, want, where):
    """The final snapshot: counter values equal, gauges within RTOL, and
    each histogram's count equal (its values too, but for time ones)."""
    assert got["counters"] == want["counters"], where
    _close(got["gauges"], want["gauges"], f"{where}.gauges")
    assert list(got["histograms"]) == list(want["histograms"]), where
    for name, h in want["histograms"].items():
        assert got["histograms"][name]["count"] == h["count"], (where, name)
        if not name.endswith(("_s", "seconds")):
            _close(got["histograms"][name], h, f"{where}.{name}")


def assert_events_match(got, want):
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for i, (g, w) in enumerate(zip(got, want)):
        where = f"event {i} ({w['kind']})"
        assert list(g) == list(w), where
        if w["kind"] == "metrics":
            _metrics_match(g["metrics"], w["metrics"], where)
            continue
        for k in w:
            if k not in _UNTIMED:
                _close(g[k], w[k], f"{where}.{k}")


def _kinds_and_keys(events):
    return [(e["kind"], list(e)) for e in events]


def _untimed(history):
    return json.dumps([{k: v for k, v in e.items()
                        if k not in ("t", "round_s", "round_peak_bytes")}
                       for e in history], sort_keys=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the sync engine against the reference engine
# ---------------------------------------------------------------------------

M_REF = 4
KEEP_REF = np.array([True, True, False, True])
QUORUM = 3
N_UNITS = 4                             # reduced roberta: 2 layers, wq and wv
# crashes, corruption, loss with retries and NaN poisoning; seed 10 (found
# on the port): two truncated frames and three retries, and a kept client
# fails, so the quorum pulls the dropped client back
CHAOS = dict(crash_rate=0.15, corrupt_rate=0.15, loss_rate=0.3, nan_rate=0.1,
             seed=10)


def _plan(plan_cls):
    return plan_cls(
        round_idx=0, client_ids=np.arange(M_REF, dtype=np.int64),
        seed_ids=np.arange(M_REF, dtype=np.int32),
        mask_matrix=np.asarray(jassignment_matrix(N_UNITS, M_REF, 0), np.float32),
        latencies=np.arange(1.0, M_REF + 1), deadline=3.5, keep=KEEP_REF.copy(),
        assignments=[], n_requested=M_REF)


@pytest.fixture(scope="module")
def reference_chaos_rounds():
    """The reference engine's chaos round a comm mode (client 2 dropped,
    quorum 3), its telemetry events, and its perturbations for the port."""
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    jsc = jcfgs.SpryConfig(n_clients_per_round=M_REF, local_iters=1,
                           local_lr=5e-3, server_lr=1e-2, k_perturbations=2,
                           seed=3)
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1), jsc)
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(
            k, jpeft["layers"][t]["B"].shape)
    assert jenumerate_units(jpeft).n_units == N_UNITS
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (M_REF, 2, 16)).astype(np.int32)
    labels = rng.integers(0, jc.n_classes, (M_REF, 2)).astype(np.int32)
    out = {}
    for mode in MODES:
        sink = jobs.InMemorySink()
        tel = jobs.Telemetry(run_id="engine", sinks=[sink])
        eng = jrt.FederationEngine(
            jc, jsc, comm_mode=mode, wire=jrt.WireConfig(simulate=True),
            telemetry=tel, faults=jrt.FaultConfig(**CHAOS), quorum=QUORUM)
        state, metrics, rep = eng.run_round(
            jinit_state(jbase, jpeft), _plan(jrt.CohortPlan),
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        tel.close()
        out[mode] = dict(events=sink.events, report=rep, metrics=metrics)
    rk = jax.random.fold_in(jax.random.PRNGKey(jsc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    draw = jax.jit(jfg.stacked_perturbations)
    perts = [[tree_map(lambda a: torch.from_numpy(np.array(a)), _np(
        draw(jax.random.fold_in(jax.random.fold_in(rk, m), 0), peft32,
             jnp.arange(jsc.k_perturbations))))] for m in range(M_REF)]
    return dict(jsc=jsc, jbase=jbase, jpeft=jpeft, out=out, perts=perts,
                tokens=tokens, labels=labels)


def _port_round(r, mode, telemetry):
    tc = reduce_config(get_config("roberta-large-lora"))
    tsc = SpryConfig(**dataclasses.asdict(r["jsc"]))
    tbase, tpeft = from_reference(tc, _np(r["jbase"]), _np(r["jpeft"]), "cpu")
    eng = FederationEngine(tc, tsc, comm_mode=mode, wire=WireConfig(simulate=True),
                           telemetry=telemetry, faults=FaultConfig(**CHAOS),
                           quorum=QUORUM)
    batch = {"tokens": torch.from_numpy(r["tokens"]),
             "labels": torch.from_numpy(r["labels"])}
    return eng.run_round(init_state(tbase, tpeft), _plan(CohortPlan), batch,
                         perturbations=r["perts"])


@pytest.mark.parametrize("mode", MODES)
def test_engine_events_match_reference_engine(reference_chaos_rounds, mode):
    r = reference_chaos_rounds
    sink = InMemorySink()
    tel = Telemetry(run_id="engine", sinks=[sink])
    _, _, rep = _port_round(r, mode, tel)
    tel.close()
    want = r["out"][mode]["events"]
    assert [e["kind"] for e in want] == ["wire_health", "round", "metrics"]
    health = want[0]
    assert health["requorumed"] == 1 and health["quarantined"] == 2   # faults landed
    assert health["retries"] > 0 and want[1]["survivors"] == QUORUM
    assert_events_match(sink.events, want)
    assert dataclasses.asdict(rep.health) == dataclasses.asdict(
        r["out"][mode]["report"].health)


@pytest.mark.parametrize("mode", MODES)
def test_engine_round_bitwise_with_telemetry(reference_chaos_rounds, mode):
    r = reference_chaos_rounds
    s_off, m_off, rep_off = _port_round(r, mode, None)
    sink = InMemorySink()
    s_on, m_on, rep_on = _port_round(r, mode, Telemetry(run_id="t", sinks=[sink]))
    for a, b in zip(tree_leaves(s_off.peft) + tree_leaves(s_off.server.v),
                    tree_leaves(s_on.peft) + tree_leaves(s_on.server.v)):
        assert torch.equal(a, b)
    assert sorted(m_off) == sorted(m_on)
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    assert rep_off == rep_on
    assert sink.by_kind("round")[0]["loss"] == float(m_on["loss"])


# ---------------------------------------------------------------------------
# the async engine against the reference engine
# ---------------------------------------------------------------------------

VERSIONS = 3
_ASYNC = dict(buffer_size=2, staleness_decay=0.5, concurrency=4, seed=11)
_ASYNC_CHAOS = dict(crash_rate=0.1, loss_rate=0.1, corrupt_rate=0.05,
                    nan_rate=0.05, blowup_rate=0.05, seed=3)


@pytest.fixture(scope="module")
def reference_async_events():
    """The reference async engine's 3 per-epoch versions with telemetry
    (test_torch_async's fixture), and its perturbations keyed by dispatch
    index for the port."""
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
    sink = jobs.InMemorySink()
    tel = jobs.Telemetry(run_id="async", sinks=[sink])
    eng = jrt.AsyncFederationEngine(
        jc, jsc, jrt.ClientPopulation(x, y, n_clients=1000, seed=7),
        comm_mode="per_epoch", async_cfg=jrt.AsyncConfig(**_ASYNC),
        wire=jrt.WireConfig(simulate=True), telemetry=tel,
        faults=jrt.FaultInjector(jrt.FaultConfig(**_ASYNC_CHAOS)))
    versions, real_dispatch = {}, eng._dispatch

    def dispatch(state, batch_size, health):
        versions[eng.dispatched] = eng.version
        return real_dispatch(state, batch_size, health)
    eng._dispatch = dispatch
    state = jinit_state(jbase, jpeft)
    for _ in range(VERSIONS):
        state, _, _ = eng.run_version(state, batch_size=2)
    tel.close()
    base_key = jax.random.PRNGKey(jsc.seed)
    peft32 = jax.tree.map(lambda a: a.astype(jnp.float32), jpeft)
    draw = jax.jit(jfg.stacked_perturbations)
    perts = {d: [tree_map(lambda a: torch.from_numpy(np.array(a)), _np(draw(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base_key, v), d), 0),
        peft32, jnp.arange(jsc.k_perturbations))))] for d, v in versions.items()}
    return dict(jsc=jsc, jbase=jbase, jpeft=jpeft, x=x, y=y, events=sink.events,
                perts=perts)


def test_async_events_match_reference_engine(reference_async_events):
    r = reference_async_events
    tc = reduce_config(get_config("roberta-large-lora"))
    sink = InMemorySink()
    tel = Telemetry(run_id="async", sinks=[sink])
    eng = AsyncFederationEngine(
        tc, SpryConfig(**dataclasses.asdict(r["jsc"])),
        ClientPopulation(r["x"], r["y"], 1000, seed=7), comm_mode="per_epoch",
        async_cfg=AsyncConfig(**_ASYNC), wire=WireConfig(simulate=True),
        telemetry=tel, faults=FaultConfig(**_ASYNC_CHAOS), perturbations=r["perts"])
    tbase, tpeft = from_reference(tc, _np(r["jbase"]), _np(r["jpeft"]), "cpu")
    state = init_state(tbase, tpeft)
    for _ in range(VERSIONS):
        state, _, _ = eng.run_version(state, batch_size=2)
    tel.close()
    want = r["events"]
    assert [e["kind"] for e in want] == ["async_round"] * VERSIONS + ["metrics"]
    assert any(s > 0 for e in want[:-1] for s in e["staleness"])   # late arrivals
    counters = want[-1]["metrics"]["counters"]
    assert counters["fl.crashed_clients"] + counters["fl.quarantined"] \
        + counters["fl.invalid_payloads"] + counters["fl.lost_updates"] > 0
    assert counters["fl.bytes_up"] == want[-2]["bytes_up"] > 0
    assert_events_match(sink.events, want)


# ---------------------------------------------------------------------------
# run_training against the reference's
# ---------------------------------------------------------------------------

_TRAIN = dict(rounds=2, clients_per_round=2, total_clients=6, batch_size=4,
              k_perturbations=2, eval_every=1, log=lambda *a: None)


def _port_runs(kw, ck_root):
    """``run_training(**kw)`` on the CPU with telemetry off and on (run id
    ``train-spry-0``, workload ``train``), each writing its checkpoints under
    ``ck_root``: {on: (untimed history, content hash, sink)}."""
    runs = {}
    for on in (False, True):
        sink = InMemorySink()
        tel = (Telemetry(run_id="train-spry-0", sinks=[sink], workload="train") if on
               else None)
        ck = str(ck_root / f"ck_{on}")
        hist = ttrain.run_training(checkpoint_dir=ck, telemetry=tel, device="cpu", **kw)
        if tel is not None:
            tel.close()
        runs[on] = (_untimed(hist), read_manifest(ck).content_hash, sink)
    return runs


@pytest.fixture(scope="module")
def standard_runs(tmp_path_factory):
    """The in-process standard-route runs of ``_TRAIN`` (eval every round),
    telemetry off and on: shared by the kinds-and-keys comparison with the
    reference and by the standard case of the neutrality test."""
    return _port_runs(_TRAIN, tmp_path_factory.mktemp("standard"))


def test_run_training_events_match_reference_kinds_and_keys(monkeypatch, standard_runs):
    # the reference's personalized accuracy runs eager forward gradients
    # (~30 s on the CPU); its value is not compared, so a constant stands in
    monkeypatch.setattr(jtrain, "personalized_accuracy", lambda *a, **k: 0.5)
    # its weight draws under jax.jit: the same functions, compiled once
    # instead of dispatched op by op (seconds on the CPU); the values drawn
    # are not compared here
    real = jtrain.get_model
    monkeypatch.setattr(jtrain, "get_model", lambda cfg: dataclasses.replace(
        real(cfg), init_base=jax.jit(real(cfg).init_base, static_argnums=0)))
    monkeypatch.setattr(jtrain, "init_peft", jax.jit(jtrain.init_peft,
                                                     static_argnums=(0, 2)))
    want_sink = jobs.InMemorySink()
    jtel = jobs.Telemetry(run_id="train-spry-0", sinks=[want_sink], workload="train")
    jtrain.run_training(telemetry=jtel, **_TRAIN)
    jtel.close()
    sink = standard_runs[True][2]
    assert _kinds_and_keys(sink.events) == _kinds_and_keys(want_sink.events)
    assert [e["kind"] for e in sink.events] == [
        "run_meta", "run_meta", "round", "memory", "eval", "round", "eval",
        "memory", "personalized_eval", "metrics"]
    # the static run facts are the reference's
    meta, jmeta = sink.events[1], want_sink.events[1]
    assert {k: meta[k] for k in meta if k != "ts"} == {
        k: jmeta[k] for k in jmeta if k != "ts"}
    assert [e["round"] for e in sink.by_kind("eval")] == [0, 1]


# ---------------------------------------------------------------------------
# serving against the reference's
# ---------------------------------------------------------------------------

_SERVE = dict(n_requests=3, prompt_len=4, steps=3, max_batch=2, cache_capacity=2)


def _serve_counters(snapshot):
    return {k: v for k, v in snapshot["counters"].items()
            if k.startswith(("serve.", "adapter_cache."))}


def test_serving_events_and_counters_match_reference():
    jtel = jobs.Telemetry(run_id="serve", sinks=[jobs.InMemorySink()])
    jserve.run_engine(jcfgs.reduce_config(jcfgs.get_config("llama2-7b")),
                      telemetry=jtel, **_SERVE)
    sink = InMemorySink()
    tel = Telemetry(run_id="serve", sinks=[sink])
    cfg = reduce_config(get_config("llama2-7b"))
    out_on, eng = tserve.run_engine(cfg, telemetry=tel, device="cpu", **_SERVE)
    out_off, _ = tserve.run_engine(cfg, device="cpu", **_SERVE)
    assert out_on == out_off                                  # neutrality
    want_reqs = jtel.sinks[0].by_kind("request")
    reqs = sink.by_kind("request")
    assert len(reqs) == len(want_reqs) == _SERVE["n_requests"]
    assert [list(e) for e in reqs] == [list(e) for e in want_reqs]
    assert sorted((e["request_id"], e["adapter_id"], e["prompt_len"], e["gen_tokens"])
                  for e in reqs) == sorted(
        (e["request_id"], e["adapter_id"], e["prompt_len"], e["gen_tokens"])
        for e in want_reqs)
    got, want = (_serve_counters(tel.metrics_snapshot()),
                 _serve_counters(jtel.metrics_snapshot()))
    assert got == want and got["serve.requests"] == _SERVE["n_requests"]
    stats = eng.adapters.stats()
    assert {k: got[f"adapter_cache.{k}"] for k in ("hits", "misses", "evictions")} \
        == {k: stats[k] for k in ("hits", "misses", "evictions")}


# ---------------------------------------------------------------------------
# neutrality inside the port: run_training telemetry on vs off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["standard", "fused", "runtime_mild", "async"])
def test_run_training_bitwise_with_telemetry(tmp_path, standard_runs, case):
    kw = dict(_TRAIN, eval_every=2)      # one eval, at the end (standard: every round)
    if case == "fused":
        kw["fused_contraction"] = True
    elif case == "runtime_mild":
        kw.update(runtime=True, clients_per_round=4, total_clients=16,
                  over_select=1.5, dropout_rate=0.25, faults="mild", quorum=0.5)
    elif case == "async":
        kw.update(async_mode=True, clients_per_round=4, total_clients=16,
                  buffer_size=2, faults="mild")
    runs = standard_runs if case == "standard" else _port_runs(kw, tmp_path)
    assert runs[True][:2] == runs[False][:2]
    kinds = {e["kind"] for e in runs[True][2].events}
    assert {"run_meta", "eval", "memory", "personalized_eval"} <= kinds
    assert ("async_round" if case == "async" else "round") in kinds
    if case == "runtime_mild":
        assert "wire_health" in kinds
