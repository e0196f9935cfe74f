"""The port's federation runtime: the cohort executors and the synchronous
round engine (``repro_torch.fl.runtime``).

Inside the port, bitwise (``torch.equal`` on every leaf and metric):
  * an ideal engine round (full participation, whole-cohort executor, no
    wire or an fp32 wire) equals the in-process ``make_round_step`` /
    ``make_round_step_per_iteration`` round, for roberta and rwkv6;
  * a dropped client's round equals an explicit re-run without it, on the
    whole-cohort and the streaming executor, both comm modes;
  * the streaming executor (microbatch m) sums in the reference's order.

Against the JAX package: one scheduled round a comm mode (a dropped client,
so the dropout-corrected counts are compared too) at reduced roberta, the
reference's perturbations injected, the reference engine's rounds in one
jit. Loss and jvp_abs_mean within 1e-5 relative, the new PEFT within 1e-5
of its largest entry, the update itself (new - old) within 1e-4 relative
(FedYogi's normalisation amplifies ulp differences, as in
test_torch_spry).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import forward_grad as jfg
from repro.core.assignment import assignment_matrix as jassignment_matrix
from repro.core.assignment import enumerate_units as jenumerate_units
from repro.core.spry import init_state as jinit_state
from repro.fl.runtime import FederationEngine as JEngine
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.convert import from_reference
from repro_torch.core import (
    enumerate_units,
    init_state,
    make_round_step,
    make_round_step_per_iteration,
)
from repro_torch.core.assignment import assignment_matrix
from repro_torch.fl.runtime import (
    CohortPlan,
    FederationEngine,
    SerialExecutor,
    ShardedExecutor,
    WireConfig,
)
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)
MODES = ("per_epoch", "per_iteration")


def _setup(arch, M=4, B=2, S=16, k=2):
    cfg = reduce_config(get_config(arch))
    sc = SpryConfig(n_clients_per_round=M, local_iters=1, local_lr=1e-2,
                    server_lr=1e-2, k_perturbations=k)
    gen = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, sc)
    for t in peft["layers"].values():       # B = 0 at init: make LoRA live
        t["B"] = 0.1 * torch.randn(t["B"].shape, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (M, B, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes, (M, B)))}
    return cfg, sc, init_state(base, peft), batch


@pytest.fixture(scope="module")
def roberta():
    return _setup("roberta-large-lora", M=5)


def _leaves(tree):
    """Leaves of nested dicts, tuples (NamedTuples) and lists."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return tree_leaves(tree) if isinstance(tree, dict) else [tree]


def assert_trees_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), what


def _plan(seed_ids, mask, keep, round_idx=0):
    C = len(seed_ids)
    return CohortPlan(
        round_idx=round_idx, client_ids=np.asarray(seed_ids, np.int64),
        seed_ids=np.asarray(seed_ids, np.int32),
        mask_matrix=np.asarray(mask, np.float32), latencies=np.zeros(C),
        deadline=float("inf"), keep=np.asarray(keep, bool), assignments=[],
        n_requested=C)


def _round_step(cfg, sc, mode):
    return (make_round_step(cfg, sc) if mode == "per_epoch"
            else make_round_step_per_iteration(cfg, sc))


# ---------------------------------------------------------------------------
# bit identity with the in-process round steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["roberta-large-lora", "rwkv6-1.6b"])
@pytest.mark.parametrize("mode", MODES)
def test_ideal_round_bitwise_equals_round_step(arch, mode):
    cfg, sc, state, batch = (_setup(arch, S=8) if arch == "rwkv6-1.6b"
                             else _setup(arch))
    ref_state, ref_m = _round_step(cfg, sc, mode)(state, batch)
    es, em = FederationEngine(cfg, sc, comm_mode=mode).run_ideal(state, batch)
    assert_trees_equal(ref_state.peft, es.peft, "peft")
    assert_trees_equal(ref_state.server, es.server, "server state")
    assert sorted(ref_m) == sorted(em)
    assert_trees_equal(ref_m, em, "metrics")
    assert es.round_idx == ref_state.round_idx == 1


@pytest.mark.parametrize("mode", MODES)
def test_wire_sim_fp32_bitwise_equals_no_wire(roberta, mode):
    """Routing every update through a serialized fp32 frame changes
    nothing."""
    cfg, sc, state, batch = roberta
    plain, pm = FederationEngine(cfg, sc, comm_mode=mode).run_ideal(state, batch)
    wired, wm = FederationEngine(cfg, sc, comm_mode=mode,
                                 wire=WireConfig(simulate=True)).run_ideal(state, batch)
    assert_trees_equal(plain.peft, wired.peft, mode)
    assert_trees_equal(plain.server, wired.server, mode)
    assert_trees_equal(pm, wm, mode)


def test_wire_bf16_close_but_not_identical(roberta):
    """bf16 quantization of the deltas moves the update (atol 1e-3, rtol
    1e-2, the reference test's tolerance), and does move it."""
    cfg, sc, state, batch = roberta
    plain, _ = FederationEngine(cfg, sc).run_ideal(state, batch)
    wired, _ = FederationEngine(cfg, sc, wire=WireConfig(
        simulate=True, dtype="bf16")).run_ideal(state, batch)
    diff = 0.0
    for a, b in zip(tree_leaves(plain.peft), tree_leaves(wired.peft)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-3, rtol=1e-2)
        diff = max(diff, float((a - b).abs().max()))
    assert diff > 0


# ---------------------------------------------------------------------------
# dropout-corrected aggregation == explicit exclusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [None, 1])
@pytest.mark.parametrize("mode", MODES)
def test_dropout_corrected_equals_explicit_exclusion(roberta, mode, microbatch):
    """Client 4 shares unit 0 with client 0 (M=5 > U=4), so its drop moves
    a unit count 2 -> 1; the round equals the round of the other four."""
    cfg, sc, state, batch = roberta
    n_units = enumerate_units(state.peft).n_units
    mask = assignment_matrix(n_units, 5, 0).numpy()
    j = 4
    keep = np.ones(5, bool)
    keep[j] = False
    eng = FederationEngine(cfg, sc, comm_mode=mode,
                           executor=SerialExecutor(microbatch=microbatch))
    sd, md, rd = eng.run_round(state, _plan(np.arange(5), mask, keep), batch)
    survivors = [i for i in range(5) if i != j]
    se, me, _ = eng.run_round(state, _plan(survivors, mask[survivors],
                                           np.ones(4, bool)),
                              {k: v[survivors] for k, v in batch.items()})
    assert (mask[j] > 0).any() and rd.n_survivors == 4
    assert rd.dropped_client_ids == [j]
    assert_trees_equal(sd.peft, se.peft, "peft")
    assert_trees_equal(sd.server, se.server, "server")
    assert_trees_equal(md, me, "metrics")


def test_dropout_differs_from_full_counts(roberta):
    cfg, sc, state, batch = roberta
    mask = assignment_matrix(enumerate_units(state.peft).n_units, 5, 0).numpy()
    eng = FederationEngine(cfg, sc, executor=SerialExecutor(microbatch=1))
    keep = np.ones(5, bool)
    keep[0] = False
    sd, _, _ = eng.run_round(state, _plan(np.arange(5), mask, keep), batch)
    sf, _, _ = eng.run_round(state, _plan(np.arange(5), mask, np.ones(5, bool)),
                             batch)
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(sd.peft), tree_leaves(sf.peft))) > 0


# ---------------------------------------------------------------------------
# the streaming executor
# ---------------------------------------------------------------------------

def test_streaming_executor_sums_chunks_in_reference_order():
    """microbatch=2 over 5 clients pads to 6 with a keep=0 row; the carry is
    zeros + Σ_chunk (Σ_i keep_i x_i), bit for bit, and collect returns every
    client's payload."""
    ex = SerialExecutor(microbatch=2)
    assert ex.pad_to(5) == 6
    gen = torch.Generator().manual_seed(3)
    xs = [{"a": torch.randn(3, 4, generator=gen)} for _ in range(6)]
    keep = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.float32)

    def fn(base, peft, rk, sid, row, cb):
        return xs[sid], (cb, cb * 2)
    batch = torch.arange(6.0)
    out, (a, b) = ex.run(fn, None, None, 0, list(range(6)), [None] * 6, batch,
                         keep)
    want = torch.zeros(3, 4)
    for c in range(3):
        chunk = torch.stack([xs[i]["a"] * keep[i] for i in (2 * c, 2 * c + 1)])
        want = want + chunk.sum(0)
    assert torch.equal(out["a"], want)
    assert torch.equal(a, batch) and torch.equal(b, batch * 2)
    collected, _ = ex.run(fn, None, None, 0, list(range(6)), [None] * 6, batch,
                          keep, collect=True)
    assert [c["a"] for c in collected] == [x["a"] for x in xs]
    with pytest.raises(ValueError, match="divisible"):
        ex.run(fn, None, None, 0, list(range(5)), [None] * 5, batch[:5], keep[:5])


@pytest.mark.parametrize("mode", MODES)
def test_streaming_round_matches_whole_cohort(roberta, mode):
    """The chunked executor's round (microbatch 2, the cohort padded 5 -> 6)
    against the whole-cohort round: the same sums in another order (rtol
    1e-5 on the new PEFT), the report's accumulator (m+1)·|peft|."""
    cfg, sc, state, batch = roberta
    whole, wm = FederationEngine(cfg, sc, comm_mode=mode).run_ideal(state, batch)
    eng = FederationEngine(cfg, sc, comm_mode=mode,
                           executor=SerialExecutor(microbatch=2))
    mask = assignment_matrix(enumerate_units(state.peft).n_units, 5, 0).numpy()
    st, sm, rep = eng.run_round(state, _plan(np.arange(5), mask, np.ones(5, bool)),
                                batch)
    for a, b in zip(tree_leaves(whole.peft), tree_leaves(st.peft)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(wm["loss"], sm["loss"])
    peft_bytes = 4 * sum(x.numel() for x in tree_leaves(state.peft))
    assert rep.agg_bytes_streaming == 3 * peft_bytes
    assert rep.agg_bytes_stacked == 6 * peft_bytes


def test_sharded_executor_raises_with_reason():
    with pytest.raises(NotImplementedError, match="no one-GPU meaning"):
        ShardedExecutor(microbatch=1)
    with pytest.raises(NotImplementedError, match="no one-GPU meaning"):
        ttrain.run_training(rounds=1, runtime=True, runtime_executor="sharded",
                            device="cpu", log=lambda *a: None)


def test_runtime_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.run_training(rounds=1, runtime=True, log=lambda *a: None)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.run_training(rounds=1, async_mode=True, log=lambda *a: None)


def test_train_cli_accepts_runtime_flags_and_rejects_telemetry():
    """The runtime flags and the telemetry flags parse (telemetry on by
    default, to ``telemetry.jsonl``, as the reference); a baseline on the
    runtime raises."""
    args = ttrain.build_parser().parse_args(
        ["--runtime", "--runtime-microbatch", "2", "--over-select", "1.5",
         "--deadline", "9", "--dropout-rate", "0.2", "--wire-dtype", "bf16",
         "--wire-simulate", "--faults", "mild", "--quorum", "0.5",
         "--checkpoint-dir", "ck", "--checkpoint-every", "2", "--resume",
         "--async", "--buffer-size", "3", "--staleness-decay", "0.7",
         "--async-concurrency", "6", "--max-staleness", "2"])
    assert (args.runtime and args.async_mode and args.resume and args.quorum == 0.5
            and args.runtime_microbatch == 2 and args.max_staleness == 2)
    assert (args.telemetry, args.trace_out, args.prom_out) == (
        "telemetry.jsonl", None, None)
    args = ttrain.build_parser().parse_args(
        ["--telemetry", "t.jsonl", "--trace-out", "t.json", "--prom-out", "t.prom"])
    assert (args.telemetry, args.trace_out, args.prom_out) == (
        "t.jsonl", "t.json", "t.prom")
    with pytest.raises(ValueError, match="spry/spry_periter"):
        ttrain.run_training(method="fedavg", runtime=True, device="cpu",
                            log=lambda *a: None)


@pytest.mark.parametrize("case", ["telemetry", "trace-out", "prom-out", "off"])
def test_train_cli_writes_telemetry_artifacts(case, tmp_path, monkeypatch, capsys):
    """Each flag writes its artifact under tmp_path: ``--telemetry`` the
    JSONL event log, ``--trace-out`` the Chrome trace (beside the log),
    ``--prom-out`` the Prometheus snapshot (with the log off); ``--telemetry
    off`` writes nothing."""
    monkeypatch.chdir(tmp_path)
    jsonl, trace, prom = (tmp_path / "t.jsonl", tmp_path / "t.trace.json",
                          tmp_path / "t.prom")
    argv = ["--device", "cpu", "--rounds", "1", "--clients", "2",
            "--total-clients", "4", "--batch-size", "2"]
    argv += {"telemetry": ["--telemetry", str(jsonl)],
             "trace-out": ["--telemetry", str(jsonl), "--trace-out", str(trace)],
             "prom-out": ["--telemetry", "off", "--prom-out", str(prom)],
             "off": ["--telemetry", "off"]}[case]
    ttrain.main(argv)
    out = capsys.readouterr().out
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == {"telemetry": ["t.jsonl"], "trace-out": ["t.jsonl", "t.trace.json"],
                       "prom-out": ["t.prom"], "off": []}[case]
    assert ("[telemetry] events ->" in out) == (case != "off")
    if case in ("telemetry", "trace-out"):
        kinds = [json.loads(line)["kind"] for line in jsonl.read_text().splitlines()]
        assert kinds[:3] == ["run_meta", "run_meta", "round"] and kinds[-1] == "metrics"
        assert {"eval", "memory", "personalized_eval"} <= set(kinds)
    if case == "trace-out":
        doc = json.loads(trace.read_text())
        assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["train.round"]
    if case == "prom-out":
        assert "mem_live_array_bytes" in prom.read_text()


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

M_REF = 4
KEEP_REF = np.array([True, True, False, True])


@pytest.fixture(scope="module")
def reference_engine_rounds():
    """Both comm modes' scheduled rounds of the reference engine (client 2
    dropped) from the same state and batch, in one jit."""
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    jsc = jcfgs.SpryConfig(n_clients_per_round=M_REF, local_iters=1,
                           local_lr=5e-3, server_lr=1e-2, k_perturbations=2,
                           seed=3)
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1), jsc)
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(
            k, jpeft["layers"][t]["B"].shape)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (M_REF, 2, 16)).astype(np.int32)
    labels = rng.integers(0, jc.n_classes, (M_REF, 2)).astype(np.int32)
    n_units = jenumerate_units(jpeft).n_units
    mask = np.asarray(jassignment_matrix(n_units, M_REF, 1), np.float32)
    seed_ids = np.arange(M_REF, dtype=np.int32)
    keep = KEEP_REF.astype(np.float32)
    engines = {m: JEngine(jc, jsc, comm_mode=m) for m in MODES}
    state = jinit_state(jbase, jpeft)
    out = jax.jit(lambda st, b: {m: e._round_fn(st, seed_ids, mask, keep, b)
                                 for m, e in engines.items()})(
        state, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    # the reference's perturbations, keyed by seed id, for the port
    rk = jax.random.fold_in(jax.random.PRNGKey(jsc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    draw = jax.jit(jfg.stacked_perturbations)
    perts = [[tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(
        np.asarray, draw(jax.random.fold_in(jax.random.fold_in(rk, m), 0), peft32,
                         jnp.arange(jsc.k_perturbations))))] for m in range(M_REF)]
    return dict(jc=jc, jsc=jsc, jbase=jbase, jpeft=jpeft, mask=mask, out=out,
                perts=perts, tokens=tokens, labels=labels)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_engine_round_matches_reference_engine(reference_engine_rounds, mode):
    r = reference_engine_rounds
    tc = reduce_config(get_config("roberta-large-lora"))
    tsc = SpryConfig(**dataclasses.asdict(r["jsc"]))
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, r["jbase"]),
                                  jax.tree.map(np.asarray, r["jpeft"]), "cpu")
    eng = FederationEngine(tc, tsc, comm_mode=mode)
    batch = {"tokens": torch.from_numpy(r["tokens"]),
             "labels": torch.from_numpy(r["labels"])}
    ts, tm, rep = eng.run_round(init_state(tbase, tpeft),
                                _plan(np.arange(M_REF), r["mask"], KEEP_REF,
                                      round_idx=0), batch,
                                perturbations=r["perts"])
    js, jm = r["out"][mode]
    assert rep.n_survivors == 3 and rep.dropped_client_ids == [2]
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["jvp_abs_mean"], jm["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(js.peft), tree_leaves(ts.peft),
                                 jax.tree.leaves(r["jpeft"])):
        assert _rel(t_new.numpy(), j_new) <= 1e-5
        old = np.asarray(old, np.float64)
        assert _rel(t_new.double().numpy() - old,
                    np.asarray(j_new, np.float64) - old) <= 1e-4
    assert int(ts.server.count) == int(js.server.count) == 1
