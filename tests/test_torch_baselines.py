"""The port's baseline methods and CLI against the JAX package.

One round of each comparison arm on reduced roberta with the reference's
weights and batch (carried over as in tests/test_torch_fused.py) and, for
the zero-order arms and FedFGD, the reference's own perturbations injected:

- backprop (fedavg, fedyogi, fedsgd, fedavgsplit): a client's gradient at
  rel 1e-5 against ``jax.value_and_grad``; the round's PEFT update at rel
  1e-4 (the server's normalisation amplifies ulp differences, as in
  tests/test_torch_spry.py);
- fedfgd (SPRY without weight splitting): loss and jvps at rel 1e-5, PEFT
  update at rel 1e-4;
- zero-order (fedmezo, baffle, fwdllm): a central difference divides a
  loss difference by 2*eps, so the packages' fp32 loss disagreement is
  amplified by 1/(2*eps). With |f_port - f_ref| <= KAPPA*|f| (KAPPA = 2e-6,
  about 17 fp32 ulps; the measured worst on these shapes is 6.6e-7), each
  finite difference may differ by KAPPA*|f|/eps; the aggregated gradient by
  that times max|v|, and the PEFT update by local_lr times that (the first
  FedYogi step's slope in its input is at most lr*(1-b1)/tau = 1). For
  fwdllm both packages must first choose the same candidate. BAFFLE and
  FwdLLM run with K=4 perturbations here (the reference's jitted round
  unrolls its K loop: K=20 alone costs half a minute of compilation); the
  code path is the same, and chip_smoke.py runs their default K at full
  width;
- the CLI: every method on ``--device cpu`` for one round, and the fused
  route, each printing finite ``loss=`` / ``test_acc=`` lines.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import spry as jspry
from repro.core.baselines import backprop as jbp
from repro.core.baselines import zeroorder as jzo
from repro.models import registry as jreg
from repro.utils.pytree import normal_like, tree_dot, tree_norm
from repro_torch import configs as tcfgs
from repro_torch.core import spry as tspry
from repro_torch.core.baselines import (
    ZOState,
    init_zo_state,
    make_backprop_round_step,
    make_zeroorder_round_step,
)
from repro_torch.core.baselines.backprop import value_and_grad
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.utils.pytree import tree_leaves

from test_torch_fused import M, _model, _ref_perturbations, _rel, _to_t

torch.set_num_threads(1)
KAPPA = 2e-6


@pytest.fixture(scope="module")
def s():
    return _model("roberta-large-lora")


def _delta_rel(jstate_peft, tstate_peft, old):
    worst = 0.0
    for j_new, t_new, o in zip(jax.tree.leaves(jstate_peft), tree_leaves(tstate_peft),
                               jax.tree.leaves(old)):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(o, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(o, np.float64)
        worst = max(worst, _rel(t_delta, j_delta))
    return worst


def test_backprop_gradient_matches_reference(s):
    jb = jax.tree.map(lambda x: x[1], s["jbatch"])
    tb = {k: v[1] for k, v in s["tbatch"].items()}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jreg.cls_loss(s["jc"], s["jbase"], p, jb)))(s["jpeft"])
    tloss, tg = value_and_grad(lambda p: treg.cls_loss(s["tc"], s["tbase"], p, tb),
                               s["tpeft"])
    assert _rel(tloss, jloss) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-5


@pytest.mark.parametrize("method", ["fedavg", "fedyogi", "fedsgd", "fedavgsplit"])
def test_backprop_round_matches_reference(s, method):
    kw = dict(n_clients_per_round=M, local_lr=5e-2, seed=3,
              server_lr=1.0 if method != "fedyogi" else 1e-2,
              server_opt="fedavg" if method != "fedyogi" else "fedyogi")
    jsc, tsc = jcfgs.SpryConfig(**kw), tcfgs.SpryConfig(**kw)
    base_method = "fedavg" if method == "fedavgsplit" else method
    split = method == "fedavgsplit"
    jstep = jbp.make_backprop_round_step(s["jc"], jsc, method=base_method, split=split)
    tstep = make_backprop_round_step(s["tc"], tsc, method=base_method, split=split)
    jstate, jmet = jax.jit(jstep)(jspry.init_state(s["jbase"], s["jpeft"]), s["jbatch"])
    tstate, tmet = tstep(tspry.init_state(s["tbase"], s["tpeft"]), s["tbatch"])
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _delta_rel(jstate.peft, tstate.peft, s["jpeft"]) <= 1e-4
    assert tstate.round_idx == 1


def test_fedfgd_round_matches_reference(s):
    """SPRY without weight splitting: every client perturbs every unit."""
    kw = dict(n_clients_per_round=M, k_perturbations=3, local_lr=5e-3,
              server_lr=1e-2, seed=4)
    jsc, tsc = jcfgs.SpryConfig(**kw), tcfgs.SpryConfig(**kw)
    rk = jax.random.fold_in(jax.random.PRNGKey(jsc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    perts = [[_to_t(_ref_perturbations(jax.random.fold_in(jax.random.fold_in(rk, m), 0),
                                       peft32, jnp.arange(3)))] for m in range(M)]
    jstate, jmet = jax.jit(jspry.make_round_step(s["jc"], jsc, split=False))(
        jspry.init_state(s["jbase"], s["jpeft"]), s["jbatch"])
    tstate, tmet = tspry.make_round_step(s["tc"], tsc, split=False)(
        tspry.init_state(s["tbase"], s["tpeft"]), s["tbatch"], perts)
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    assert _delta_rel(jstate.peft, tstate.peft, s["jpeft"]) <= 1e-4


def _zo_perturbations(s, seed, K):
    """The reference's draws: normal_like(fold_in(ckey, i), peft) for each
    client's key chain, stacked per client."""
    rk = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    out = []
    for m in range(M):
        ck = jax.random.fold_in(rk, m)
        vs = [normal_like(jax.random.fold_in(ck, i), s["jpeft"], dtype=jnp.float32)
              for i in range(K)]
        out.append(jax.tree.map(lambda *xs: jnp.stack(xs), *vs))
    return out


def _reference_choices(s, jperts, prev, K, eps):
    """Each client's fwdllm candidate, by the reference's own functions (its
    loss jitted once for all clients, the batch an argument)."""
    choices = []
    loss_jit = jax.jit(lambda p, b: jreg.cls_loss(s["jc"], s["jbase"], p, b))
    for m in range(M):
        jb = jax.tree.map(lambda x: x[m], s["jbatch"])
        loss_of = lambda p, jb=jb: loss_jit(p, jb)  # noqa: E731
        coss = []
        for i in range(K):
            v = jax.tree.map(lambda x: x[i], jperts[m])
            fd = jzo._central_difference(loss_of, s["jpeft"], v, eps)
            g = jax.tree.map(lambda vi: fd * vi, v)
            coss.append(tree_dot(g, prev) / (tree_norm(g) * tree_norm(prev) + 1e-9))
        choices.append(int(jnp.argmax(jnp.stack(coss))))
    return choices


@pytest.mark.parametrize("method", ["fedmezo", "baffle", "fwdllm"])
def test_zeroorder_round_matches_reference(s, method):
    kw = dict(n_clients_per_round=M, local_lr=5e-3, server_lr=1e-2, seed=5)
    jsc, tsc = jcfgs.SpryConfig(**kw), tcfgs.SpryConfig(**kw)
    K, eps = min(jzo.ZO_DEFAULTS[method]["k"], 4), jzo.ZO_DEFAULTS[method]["eps"]
    jperts = _zo_perturbations(s, jsc.seed, K)
    # fwdllm's guidance: a non-zero previous gradient, so the cosines differ
    rng = np.random.default_rng(6)
    prev = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape),
                                              jnp.float32), s["jpeft"])
    jstate0 = jzo.ZOState(jspry.init_state(s["jbase"], s["jpeft"]), prev)
    tstate0 = ZOState(tspry.init_state(s["tbase"], s["tpeft"]), _to_t(prev))
    if method != "fwdllm":
        jstate0 = jzo.init_zo_state(jstate0.inner)
        tstate0 = init_zo_state(tstate0.inner)
    jstep = jzo.make_zeroorder_round_step(s["jc"], jsc, method=method, k=K)
    tstep = make_zeroorder_round_step(s["tc"], tsc, method=method, k=K)
    jstate, jmet = jax.jit(jstep)(jstate0, s["jbatch"])
    tstate, tmet = tstep(tstate0, s["tbatch"], [_to_t(p) for p in jperts])
    if method == "fwdllm":
        assert tmet["choice"].tolist() == _reference_choices(s, jperts, prev, K, eps)
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    f_max = max(abs(float(tmet["loss"])), 1.0) * 1.5    # losses near the batch's
    v_max = max(float(jnp.abs(x).max()) for p in jperts for x in jax.tree.leaves(p))
    tol_g = KAPPA * f_max / eps * v_max
    for a, b in zip(jax.tree.leaves(jstate.prev_grad), tree_leaves(tstate.prev_grad)):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= tol_g
    tol_p = tsc.local_lr * tol_g
    for a, b in zip(jax.tree.leaves(jstate.inner.peft), tree_leaves(tstate.inner.peft)):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= tol_p
    assert tstate.inner.round_idx == 1


@pytest.mark.parametrize("method,fused", [(m, False) for m in ttrain.METHODS]
                         + [("spry", True)])
def test_cli_runs_every_method_on_cpu(method, fused, capsys):
    # 40 clients of ~100 samples: the personalisation phase evaluates each
    # client's held-out fifth, and this case checks the CLI, not that size
    argv = ["--device", "cpu", "--rounds", "1", "--clients", "2",
            "--total-clients", "40", "--batch-size", "4", "--k", "2",
            "--method", method] + (["--fused-contraction"] if fused else [])
    ttrain.main(argv)
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if "loss=" in x][-1]
    loss = float(line.split("loss=")[1].split()[0])
    acc = float(line.split("test_acc=")[1].split()[0])
    assert math.isfinite(loss) and 0.0 <= acc <= 1.0
    assert "personalized_acc=" in out
    if method in ("spry", "spry_periter", "fedfgd"):
        assert f"estimator route: {'fused' if fused else 'standard'}" in out


def test_cli_defaults_follow_the_reference():
    """Per-method learning rates and server optimizer as the reference's
    entry point picks them; cuda without a card raises."""
    sc = {}
    orig = ttrain.build_round_step

    def spy(cfg, sc_, method, task="cls"):
        sc[method] = sc_
        raise StopIteration
    ttrain.build_round_step = spy
    try:
        for method in ("fedavg", "fedyogi", "baffle"):
            with pytest.raises(StopIteration):
                ttrain.run_training(method=method, rounds=1, clients_per_round=2,
                                    total_clients=6, device="cpu", log=lambda m: None)
    finally:
        ttrain.build_round_step = orig
    assert (sc["fedavg"].local_lr, sc["fedavg"].server_lr,
            sc["fedavg"].server_opt) == (5e-2, 1.0, "fedavg")
    assert (sc["fedyogi"].server_lr, sc["fedyogi"].server_opt) == (1e-2, "fedyogi")
    assert (sc["baffle"].local_lr, sc["baffle"].server_opt) == (5e-3, "fedyogi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.run_training(method="fedavg", rounds=1, device="cuda")
