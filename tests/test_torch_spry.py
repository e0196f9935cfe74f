"""The port's forward-gradient estimator and SPRY rounds against the JAX
package, on reduced roberta with the reference's weights.

The reference's own perturbations (``repro.core.forward_grad.
stacked_perturbations`` from its key chain) are injected into the port, so
like is compared with like: jvps and gradient trees of all four estimator
routes at rel 1e-5 (against one reference estimate of K=5 shared by the
routes, ``test_torch_fused.shared_reference``); one ``spry`` and one ``spry_periter`` round with loss
and jvps at rel 1e-5 and the PEFT update at rel 1e-4 (FedYogi's
normalisation amplifies ulp differences). Inside the port the server's
rebuild equals the client's estimate bitwise, and every site launches ONE
multi-tangent call for all K tangents (counted here on the plain
versions' entry points; on the card the kernels' launch counters show the
same, see chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import assignment as jassign
from repro.core import forward_grad as jfg
from repro.core import spry as jspry
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.core import forward_grad as tfg
from repro_torch.core import spry as tspry
from repro_torch.kernels import dispatch
from repro_torch.models import registry as treg
from repro_torch.utils.pytree import tree_leaves, tree_map

from port_reference import unoptimized_reference  # noqa: F401 (autouse)
from test_torch_fused import (
    ROUTE_IDS,
    ROUTES,
    reference_at,
    reference_rounds,
    shared_reference,
)

torch.set_num_threads(1)
M = 3
_ref_perturbations = jax.jit(jfg.stacked_perturbations)   # one compile per K


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def setup():
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    tc = tcfgs.reduce_config(tcfgs.get_config("roberta-large-lora"))
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1),
                                                        jcfgs.SpryConfig())
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        B = jpeft["layers"][t]["B"]
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(k, B.shape)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (M, 2, 16)).astype(np.int32)
    labels = rng.integers(0, jc.n_classes, (M, 2)).astype(np.int32)
    return dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
                jbatch={"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                tbatch={"tokens": torch.from_numpy(tokens),
                        "labels": torch.from_numpy(labels)})


def _masks(s, client=1):
    ji = jassign.enumerate_units(s["jpeft"])
    jm = jassign.assignment_matrix(ji.n_units, M, 1)
    tm = tassign.assignment_matrix(ji.n_units, M, 1)
    return (jassign.build_mask_tree(s["jpeft"], ji, jm[client]),
            tassign.build_mask_tree(s["tpeft"], tassign.enumerate_units(s["tpeft"]),
                                    tm[client]))


def _losses(s, m=0):
    jb = jax.tree.map(lambda x: x[m], s["jbatch"])
    tb = {k: v[m] for k, v in s["tbatch"].items()}
    return (lambda p: jreg.cls_loss(s["jc"], s["jbase"], p, jb),
            lambda p: treg.cls_loss(s["tc"], s["tbase"], p, tb))


@pytest.fixture(scope="module")
def routes_ref(setup):
    """The reference's estimate, computed once for the four route cases
    (see ``test_torch_fused.shared_reference``)."""
    return shared_reference(_losses(setup)[0], setup["jpeft"], _masks(setup)[0])


@pytest.mark.parametrize("K,tb", ROUTES, ids=ROUTE_IDS)
def test_forward_gradient_routes_match_reference(setup, routes_ref, K, tb):
    s = setup
    _, tmask = _masks(s)
    _, tloss_fn = _losses(s)
    jloss, jg, jjvps = reference_at(routes_ref, K)
    tloss, tg, tjvps = tfg.forward_gradient(tloss_fn, s["tpeft"], 0, K,
                                            mask_tree=tmask, tangent_batch=tb,
                                            perturbations=tree_map(
                                                lambda v: v[:K], routes_ref["vs"]))
    assert tjvps.shape == (K,)
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-5


def test_port_routes_agree_and_server_rebuild_is_bitwise(setup):
    """Generator-drawn perturbations: every route sees the same v_i, and the
    server's rebuild from (key, jvps) is the client's estimate bit for bit."""
    s = setup
    _, tmask = _masks(s, client=2)
    _, loss_fn = _losses(s, 2)
    key = tfg.fold_in(tfg.fold_in(11, 2), 0)
    out = {tb: tfg.forward_gradient(loss_fn, s["tpeft"], key, 4, mask_tree=tmask,
                                    tangent_batch=tb) for tb in (None, 1, 3)}
    _, g, jvps = out[None]
    for tb in (1, 3):
        assert _rel(out[tb][2], jvps) <= 1e-5
        for a, b in zip(tree_leaves(out[tb][1]), tree_leaves(g)):
            assert _rel(a, b) <= 1e-5
    rebuilt = tfg.reconstruct_gradient(s["tpeft"], key, jvps, tmask)
    for a, b in zip(tree_leaves(rebuilt), tree_leaves(g)):
        assert torch.equal(a, b)
    # the per-iteration round pieces: client jvps -> server rebuild
    sc = tcfgs.SpryConfig(n_clients_per_round=M, k_perturbations=4)
    row = tassign.assignment_matrix(tassign.enumerate_units(s["tpeft"]).n_units,
                                    M, 1)[2]
    cb = {k: v[2] for k, v in s["tbatch"].items()}
    _, cj = tspry.make_client_jvp_fn(s["tc"], sc)(s["tbase"], s["tpeft"], 11, 2,
                                                  row, cb)
    assert torch.equal(cj, jvps)
    g_server = tspry.make_rebuild_fn()(s["tpeft"], 11, 2, row, cj)
    for a, b in zip(tree_leaves(g_server), tree_leaves(g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,tb,per_site", [(4, None, 1), (1, None, 1), (3, 1, 3)],
                         ids=["batched", "k1", "sequential"])
def test_one_multi_tangent_call_per_site(setup, monkeypatch, K, tb, per_site):
    """The batched estimate reaches each site's multi-tangent entry ONCE
    with T=K (the sequential route K times with T=1)."""
    s = setup
    calls = {"lora": [], "swa": [], "swa_mt": []}

    def counting(name, fn, t_arg):
        def f(*a):
            calls[name].append(a[t_arg].shape[0] if t_arg is not None else 1)
            return fn(*a)
        return f
    monkeypatch.setattr(dispatch, "lora_dual_mt_tangents",
                        counting("lora", dispatch.lora_dual_mt_tangents, 4))
    monkeypatch.setattr(dispatch, "swa_attention_mt_tangents",
                        counting("swa_mt", dispatch.swa_attention_mt_tangents, 3))
    monkeypatch.setattr(dispatch, "swa_attention",
                        counting("swa", dispatch.swa_attention, None))
    _, loss_fn = _losses(s)
    tfg.forward_gradient(loss_fn, s["tpeft"], 5, K, tangent_batch=tb)
    L = s["tc"].n_layers
    T = K if tb is None else 1
    assert calls["lora"] == [T] * (2 * L * per_site)     # wq, wv per layer
    assert calls["swa_mt"] == [T] * (L * per_site)
    assert calls["swa"] == [1] * (L * per_site)


def _reference_perturbations(s, sc, round_idx, iters):
    rk = jax.random.fold_in(jax.random.PRNGKey(sc.seed), round_idx)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    return [[_to_t(_ref_perturbations(
        jax.random.fold_in(jax.random.fold_in(rk, m), it), peft32,
        jnp.arange(sc.k_perturbations))) for it in range(iters)] for m in range(M)]


def _round_kw(method):
    return dict(n_clients_per_round=M, k_perturbations=4, local_lr=5e-3,
                server_lr=1e-2, local_iters=2 if method == "spry" else 1, seed=3)


@pytest.fixture(scope="module")
def spry_reference_rounds(setup):
    """The reference's ``spry`` (2 local iterations) and ``spry_periter``
    rounds, in one jit (``test_torch_fused.reference_rounds``)."""
    s = setup
    return reference_rounds(
        {"spry": jspry.make_round_step(s["jc"], jcfgs.SpryConfig(**_round_kw("spry"))),
         "spry_periter": jspry.make_round_step_per_iteration(
             s["jc"], jcfgs.SpryConfig(**_round_kw("spry_periter")))},
        dict.fromkeys(("spry", "spry_periter"), jspry.init_state(s["jbase"], s["jpeft"])),
        s["jbatch"])


@pytest.mark.parametrize("method", ["spry", "spry_periter"])
def test_round_matches_reference(setup, spry_reference_rounds, method):
    s = setup
    iters = 2 if method == "spry" else 1
    jsc, tsc = jcfgs.SpryConfig(**_round_kw(method)), tcfgs.SpryConfig(**_round_kw(method))
    tstep = (tspry.make_round_step(s["tc"], tsc) if method == "spry"
             else tspry.make_round_step_per_iteration(s["tc"], tsc))
    jstate, jmet = spry_reference_rounds[method]
    tstate, tmet = tstep(tspry.init_state(s["tbase"], s["tpeft"]), s["tbatch"],
                         _reference_perturbations(s, jsc, 0, iters))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(jstate.peft),
                                 tree_leaves(tstate.peft),
                                 jax.tree.leaves(s["jpeft"])):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(old, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(old, np.float64)
        assert _rel(t_delta, j_delta) <= 1e-4
    assert tstate.round_idx == 1
    assert dataclasses.asdict(tsc)["k_perturbations"] == 4


def test_spry_config_fields_equal_reference():
    """Every field of the reference's SpryConfig, in its order and with its
    default, is the port's."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tcfgs.SpryConfig) == fields(jcfgs.SpryConfig)


def test_comm_modes_other_than_per_epoch_raise(setup):
    """make_round_step runs per-epoch rounds: a config that asks for
    per-iteration rounds raises instead of silently running per-epoch ones."""
    with pytest.raises(NotImplementedError, match="per_iteration"):
        tspry.make_round_step(setup["tc"],
                              tcfgs.SpryConfig(comm_mode="per_iteration"))
    tspry.make_round_step_per_iteration(
        setup["tc"], tcfgs.SpryConfig(comm_mode="per_iteration"))


def test_microbatch_client_update_matches_reference(setup):
    """The client update with ``microbatch_size=2`` at batch 8 (four
    microbatches, each with its own perturbations from ``fold_in(ikey, i)``,
    injected from the reference's key chain): the averaged loss, the first
    microbatch's K jvps and the delta at rel 1e-5."""
    s = setup
    K, mb, seed_id = 2, 2, 1
    kw = dict(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
              microbatch_size=mb, seed=3)
    jsc, tsc = jcfgs.SpryConfig(**kw), tcfgs.SpryConfig(**kw)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, s["jc"].vocab, (8, 16)).astype(np.int32)
    labels = rng.integers(0, s["jc"].n_classes, (8,)).astype(np.int32)
    ji = jassign.enumerate_units(s["jpeft"])
    row = np.asarray(jassign.assignment_matrix(ji.n_units, M, 0)[seed_id])
    rk = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    jdelta, jloss, jjvps = jax.jit(jspry.make_client_update_fn(s["jc"], jsc))(
        s["jbase"], s["jpeft"], rk, seed_id, jnp.asarray(row),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    ikey = jax.random.fold_in(jax.random.fold_in(rk, seed_id), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    perts = {seed_id: [[_to_t(_ref_perturbations(jax.random.fold_in(ikey, i), peft32,
                                                 jnp.arange(K)))
                        for i in range(8 // mb)]]}
    tdelta, tloss, tjvps = tspry.make_client_update_fn(s["tc"], tsc)(
        s["tbase"], s["tpeft"], 0, seed_id, torch.from_numpy(row),
        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
        perts)
    assert tuple(tjvps.shape) == tuple(jjvps.shape) == (1, K)
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    for a, b in zip(jax.tree.leaves(jdelta), tree_leaves(tdelta)):
        assert _rel(b, a) <= 1e-5
