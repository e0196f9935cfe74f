"""The port's configs, data, assignment, server optimizer and dense model
against the JAX package.

Weights are the reference's own (``init_base`` / ``init_peft`` with the LoRA
B factors made non-zero), carried over with ``repro_torch.convert``; hidden
states and losses of ``reduce_config`` roberta and llama2 agree at fp32
rel 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import assignment as jassign
from repro.data import make_task as jmake_task
from repro.fl.partition import dirichlet_partition as jdirichlet
from repro.fl.server import server_init as jserver_init
from repro.fl.server import server_update as jserver_update
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.peft import init_peft as jinit_peft
from repro.peft.lora import target_dims as jtarget_dims
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.data import make_task as tmake_task
from repro_torch.fl.partition import dirichlet_partition as tdirichlet
from repro_torch.fl.server import server_init as tserver_init
from repro_torch.fl.server import server_update as tserver_update
from repro_torch.kernels.dispatch import forward_ad_region
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.optim import optimizers as topt
from repro_torch.peft.lora import target_dims as ttarget_dims
from repro_torch.utils.pytree import tree_leaves

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)
ARCHS = ("roberta-large-lora", "llama2-7b")


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(arch, reduced):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if reduced:
        jc, tc = jcfgs.reduce_config(jc), tcfgs.reduce_config(tc)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.hd == jc.hd
    assert str(tc.dtype).removeprefix("torch.") == str(jc.dtype)
    for t in ("wq", "wv", "wk", "wo", "wi", "wd"):
        assert ttarget_dims(tc, t) == jtarget_dims(jc, t)


def test_numpy_modules_copy_the_reference():
    for a, b in zip(jmake_task("sst2", seed=3, vocab=300),
                    tmake_task("sst2", seed=3, vocab=300)):
        np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(0).integers(0, 4, 300)
    for a, b in zip(jdirichlet(y, 7, 0.1, seed=1), tdirichlet(y, 7, 0.1, seed=1)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, port cfg, jax base, jax peft, port base, port peft)."""
    jc = jcfgs.reduce_config(jcfgs.get_config(request.param))
    tc = tcfgs.reduce_config(tcfgs.get_config(request.param))
    key = jax.random.PRNGKey(0)
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, key)
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1),
                                                        jcfgs.SpryConfig())
    kb = jax.random.split(jax.random.PRNGKey(2), 2)
    for t, k in zip(("wq", "wv"), kb):
        B = jpeft["layers"][t]["B"]
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(k, B.shape)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    return jc, tc, jbase, jpeft, tbase, tpeft


def _batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.n_classes, (B,)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})


def test_assignment_equals_reference(model):
    _, _, _, jpeft, _, tpeft = model
    ji, ti = jassign.enumerate_units(jpeft), tassign.enumerate_units(tpeft)
    assert ji.units == ti.units and ji.spans == ti.spans
    for M, off in ((3, 1), (5, 4), (2, 0)):
        jm = jassign.assignment_matrix(ji.n_units, M, off)
        tm = tassign.assignment_matrix(ti.n_units, M, off)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(jassign.client_counts(jm)),
                                      tassign.client_counts(tm).numpy())
        jmask = jassign.build_mask_tree(jpeft, ji, jm[1])
        tmask = tassign.build_mask_tree(tpeft, ti, tm[1])
        for a, b in zip(jax.tree.leaves(jmask), tree_leaves(tmask)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_hidden_states_match_reference(model):
    jc, tc, jbase, jpeft, tbase, tpeft = model
    jb, tb = _batch(jc)
    jh = jax.jit(lambda p: jtf.forward(jc, jbase, p, jb["tokens"])[0])(jpeft)
    th, _ = ttf.forward(tc, tbase, tpeft, tb["tokens"])
    assert th.shape == jh.shape
    assert _rel(th, jh) <= 1e-5
    # inside the estimator's region the mixer is the flash op's plain version
    with forward_ad_region():
        th2, _ = ttf.forward(tc, tbase, tpeft, tb["tokens"])
    assert _rel(th2, jh) <= 1e-5


def test_losses_and_logits_match_reference(model):
    jc, tc, jbase, jpeft, tbase, tpeft = model
    jb, tb = _batch(jc, seed=1)
    pairs = ((jreg.cls_loss, treg.cls_loss), (jreg.lm_loss, treg.lm_loss),
             (jreg.cls_logits, treg.cls_logits))
    wants = jax.jit(lambda p: [jfn(jc, jbase, p, jb) for jfn, _ in pairs])(jpeft)
    for (jfn, tfn), want in zip(pairs, wants):
        got = tfn(tc, tbase, tpeft, tb)
        assert _rel(got, want) <= 1e-5, jfn.__name__


def _small_trees(seed, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [{"a": f(3, 4), "h": {"w": f(5)}} for _ in range(n)]


def _tt(t):
    return {"a": torch.from_numpy(t["a"]), "h": {"w": torch.from_numpy(t["h"]["w"])}}


@pytest.mark.parametrize("kind", ["fedyogi", "fedadam", "fedavg"])
def test_server_update_matches_reference(kind):
    p, d1, d2 = _small_trees(0, 3)
    jp, tp = jax.tree.map(jnp.asarray, p), _tt(p)
    js, ts = jserver_init(jp), tserver_init(tp)
    for d in (d1, d2):
        jp, js = jserver_update(kind, jp, jax.tree.map(jnp.asarray, d), js, lr=1e-2)
        tp, ts = tserver_update(kind, tp, _tt(d), ts, lr=1e-2)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert _rel(b, a) <= 1e-6


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "yogi"])
def test_client_optimizers_match_reference(name):
    p, g1, g2 = _small_trees(1, 3)
    jo, to = getattr(jopt, name)(1e-2), getattr(topt, name)(1e-2)
    jp, tp = jax.tree.map(jnp.asarray, p), _tt(p)
    js, ts = jo.init(jp), to.init(tp)
    for g in (g1, g2):
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(_tt(g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert _rel(b, a) <= 1e-6
