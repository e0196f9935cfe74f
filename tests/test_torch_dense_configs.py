"""The other dense configs of the port (gemma3-12b, gemma3-27b,
h2o-danube-3-4b, command-r-plus-104b) and the registry's data against the
JAX package.

- Every field of the four configs, ``ASSIGNED_ARCHS``, ``ALL_ARCHS``,
  ``INPUT_SHAPES``, ``get_shape``, ``shape_applicable`` (each arch x each
  shape), ``sub_quadratic`` and the parameter estimates equal the
  reference's; ``get_config`` raises for the archs whose families are not
  ported.
- Three reduced stacks keep what ``reduce_config`` alone would hide (its
  head_dim=64 and G=2), on both sides: gemma3-12b at head_dim 256 with 6
  layers (5 local : 1 global, so layer 5 is global), h2o-danube at head_dim
  120 (sliding window), command-r at 12 query heads on 1 KV head (G=12).
  Sequences of 80 tokens run past the reduced window of 64, so the band
  engages. The reference's weights are carried over (``from_reference``:
  tied embeddings, no ``lm_head``, GQA ``wk``/``wv`` of n_kv_heads x hd, no
  biases) and its perturbations injected: one SPRY round on the standard
  and on the fused-contraction route, loss and jvps within fp32 rel 1e-5
  and the PEFT update within rel 1e-4, the existing dense round tests'
  tolerances (tests/test_torch_spry.py). The reference's rounds of a stack
  run in one jit, computed once per module.
- Serving: ``prefill`` then one ``decode_step`` against the reference's,
  logits and caches at rel 1e-5: the mixed local:global gemma3 stack (per
  layer ``window_len``) and h2o-danube's ring (a 4096-slot ring cut to the
  reduced 64 slots) with a prompt longer than the window.
- Acc_p: ``personalized_accuracy`` with the reference's head perturbations
  injected equals the reference's on the same state, shards and draws.
- The train CLI raises for ``--arch gemma3-12b`` without a card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import forward_grad as jfg
from repro.core import spry as jspry
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import spry as tspry
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget_model
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from test_torch_fused import reference_rounds

torch.set_num_threads(1)
DENSE = ("gemma3-12b", "gemma3-27b", "h2o-danube-3-4b", "command-r-plus-104b")
M, B, S = 1, 2, 80           # clients, batch a client, tokens (> the reduced window 64)
_ref_perturbations = jax.jit(jfg.stacked_perturbations)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# configs and the registry's data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_equal_reference(arch):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    want = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    got = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    # the moe, encdec and vlm fields are not ported; every dense config
    # leaves them at their defaults
    for name in ("moe", "encoder_layers", "encoder_seq", "frontend", "n_frontend_tokens"):
        assert want.pop(name) in (None, 0)
    assert got == want
    assert tc.hd == jc.hd and tc.sub_quadratic == jc.sub_quadratic
    assert tc.n_param_estimate() == jc.n_param_estimate()
    assert tc.n_active_param_estimate() == jc.n_active_param_estimate()
    for i in range(tc.n_layers):
        assert tc.is_global_layer(i) == jc.is_global_layer(i)


def test_registry_tables_equal_reference():
    assert tcfgs.ASSIGNED_ARCHS == jcfgs.ASSIGNED_ARCHS
    assert tcfgs.ALL_ARCHS == jcfgs.ALL_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in tcfgs.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jcfgs.INPUT_SHAPES.items()}
    ported = []
    for arch in jcfgs.ALL_ARCHS:
        jc = jcfgs.get_config(arch)
        if jc.family not in ("dense", "ssm", "hybrid"):
            with pytest.raises(KeyError, match="not yet ported"):
                tcfgs.get_config(arch)
            continue
        tc = tcfgs.get_config(arch)
        ported.append(arch)
        assert tc.sub_quadratic == jc.sub_quadratic, arch
        assert tc.n_param_estimate() == jc.n_param_estimate(), arch
        assert tc.n_active_param_estimate() == jc.n_active_param_estimate(), arch
        for name in jcfgs.INPUT_SHAPES:
            ts, js = tcfgs.get_shape(name), jcfgs.get_shape(name)
            assert dataclasses.astuple(ts) == dataclasses.astuple(js)
            assert tcfgs.shape_applicable(tc, ts) == jcfgs.shape_applicable(jc, js), \
                (arch, name)
    assert len(ported) == 8 and set(DENSE) <= set(ported)


# ---------------------------------------------------------------------------
# the reduced stacks: from_reference, a SPRY round on both routes, serving
# ---------------------------------------------------------------------------

# name -> (arch, what reduce_config would lose, put back on both sides)
STACKS = {
    "gemma3_hd256": ("gemma3-12b", dict(n_layers=6, head_dim=256)),
    "h2o_hd120": ("h2o-danube-3-4b", dict(head_dim=120)),
    "command_r_g12": ("command-r-plus-104b", dict(n_heads=12, n_kv_heads=1)),
}


def _round_kw(fused):
    return dict(n_clients_per_round=M, k_perturbations=2, local_lr=5e-3,
                server_lr=1e-2, fused_contraction=fused, seed=3)


@functools.partial(jax.jit, static_argnums=0)
def _reference_weights(jc):
    """The reference's ``init_base`` and ``init_peft`` (with the LoRA B
    factors made non-zero), compiled once instead of drawn leaf by leaf."""
    jbase = jtf.init_base(jc, jax.random.PRNGKey(0))
    jpeft = jinit_peft(jc, jax.random.PRNGKey(1), jcfgs.SpryConfig())
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        shape = jpeft["layers"][t]["B"].shape
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(k, shape)
    return jbase, jpeft


def _stack(name):
    arch, keep = STACKS[name]
    jc = dataclasses.replace(jcfgs.reduce_config(jcfgs.get_config(arch)), **keep)
    tc = dataclasses.replace(tcfgs.reduce_config(tcfgs.get_config(arch)), **keep)
    jbase, jpeft = _reference_weights(jc)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (M, B, S)).astype(np.int32)
    labels = rng.integers(0, jc.n_classes, (M, B)).astype(np.int32)
    s = dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
             jbatch={"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
             tbatch={"tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)})
    # the reference's rounds on both routes, in one jit
    s["rounds"] = reference_rounds(
        {route: jspry.make_round_step(jc, jcfgs.SpryConfig(**_round_kw(route == "fused")))
         for route in ("standard", "fused")},
        dict.fromkeys(("standard", "fused"), jspry.init_state(jbase, jpeft)), s["jbatch"])
    return s


@pytest.fixture(scope="module")
def stacks():
    """name -> the stack, built at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _stack(name)
        return cache[name]
    return get


def _reference_perturbations(s, sc):
    rk = jax.random.fold_in(jax.random.PRNGKey(sc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    return [[_to_t(_ref_perturbations(jax.random.fold_in(jax.random.fold_in(rk, m), 0),
                                      peft32, jnp.arange(sc.k_perturbations)))]
            for m in range(M)]


@pytest.mark.parametrize("name", list(STACKS))
def test_from_reference_carries_the_weights(stacks, name):
    s = stacks(name)
    tc = s["tc"]
    jleaves = dict(tree_paths(_to_t(s["jbase"])))
    tleaves = dict(tree_paths(s["tbase"]))
    assert set(tleaves) == set(jleaves)
    assert (("lm_head",) in tleaves) == (not tc.tie_embeddings)    # gemma3, command-r: tied
    assert not any(p[-1].endswith("_b") for p in tleaves)          # use_bias=False
    kv = tc.n_kv_heads * tc.hd
    assert tuple(tleaves[("layers", "attn", "wk")].shape) == (tc.n_layers, tc.d_model, kv)
    assert tuple(tleaves[("layers", "attn", "wv")].shape) == (tc.n_layers, tc.d_model, kv)
    for path, leaf in tleaves.items():
        assert torch.equal(leaf, jleaves[path]), path
    # the port's own init draws the same shapes
    mine = dict(tree_paths(tget_model(tc).init_base(tc, torch.Generator().manual_seed(0))))
    assert {p: tuple(v.shape) for p, v in mine.items()} == {
        p: tuple(v.shape) for p, v in tleaves.items()}


@pytest.mark.parametrize("route", ["standard", "fused"])
@pytest.mark.parametrize("name", list(STACKS))
def test_spry_round_matches_reference(stacks, name, route):
    s = stacks(name)
    sc = tcfgs.SpryConfig(**_round_kw(route == "fused"))
    jstate, jmet = s["rounds"][route]
    tstate, tmet = tspry.make_round_step(s["tc"], sc)(
        tspry.init_state(s["tbase"], s["tpeft"]), s["tbatch"],
        _reference_perturbations(s, jcfgs.SpryConfig(**_round_kw(route == "fused"))))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(jstate.peft), tree_leaves(tstate.peft),
                                 jax.tree.leaves(s["jpeft"])):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(old, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(old, np.float64)
        assert _rel(t_delta, j_delta) <= 1e-4


@pytest.mark.parametrize("name", ["gemma3_hd256", "h2o_hd120"])
def test_prefill_and_decode_match_reference(stacks, name):
    """Prefill of a prompt longer than the window, then one decode step
    (a per-row ``pos``): the gemma3 stack attends with each layer's window
    (local 64, the global layer all of its cache); h2o-danube's cache is a
    ring of ``window`` slots that the prompt wraps."""
    s = stacks(name)
    jc, tc = s["jc"], s["tc"]
    prompt = s["jbatch"]["tokens"][0, :, :70]
    P, new = prompt.shape[1], 4
    jmodel, tmodel = jget_model(jc), tget_model(tc)
    jpeft = jax.tree.map(lambda x: x, s["jpeft"])
    jcache = jmodel.init_cache(jc, B, P + new)
    logits0, jcache0 = jax.jit(lambda c: jmodel.prefill(jc, s["jbase"], jpeft, c,
                                                         prompt))(jcache)
    tok = jnp.argmax(logits0, -1)[:, None].astype(jnp.int32)
    pos = jnp.asarray([P, P - 3], jnp.int32)
    logits1, jcache1 = jax.jit(lambda c: jmodel.decode_step(jc, s["jbase"], jpeft, c, tok,
                                                            pos))(jcache0)
    tcache = tmodel.init_cache(tc, B, P + new, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    if name == "h2o_hd120":
        assert tcache["k"].shape[2] == tc.window < P      # the ring wraps
    with torch.inference_mode():
        got0, tcache = tmodel.prefill(tc, s["tbase"], s["tpeft"], tcache,
                                      torch.from_numpy(np.asarray(prompt)))
        assert _rel(got0, logits0) <= 1e-5
        for k in ("k", "v"):
            assert _rel(tcache[k], jcache0[k]) <= 1e-5
        got1, tcache = tmodel.decode_step(tc, s["tbase"], s["tpeft"], tcache,
                                          torch.from_numpy(np.asarray(tok)),
                                          torch.from_numpy(np.asarray(pos)))
    assert _rel(got1, logits1) <= 1e-5
    for k in ("k", "v"):
        assert _rel(tcache[k], jcache1[k]) <= 1e-5


# ---------------------------------------------------------------------------
# Acc_p and the train CLI
# ---------------------------------------------------------------------------

def test_personalized_accuracy_matches_reference(monkeypatch):
    """The port's Acc_p with the reference's head perturbations injected
    (each step's draw over the whole PEFT tree under the head mask, as the
    reference's ``forward_gradient`` makes it, cut to the head) against the
    reference's ``personalized_accuracy`` on the same weights, shards and
    numpy draws: equal accuracies, up to the fp32 rounding of each client's
    fraction (1e-6; one held-out prediction more or less moves the mean by
    1/(clients x held-out) = 1/8 here). The reference's loss and logits
    run under ``jax.jit`` (the same function, compiled once instead of
    dispatched op by op)."""
    from repro.models import registry as jreg
    monkeypatch.setattr(jreg, "cls_loss", jax.jit(jreg.cls_loss, static_argnums=0))
    monkeypatch.setattr(jtrain, "cls_logits", jax.jit(jtrain.cls_logits, static_argnums=0))
    jc = dataclasses.replace(jcfgs.reduce_config(jcfgs.get_config("llama2-7b")),
                             n_layers=1, n_classes=2)
    tc = dataclasses.replace(tcfgs.reduce_config(tcfgs.get_config("llama2-7b")),
                             n_layers=1, n_classes=2)
    jbase, jpeft = _reference_weights(jc)
    jpeft["head"] = jax.tree.map(lambda x: 0.3 * jax.random.normal(
        jax.random.PRNGKey(5), x.shape), jpeft["head"])
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, jc.vocab, (40, 12)).astype(np.int32)
    y = rng.integers(0, 2, (40,)).astype(np.int32)

    class Client:               # two shards of 20: 16 to finetune on, 4 held out
        def __init__(self, idx):
            self.indices = idx
    clients = [Client(idx) for idx in rng.permutation(40).reshape(2, 20)]
    peft32 = jax.tree.map(lambda a: a.astype(jnp.float32), jpeft)
    head_mask = {g: jax.tree.map(lambda _: jnp.float32(1.0 if g == "head" else 0.0), t)
                 for g, t in jpeft.items()}

    draw = jax.jit(lambda key: jfg.masked_perturbation(
        jax.random.fold_in(jax.random.PRNGKey(key), 0), peft32, head_mask)["head"])

    def perturbations(key):     # the reference's K=1 draw for ``key``, the head's leaves
        return {"head": tree_map(lambda a: a[None], _to_t(draw(key)))}

    kw = dict(steps=2, batch_size=4, max_clients=2)
    want = jtrain.personalized_accuracy(jc, jspry.init_state(jbase, jpeft), clients, x, y,
                                        np.random.default_rng(9), **kw)
    got = ttrain.personalized_accuracy(tc, tspry.init_state(tbase, tpeft), clients, x, y,
                                       np.random.default_rng(9), "cpu",
                                       perturbations=perturbations, **kw)
    assert np.isfinite(want) and abs(got - want) <= 1e-6


def test_train_cli_raises_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "gemma3-12b", "--rounds", "1"])
