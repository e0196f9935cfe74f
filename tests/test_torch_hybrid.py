"""The port's hybrid family (zamba2: mamba2 layers plus one shared attention
block) against the JAX package.

Two reduced configs, as tests/test_split_forward.py builds them:
``reduce_config(zamba2)`` (2 layers, the shared block after each, so the
final site is attention) and the same with ``n_layers=3,
hybrid_attn_every=2`` (the final site is the mamba2 recurrence). Weights
are the reference's own (``init_base`` / ``init_peft`` with every LoRA B
factor made non-zero, the shared block's included), carried over with
``repro_torch.convert``; tokens and labels are made with numpy from a seed,
and the reference's own perturbations are injected into the port. JAX runs
on the CPU (its 'jnp' dispatch backend). Tolerances:

- configs, peft trees, LoRA targets and trainable units equal the
  reference's exactly;
- hidden states, losses and the split pieces at fp32 rel 1e-5; inside the
  port the split composition equals ``forward`` and the split loss the
  plain loss bitwise, for both site kinds;
- forward-gradient estimates (the 'mamba2' site's fused route and the
  standard route) and one ``spry`` / ``spry_periter`` round on each route
  (against the reference's round on its standard route, computed once a
  method): loss and jvps rel 1e-5, gradients rel 1e-5, PEFT updates rel
  1e-4 (as tests/test_torch_spry.py);
- launches per estimate, counted on the plain versions' entry points, for
  both site kinds on both routes and for full zamba2's layer pattern (38
  layers, the shared block after every 6th) at reduced width; they equal
  what ``chip_smoke.round_launches`` holds the card to.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import assignment as jassign
from repro.core import forward_grad as jfg
from repro.core import spry as jspry
from repro.models import hybrid as jhyb
from repro.models import registry as jreg
from repro.peft import init_peft as jinit_peft
from repro.peft.lora import default_lora_targets as jdefault_targets
from repro.peft.lora import target_dims as jtarget_dims
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.core import forward_grad as tfg
from repro_torch.core import spry as tspry
from repro_torch.kernels import dispatch
from repro_torch.models import hybrid as thyb
from repro_torch.models import registry as treg
from repro_torch.peft import init_peft
from repro_torch.peft.lora import default_lora_targets as tdefault_targets
from repro_torch.peft.lora import target_dims as ttarget_dims
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from port_reference import unoptimized_reference  # noqa: F401 (autouse)
from test_torch_fused import reference_at, reference_rounds, shared_reference

torch.set_num_threads(1)
M = 2
ARCH = "zamba2-1.2b"
_ref_perturbations = jax.jit(jfg.stacked_perturbations)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _configs(variant):
    jc = jcfgs.reduce_config(jcfgs.get_config(ARCH))
    tc = tcfgs.reduce_config(tcfgs.get_config(ARCH))
    if variant == "m2":        # final layer not an application site
        jc = dataclasses.replace(jc, n_layers=3, hybrid_attn_every=2)
        tc = dataclasses.replace(tc, n_layers=3, hybrid_attn_every=2)
    return jc, tc


def _model(variant):
    jc, tc = _configs(variant)
    jbase = jax.jit(jhyb.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1),
                                                        jcfgs.SpryConfig())
    keys = iter(jax.random.split(jax.random.PRNGKey(2), 8))
    for group in ("layers", "shared"):
        for t in jpeft[group]:
            B = jpeft[group][t]["B"]
            jpeft[group][t]["B"] = 0.2 * jax.random.normal(next(keys), B.shape)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (M, 2, 16)).astype(np.int32)
    labels = rng.integers(0, jc.n_classes, (M, 2)).astype(np.int32)
    return dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
                jbatch={"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                tbatch={"tokens": torch.from_numpy(tokens),
                        "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module")
def attn_final():
    return _model("attn")


@pytest.fixture(scope="module")
def m2_final():
    return _model("m2")


def _first(s):
    return (jax.tree.map(lambda x: x[0], s["jbatch"]),
            {k: v[0] for k, v in s["tbatch"].items()})


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# configs, PEFT trees, trainable units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "attn", "m2"])
def test_config_fields_equal_reference(variant):
    if variant == "full":
        jc, tc = jcfgs.get_config(ARCH), tcfgs.get_config(ARCH)
    else:
        jc, tc = _configs(variant)
    for f in dataclasses.fields(tc):
        t, j = getattr(tc, f.name), getattr(jc, f.name)
        if f.name == "ssm":
            t, j = dataclasses.asdict(t), dataclasses.asdict(j)
        assert t == j, f.name
    assert tc.hd == jc.hd
    assert thyb.split_site(tc) == jhyb.split_site(jc)


@pytest.mark.parametrize("variant", ["attn_final", "m2_final"])
def test_peft_trees_and_units_equal_reference(variant, request):
    s = request.getfixturevalue(variant)
    jc, tc = s["jc"], s["tc"]
    assert tdefault_targets(tc) == jdefault_targets(jc) == ("in_proj", "out_proj")
    for t in ("in_proj", "out_proj", "wq", "wv"):
        assert ttarget_dims(tc, t) == jtarget_dims(jc, t)
    gen = torch.Generator().manual_seed(0)
    own = init_peft(tc, gen, tcfgs.SpryConfig())
    # the fixture's reference tree is ``init_peft``'s with its B values
    # redrawn: the same paths and shapes
    want = [(p, tuple(leaf.shape)) for p, leaf in tree_paths(
        jax.tree.map(np.asarray, s["jpeft"]))]
    assert [(p, tuple(leaf.shape)) for p, leaf in tree_paths(own)] == want
    assert ("shared", "wq", "A") in [p for p, _ in want]
    ti, ji = tassign.enumerate_units(s["tpeft"]), jassign.enumerate_units(s["jpeft"])
    assert ti.units == ji.units and ti.spans == ji.spans
    assert ("shared", "wq", -1) in ti.units
    tm = tassign.assignment_matrix(ti.n_units, 3, 1)
    jm = jassign.assignment_matrix(ji.n_units, 3, 1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jmask = jassign.build_mask_tree(s["jpeft"], ji, jm[1])
    tmask = tassign.build_mask_tree(s["tpeft"], ti, tm[1])
    for a, b in zip(tree_leaves(tmask), jax.tree.leaves(jmask)):
        np.testing.assert_array_equal(np.broadcast_to(a.numpy(), np.shape(b)), b)
    # the depth check covers base["layers"]["mix"]; the unstacked "shared"
    # groups are carried across as they are
    short = dataclasses.replace(tc, n_layers=tc.n_layers + 1)
    jbase_np = jax.tree.map(np.asarray, s["jbase"])
    jbase_np["layers"] = {"mix": jbase_np["layers"]["mix"]}
    with pytest.raises(ValueError, match="base layers/mix/.* has depth"):
        from_reference(short, jbase_np, jax.tree.map(np.asarray, s["jpeft"]), "cpu")
    for a, b in zip(tree_leaves(s["tbase"]["shared"]),
                    jax.tree.leaves(s["jbase"]["shared"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the model and its split pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["attn_final", "m2_final"])
def test_hidden_states_and_losses_match_reference(variant, request):
    s = request.getfixturevalue(variant)
    jb, tb = _first(s)
    names = ("cls_loss", "lm_loss", "cls_logits")
    jh, wants = jax.jit(lambda p: (
        jhyb.forward(s["jc"], s["jbase"], p, jb["tokens"])[0],
        [getattr(jreg, n)(s["jc"], s["jbase"], p, jb) for n in names]))(s["jpeft"])
    th, taux = thyb.forward(s["tc"], s["tbase"], s["tpeft"], tb["tokens"])
    assert _rel(th, jh) <= 1e-5 and float(taux) == 0.0
    for name, want in zip(names, wants):
        got = getattr(treg, name)(s["tc"], s["tbase"], s["tpeft"], tb)
        assert _rel(got, want) <= 1e-5, name


@pytest.mark.parametrize("variant", ["attn_final", "m2_final"])
def test_split_pieces_match_reference_and_compose_bitwise(variant, request):
    """split_forward / split_post against the reference's at rel 1e-5; in
    the port the composition is ``forward`` and the split loss the plain
    loss, bit for bit, outside and inside the forward-AD region."""
    s = request.getfixturevalue(variant)
    jb, tb = _first(s)
    @jax.jit
    def ref(p):
        args, ctx = jhyb.split_forward(s["jc"], s["jbase"], p, jb["tokens"])
        y = jhyb.mixer_site(s["jc"], args)
        return args, ctx, y, jhyb.split_post(s["jc"], s["jbase"], y, ctx, p)[0]
    jargs, jctx, y, jh = ref(s["jpeft"])
    targs, tctx = thyb.split_forward(s["tc"], s["tbase"], s["tpeft"], tb["tokens"])
    for t, j in zip(targs, jargs):
        assert tuple(t.shape) == j.shape and _rel(t, j) <= 1e-5
    assert sorted(tctx) == sorted(jctx)
    for k in tctx:
        assert _rel(tctx[k], jctx[k]) <= 1e-5
    th, _ = thyb.split_post(s["tc"], s["tbase"], torch.from_numpy(np.array(y)),
                            tctx, s["tpeft"])
    assert _rel(th, jh) <= 1e-5
    composed = thyb.split_post(s["tc"], s["tbase"], thyb.mixer_site(s["tc"], targs),
                               tctx, s["tpeft"])[0]
    assert torch.equal(composed, thyb.forward(s["tc"], s["tbase"], s["tpeft"],
                                              tb["tokens"])[0])
    for task in ("cls", "lm"):
        split = treg.get_loss_fn(task, split=True)(s["tc"], s["tbase"], tb)
        assert split.kind == thyb.split_site(s["tc"])[0]
        plain = treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb)
        assert torch.equal(split(s["tpeft"]), plain)
        with dispatch.forward_ad_region():
            inside = treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb)
            assert torch.equal(split(s["tpeft"]), inside)
        assert _rel(inside, plain) <= 1e-5


# ---------------------------------------------------------------------------
# the estimator on both routes
# ---------------------------------------------------------------------------

def _masks(s, client=1):
    ji = jassign.enumerate_units(s["jpeft"])
    jm = jassign.assignment_matrix(ji.n_units, 3, 1)
    tm = tassign.assignment_matrix(ji.n_units, 3, 1)
    return (jassign.build_mask_tree(s["jpeft"], ji, jm[client]),
            tassign.build_mask_tree(s["tpeft"], tassign.enumerate_units(s["tpeft"]),
                                    tm[client]))


@pytest.fixture(scope="module")
def m2_site_ref(m2_final):
    """The reference's fused estimate of the 'mamba2' split loss, computed
    once for both route cases (see ``test_torch_fused.shared_reference``)."""
    s = m2_final
    jb, _ = _first(s)
    return shared_reference(jreg.get_loss_fn("cls", split=True)(s["jc"], s["jbase"], jb),
                            s["jpeft"], _masks(s)[0], fused=True)


@pytest.mark.parametrize("K,tb", [(4, None), (5, 2)], ids=["batched", "chunked"])
def test_mamba2_site_estimate_matches_reference(m2_final, m2_site_ref, K, tb):
    """The 'mamba2' split loss (the final site is the recurrence) on the
    fused route against the reference's fused estimate with the same
    perturbations (the standard route is held to the reference by the round
    tests below, and to the fused route inside the port): loss and jvps at rel
    1e-5. The gradient is the combine of those jvps with the same
    perturbations, so it is held to the reference's gradient at 1e-5 of the
    combine's scale, (1/K) sum_k |jvp_k| |v_k| per element. (A leaf such as
    the 4-element head bias is a near-cancelling sum of K terms, so its own
    size is no scale: the jvps' ~6e-6 cross-framework difference, which
    each op's 1e-7 rounding builds up through three layers of the
    recurrence, can exceed 1e-5 of it.)"""
    s = m2_final
    jb, tb_ = _first(s)
    _, tmask = _masks(s)
    jsplit = jreg.get_loss_fn("cls", split=True)(s["jc"], s["jbase"], jb)
    tsplit = treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], tb_)
    assert jsplit.kind == tsplit.kind == "mamba2"
    jloss, jg, jjvps = reference_at(m2_site_ref, K)
    vs = tree_map(lambda v: v[:K], m2_site_ref["vs"])
    tloss, tg, tjvps = tfg.forward_gradient(tsplit, s["tpeft"], 0, K,
                                            mask_tree=tmask, tangent_batch=tb,
                                            perturbations=vs,
                                            fused_contraction=True)
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    vm = tree_map(lambda v, m: v * m, vs, tmask)
    scale = tree_map(lambda v: torch.tensordot(tjvps.abs(), v.abs(), dims=([0], [0])) / K,
                     vm)
    for a, b, sc in zip(jax.tree.leaves(jg), tree_leaves(tg), tree_leaves(scale)):
        err = float((b.double() - torch.from_numpy(np.array(a, np.float64))).abs().max())
        assert err <= 1e-5 * float(sc.max())


@pytest.mark.parametrize("variant", ["attn_final", "m2_final"])
def test_fused_agrees_with_standard_inside_the_port(variant, request):
    """Loss bitwise, jvps within 5e-6 of their scale, gradients rtol 1e-4
    (the reference's route tolerances, tests/test_split_forward.py)."""
    s = request.getfixturevalue(variant)
    _, tb_ = _first(s)
    split = treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], tb_)
    l1, g1, j1 = tfg.forward_gradient(split, s["tpeft"], 9, 4, fused_contraction=True)
    l0, g0, j0 = tfg.forward_gradient(split, s["tpeft"], 9, 4)
    assert torch.equal(l1, l0)
    assert float((j1 - j0).abs().max()) <= 5e-6 * float(j0.abs().max())
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _reference_perturbations(s, sc, iters):
    rk = jax.random.fold_in(jax.random.PRNGKey(sc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    return [[_to_t(_ref_perturbations(
        jax.random.fold_in(jax.random.fold_in(rk, m), it), peft32,
        jnp.arange(sc.k_perturbations))) for it in range(iters)] for m in range(M)]


def _round_kw(fused=False):
    return dict(n_clients_per_round=M, k_perturbations=4, local_lr=5e-3,
                server_lr=1e-2, seed=3, fused_contraction=fused)


@pytest.fixture(scope="module")
def m2_reference_rounds(m2_final):
    """The reference's ``spry`` and ``spry_periter`` rounds on its standard
    route, in one jit (``test_torch_fused.reference_rounds``), shared by the
    port's two route cases (the reference's own routes' agreement is its
    own tests', tests/test_split_forward.py)."""
    s, jsc = m2_final, jcfgs.SpryConfig(**_round_kw())
    return reference_rounds(
        {"spry": jspry.make_round_step(s["jc"], jsc),
         "spry_periter": jspry.make_round_step_per_iteration(s["jc"], jsc)},
        dict.fromkeys(("spry", "spry_periter"), jspry.init_state(s["jbase"], s["jpeft"])),
        s["jbatch"])


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("method", ["spry", "spry_periter"])
def test_round_matches_reference(m2_final, m2_reference_rounds, method, fused):
    """One round of the port on either route against the reference's round
    (its standard route) with the same perturbations: loss and mean |jvp|
    at rel 1e-5, each PEFT update at rel 1e-4."""
    s = m2_final
    jsc, tsc = jcfgs.SpryConfig(**_round_kw(fused)), tcfgs.SpryConfig(**_round_kw(fused))
    make_t = (tspry.make_round_step if method == "spry"
              else tspry.make_round_step_per_iteration)
    jstate, jmet = m2_reference_rounds[method]
    tstate, tmet = make_t(s["tc"], tsc)(tspry.init_state(s["tbase"], s["tpeft"]),
                                        s["tbatch"], _reference_perturbations(s, jsc, 1))
    assert tspry.estimator_route(tsc) == jspry.estimator_route(jsc)
    assert float(tmet["fused_route"]) == float(fused)
    assert float(jmet["fused_route"]) == 0.0
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(jstate.peft),
                                 tree_leaves(tstate.peft),
                                 jax.tree.leaves(s["jpeft"])):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(old, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(old, np.float64)
        assert _rel(t_delta, j_delta) <= 1e-4


# ---------------------------------------------------------------------------
# launches per estimate
# ---------------------------------------------------------------------------

_ENTRIES = {   # counter name -> (dispatch entry point, index of the T axis)
    "lora_dual_mt": ("lora_dual_mt_tangents", 4),
    "lora_dual_mt_jvps": ("lora_dual_mt_jvps", 3),
    "swa_attention": ("swa_attention", None),
    "swa_attention_mt": ("swa_attention_mt_tangents", 3),
    "swa_attention_mt_jvps": ("swa_attention_mt_jvps", 3),
    "mamba2_scan": ("mamba2_scan", None),
    "mamba2_scan_mt": ("mamba2_scan_mt_tangents", 4),
    "mamba2_scan_mt_jvps": ("mamba2_scan_mt_jvps", 4),
    "lora_dual_multi": ("lora_dual_multi", None),
    "wkv6_scan": ("wkv6_scan", None),
    "wkv6_scan_mt": ("wkv6_scan_mt_tangents", 5),
    "wkv6_scan_mt_jvps": ("wkv6_scan_mt_jvps", 5),
}


def _count_calls(monkeypatch):
    calls = {k: [] for k in _ENTRIES}
    for name, (attr, t_arg) in _ENTRIES.items():
        def f(*a, _fn=getattr(dispatch, attr), _n=name, _t=t_arg, **k):
            calls[_n].append(a[_t].shape[0] if _t is not None else 1)
            return _fn(*a, **k)
        monkeypatch.setattr(dispatch, attr, f)
    return calls


def _zamba2_pattern_cfg():
    """Full zamba2's layer pattern (38 layers, shared block after every 6th,
    final site mamba2) at reduced width."""
    _, tc = _configs("attn")
    full = tcfgs.get_config(ARCH)
    return dataclasses.replace(tc, n_layers=full.n_layers,
                               hybrid_attn_every=full.hybrid_attn_every)


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("variant", ["attn_final", "m2_final", "zamba2_pattern"])
def test_launches_per_estimate(monkeypatch, request, variant, fused):
    """One estimate (K=3) makes exactly the launches chip_smoke.py holds the
    card to, each multi-tangent call carrying all K tangents: on the standard
    route one per site; on the fused route the final site's tangent call is
    replaced by ONE contraction epilogue (and, at a mamba2 site, the final
    layer's out_proj is reversed in the post-head instead)."""
    if variant == "zamba2_pattern":
        cfg = _zamba2_pattern_cfg()
        gen = torch.Generator().manual_seed(0)
        base = treg.get_model(cfg).init_base(cfg, gen)
        peft = init_peft(cfg, gen, tcfgs.SpryConfig())
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, (1,)))}
    else:
        s = request.getfixturevalue(variant)
        cfg, base, peft = s["tc"], s["tbase"], s["tpeft"]
        _, batch = _first(s)
    calls = _count_calls(monkeypatch)
    split = treg.get_loss_fn("cls", split=True)(cfg, base, batch)
    K = 3
    tfg.forward_gradient(split, peft, 5, K, fused_contraction=fused)
    want = _chip_smoke().round_launches(cfg, "fused" if fused else "standard", 1)
    assert {k: len(v) for k, v in calls.items()} == want
    for name, (_, t_arg) in _ENTRIES.items():
        assert calls[name] == [K if t_arg is not None else 1] * want[name], name
    if variant == "zamba2_pattern":
        assert want == ({"lora_dual_mt": 87, "swa_attention": 6, "swa_attention_mt": 6,
                         "mamba2_scan": 38, "mamba2_scan_mt": 37,
                         "mamba2_scan_mt_jvps": 1, "swa_attention_mt_jvps": 0,
                         "lora_dual_mt_jvps": 0, "lora_dual_multi": 0,
                         "wkv6_scan": 0, "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}
                        if fused else
                        {"lora_dual_mt": 88, "swa_attention": 6, "swa_attention_mt": 6,
                         "mamba2_scan": 38, "mamba2_scan_mt": 38,
                         "mamba2_scan_mt_jvps": 0, "swa_attention_mt_jvps": 0,
                         "lora_dual_mt_jvps": 0, "lora_dual_multi": 0,
                         "wkv6_scan": 0, "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0})
