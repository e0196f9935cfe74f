"""The port's fused-contraction route against the JAX package.

Weights are the reference's own (``init_base`` / ``init_peft`` with the
LoRA B factors made non-zero), carried over with ``repro_torch.convert``;
other inputs are made with numpy from a seed, and the reference's own
perturbations are injected into the port. JAX runs on the CPU (its 'jnp'
dispatch backend, where the contraction is the materialize-and-contract
mirror). Tolerances are the reference's (tests/test_split_forward.py):

- the split pieces ``split_forward`` / ``split_post`` against the
  reference's at fp32 rel 1e-5; inside the port a ``SplitLoss`` equals the
  plain loss bitwise (the same ops run);
- the fused estimate against the reference's fused estimate on all four
  routes (K=1, tangent_batch=1, batched, chunked): loss, jvps and gradient
  at rel 1e-5, as the port's other estimator tests. The reference's
  estimate is computed once per problem with K=5 perturbations and shared
  by the routes (``shared_reference``: perturbation i does not depend on
  K, so a K-case compares with its first K jvps and their combine);
- inside the port, fused against standard: loss bitwise, jvps within 5e-6
  of the jvps' scale (max |jvp| of the same perturbations at K=4: a single
  jvp can be a near-cancelling sum, so its own size is no scale), gradient
  rtol 1e-4 / atol 2e-5;
- launches, counted on the plain versions' entry points: one contraction-
  epilogue call per estimate for all K tangents and L-1 multi-tangent
  attention calls (the reference proves this on a jaxpr; here the calls
  are counted);
- with LoRA on ``wo`` and the MLP, the post-head's reversal runs through
  ``lora_proj``'s plain backward (never a kernel), fused == standard;
- one ``spry`` and one ``spry_periter`` round on the fused route against
  the reference's (loss, jvps rel 1e-5; PEFT update rel 1e-4).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import assignment as jassign
from repro.core import forward_grad as jfg
from repro.core import spry as jspry
from repro.kernels import dispatch as jdispatch
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
from repro_torch.models import transformer as ttf
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
M = 2
ROUTES = [(1, None), (3, 1), (4, None), (5, 2)]
ROUTE_IDS = ["k1", "sequential", "batched", "chunked"]
K_MAX = max(K for K, _ in ROUTES)
_ref_perturbations = jax.jit(jfg.stacked_perturbations)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _model(arch):
    jc = jcfgs.reduce_config(jcfgs.get_config(arch))
    tc = tcfgs.reduce_config(tcfgs.get_config(arch))
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


@pytest.fixture(scope="module")
def roberta():
    return _model("roberta-large-lora")


@pytest.fixture(scope="module")
def llama():
    return _model("llama2-7b")


def _first(s):
    return (jax.tree.map(lambda x: x[0], s["jbatch"]),
            {k: v[0] for k, v in s["tbatch"].items()})


# ---------------------------------------------------------------------------
# the split model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["roberta", "llama"])
def test_split_pieces_match_reference(arch, request):
    s = request.getfixturevalue(arch)
    jb, tb = _first(s)

    @jax.jit
    def ref(p):
        args, ctx = jtf.split_forward(s["jc"], s["jbase"], p, jb["tokens"])
        y = jtf.mixer_site(s["jc"], args)
        return (args, ctx, y) + tuple(jtf.split_post(s["jc"], s["jbase"], y, ctx, p))
    jargs, jctx, y, jh, jaux = ref(s["jpeft"])
    targs, tctx = ttf.split_forward(s["tc"], s["tbase"], s["tpeft"], tb["tokens"])
    for t, j in zip(targs, jargs):
        assert tuple(t.shape) == j.shape
        assert _rel(t, j) <= 1e-5
    assert _rel(tctx["h"], jctx["h"]) <= 1e-5
    th, taux = ttf.split_post(s["tc"], s["tbase"], torch.from_numpy(np.array(y)),
                              tctx, s["tpeft"])
    assert _rel(th, jh) <= 1e-5
    assert float(taux) == float(jaux) == 0.0
    assert ttf.split_site(s["tc"]) == jtf.split_site(s["jc"])


@pytest.mark.parametrize("arch", ["roberta", "llama"])
@pytest.mark.parametrize("task", ["cls", "lm"])
def test_split_loss_bitwise_equals_plain(arch, task, request):
    """Inside the port the SplitLoss runs the plain loss's ops: bitwise
    equal, in and out of the forward-AD region (the region switches the
    attention to the kernels' dispatch, on both alike)."""
    s = request.getfixturevalue(arch)
    _, tb = _first(s)
    split = treg.get_loss_fn(task, split=True)(s["tc"], s["tbase"], tb)
    assert isinstance(split, tfg.SplitLoss)
    plain = treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb)
    assert torch.equal(split(s["tpeft"]), plain)
    with dispatch.forward_ad_region():
        assert torch.equal(split(s["tpeft"]),
                           treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb))


# ---------------------------------------------------------------------------
# the fused estimator, kind 'swa' (the full model)
# ---------------------------------------------------------------------------

def _masks(s, client=1, n=3):
    ji = jassign.enumerate_units(s["jpeft"])
    jm = jassign.assignment_matrix(ji.n_units, n, 1)
    tm = tassign.assignment_matrix(ji.n_units, n, 1)
    return (jassign.build_mask_tree(s["jpeft"], ji, jm[client]),
            tassign.build_mask_tree(s["tpeft"], tassign.enumerate_units(s["tpeft"]),
                                    tm[client]))


def shared_reference(jloss, jpeft, jmask=None, fused=False, k=K_MAX):
    """The reference's estimate with ``k`` perturbations (its batched route),
    computed once and shared by the route cases that compare with it:
    perturbation i is fold_in(key, i) whatever K, so a K-perturbation case's
    reference jvps are the first K of these, its loss the same primal, and
    its gradient the reference's ``_combine`` of those jvps with the first K
    masked perturbations. ``vs`` are the perturbations for the port."""
    key = jax.random.PRNGKey(7)
    loss, _, jvps = jax.jit(lambda p: jfg.forward_gradient(
        jloss, p, key, k, mask_tree=jmask, fused_contraction=fused))(jpeft)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    vs = _ref_perturbations(key, peft32, jnp.arange(k))
    masked = vs if jmask is None else jax.tree.map(lambda v, m: v * m, vs, jmask)
    return {"loss": loss, "jvps": jvps, "masked": masked, "vs": _to_t(vs)}


def reference_rounds(steps, states, batch):
    """The reference's round steps ``steps`` ({name: round_step}), each from
    its state in ``states`` ({name: state}) on one batch, in ONE jit: the
    rounds of the methods a module compares with are compiled together, and
    what they share (the clients' estimates) compiles and runs once.
    Returns {name: (state, metrics)}."""
    return jax.jit(lambda sts, b: {k: f(sts[k], b) for k, f in steps.items()})(
        states, batch)


def reference_at(ref, K):
    """(loss, gradient, jvps) of the reference's K-perturbation estimate."""
    jvps = ref["jvps"][:K]
    return (ref["loss"], jfg._combine(jvps, jax.tree.map(lambda v: v[:K], ref["masked"]),
                                      K), jvps)


def _check_fused(ref, tsplit, tplain, tpeft, K, tb, tmask=None):
    """Port fused vs reference fused (``ref``: a ``shared_reference`` of
    the reference's split loss on the fused route), and port fused vs port
    standard."""
    jloss, jg, jjvps = reference_at(ref, K)
    kw = dict(mask_tree=tmask, perturbations=tree_map(lambda v: v[:max(K, 4)], ref["vs"]))
    tloss, tg, tjvps = tfg.forward_gradient(tsplit, tpeft, 0, K, tangent_batch=tb,
                                            fused_contraction=True, **kw)
    assert tjvps.shape == (K,)
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-5
    sloss, sg, sjvps = tfg.forward_gradient(tplain, tpeft, 0, K, tangent_batch=tb, **kw)
    primal = tfg.forward_gradient(tplain, tpeft, 0, 4, **kw)
    assert torch.equal(tloss, primal[0])           # the one primal, bitwise
    scale = float(primal[2].abs().max())
    assert float((tjvps - sjvps).abs().max()) <= 5e-6 * scale
    for a, b in zip(tree_leaves(tg), tree_leaves(sg)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def roberta_fused_ref(roberta):
    s = roberta
    jb, _ = _first(s)
    return shared_reference(jreg.get_loss_fn("cls", split=True)(s["jc"], s["jbase"], jb),
                            s["jpeft"], _masks(s)[0], fused=True)


@pytest.mark.parametrize("K,tb", ROUTES, ids=ROUTE_IDS)
def test_fused_swa_site_matches_reference(roberta, roberta_fused_ref, K, tb):
    s = roberta
    _, tb_ = _first(s)
    _check_fused(roberta_fused_ref,
                 treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], tb_),
                 lambda p: treg.cls_loss(s["tc"], s["tbase"], p, tb_),
                 s["tpeft"], K, tb, _masks(s)[1])


def test_fused_swa_site_llama_lm_matches_reference(llama):
    """GQA (KV < H), RoPE, SwiGLU and the LM head on the batched route."""
    s = llama
    jb, tb_ = _first(s)
    ref = shared_reference(jreg.get_loss_fn("lm", split=True)(s["jc"], s["jbase"], jb),
                           s["jpeft"], fused=True, k=4)
    _check_fused(ref, treg.get_loss_fn("lm", split=True)(s["tc"], s["tbase"], tb_),
                 lambda p: treg.lm_loss(s["tc"], s["tbase"], p, tb_),
                 s["tpeft"], 4, None)


# ---------------------------------------------------------------------------
# the fused estimator, kind 'lora' (single-projection estimators)
# ---------------------------------------------------------------------------

def _lora_problem(x_has_tangent):
    """A LoRA site whose input is data (x_has_tangent=False) or the output
    of an upstream LoRA projection (True), both packages on the same
    numbers (as tests/test_jvps_epilogue.py builds them)."""
    rng = np.random.default_rng(3)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    D = 32
    x0, w0, w1 = f(64, D) * 0.3, f(D, D) * 0.05, f(D, D) * 0.05
    peft = {"A1": f(D, 2) * 0.05, "B1": f(2, D) * 0.05}
    if x_has_tangent:
        peft.update({"A0": f(D, 2) * 0.05, "B0": f(2, D) * 0.05})

    def make(lib, proj, split_cls, conv):
        xj, w0j, w1j = conv(x0), conv(w0), conv(w1)

        def pre(p):
            x = proj(xj, w0j, p["A0"], p["B0"], 2.0) if x_has_tangent else xj
            return (x, w1j, p["A1"], p["B1"]), None
        post = lambda y, ctx, p: lib.mean(y * y)  # noqa: E731
        return split_cls(pre, "lora", post, scale=2.0, x_has_tangent=x_has_tangent)

    jsplit = make(jnp, jdispatch.lora_proj, jfg.SplitLoss, jnp.asarray)
    tsplit = make(torch, dispatch.lora_proj, tfg.SplitLoss, torch.from_numpy)
    return (jsplit, jax.tree.map(jnp.asarray, peft), tsplit,
            {k: torch.from_numpy(v) for k, v in peft.items()})


@pytest.fixture(scope="module")
def lora_fused_refs():
    """x_has_tangent -> (the reference's shared estimate, port split, port
    peft), built at first use."""
    cache = {}

    def get(x_has_tangent):
        if x_has_tangent not in cache:
            jsplit, jpeft, tsplit, tpeft = _lora_problem(x_has_tangent)
            cache[x_has_tangent] = (shared_reference(jsplit, jpeft, fused=True),
                                    tsplit, tpeft)
        return cache[x_has_tangent]
    return get


@pytest.mark.parametrize("x_has_tangent", [False, True], ids=["no_xdot", "xdot"])
@pytest.mark.parametrize("K,tb", ROUTES, ids=ROUTE_IDS)
def test_fused_lora_site_matches_reference(lora_fused_refs, x_has_tangent, K, tb):
    ref, tsplit, tpeft = lora_fused_refs(x_has_tangent)
    _check_fused(ref, tsplit, tsplit, tpeft, K, tb)


def test_fused_route_reverses_lora_projections_in_the_post_head(monkeypatch):
    """With LoRA on ``wo`` and the MLP, the post-head's reversal runs
    through ``lora_proj``'s plain backward (three times: the last layer's
    wo, wi, wd) and the fused estimate still equals the standard one."""
    cfg = dataclasses.replace(tcfgs.reduce_config(tcfgs.get_config("llama2-7b")),
                              n_classes=2)
    sc = tcfgs.SpryConfig(lora_targets=("wq", "wv", "wo", "wi", "wd"))
    g = torch.Generator()
    g.manual_seed(0)
    base = treg.get_model(cfg).init_base(cfg, g)
    peft = init_peft(cfg, g, sc)
    for t in sc.lora_targets:
        peft["layers"][t]["B"] = 0.2 * torch.randn(peft["layers"][t]["B"].shape,
                                                   generator=g)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))),
             "labels": torch.from_numpy(rng.integers(0, 2, (2,)))}
    calls = []
    real = dispatch._LoraProj.backward

    def counting(ctx, gy):
        calls.append(gy.shape)
        return real(ctx, gy)
    monkeypatch.setattr(dispatch._LoraProj, "backward", staticmethod(counting))
    split = treg.get_loss_fn("cls", split=True)(cfg, base, batch)
    l0, g0, j0 = tfg.forward_gradient(lambda p: split(p), peft, 3, 4)
    assert not calls
    l1, g1, j1 = tfg.forward_gradient(split, peft, 3, 4, fused_contraction=True)
    assert len(calls) == 3
    assert torch.equal(l0, l1)
    assert float((j1 - j0).abs().max()) <= 5e-6 * float(j0.abs().max())
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=2e-5)


def test_unported_site_kinds_raise():
    # every site kind of the reference is ported: the hybrid family's
    # (tests/test_torch_hybrid.py) and the ssm family's (tests/test_torch_rwkv.py)
    for kind in ("mamba2", "wkv6"):
        assert tfg.SplitLoss(lambda p: ((), None), kind, lambda y, c, p: y).kind == kind
    with pytest.raises(ValueError, match="unknown site kind"):
        tfg.SplitLoss(lambda p: ((), None), "conv", lambda y, c, p: y)


# ---------------------------------------------------------------------------
# launches: one contraction epilogue per estimate for all K tangents
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,tb", ROUTES, ids=ROUTE_IDS)
def test_fused_route_calls_one_epilogue_per_estimate(roberta, monkeypatch, K, tb):
    """Per estimate (one primal): 2L LoRA multi-tangent calls, L primal
    attention calls, L-1 multi-tangent attention calls and ONE attention
    contraction epilogue, each carrying all the estimate's tangents."""
    s = roberta
    _, tb_ = _first(s)
    calls = {"lora": [], "swa": [], "swa_mt": [], "swa_jvps": [], "lora_jvps": []}

    def counting(name, fn, t_arg):
        def f(*a, **k):
            calls[name].append(a[t_arg].shape[0] if t_arg is not None else 1)
            return fn(*a, **k)
        return f
    for name, attr, t_arg in (("lora", "lora_dual_mt_tangents", 4),
                              ("swa", "swa_attention", None),
                              ("swa_mt", "swa_attention_mt_tangents", 3),
                              ("swa_jvps", "swa_attention_mt_jvps", 3),
                              ("lora_jvps", "lora_dual_mt_jvps", 3)):
        monkeypatch.setattr(dispatch, attr, counting(name, getattr(dispatch, attr), t_arg))
    split = treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], tb_)
    tfg.forward_gradient(split, s["tpeft"], 5, K, tangent_batch=tb,
                         fused_contraction=True)
    L = s["tc"].n_layers
    group = K if tb is None else tb
    n = -(-K // group)                       # estimates' primal passes
    assert calls == {"lora": [group] * (2 * L * n), "swa": [1] * (L * n),
                     "swa_mt": [group] * ((L - 1) * n), "swa_jvps": [group] * n,
                     "lora_jvps": []}


def test_unsplit_loss_warns_once_and_takes_the_standard_route(roberta):
    s = roberta
    _, tb_ = _first(s)
    tfg._warned_unsplit_losses.clear()

    def plain(p):
        return treg.cls_loss(s["tc"], s["tbase"], p, tb_)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = tfg.forward_gradient(plain, s["tpeft"], 5, 2, fused_contraction=True)
    msgs = [str(w.message) for w in rec if issubclass(w.category, UserWarning)]
    assert len(msgs) == 1 and "'plain'" in msgs[0] and "standard" in msgs[0]
    want = tfg.forward_gradient(plain, s["tpeft"], 5, 2)
    assert torch.equal(out[2], want[2])
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        tfg.forward_gradient(plain, s["tpeft"], 5, 2, fused_contraction=True)
    assert not [w for w in rec2 if issubclass(w.category, UserWarning)]


# ---------------------------------------------------------------------------
# rounds on the fused route
# ---------------------------------------------------------------------------

def _reference_perturbations(s, sc, iters):
    rk = jax.random.fold_in(jax.random.PRNGKey(sc.seed), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), s["jpeft"])
    return [[_to_t(_ref_perturbations(
        jax.random.fold_in(jax.random.fold_in(rk, m), it), peft32,
        jnp.arange(sc.k_perturbations))) for it in range(iters)] for m in range(M)]


_FUSED_ROUND_KW = dict(n_clients_per_round=M, k_perturbations=4, local_lr=5e-3,
                      server_lr=1e-2, seed=3, fused_contraction=True)


@pytest.fixture(scope="module")
def roberta_fused_rounds(roberta):
    """The reference's fused ``spry`` and ``spry_periter`` rounds, in one
    jit (``reference_rounds``)."""
    s, jsc = roberta, jcfgs.SpryConfig(**_FUSED_ROUND_KW)
    return reference_rounds(
        {"spry": jspry.make_round_step(s["jc"], jsc),
         "spry_periter": jspry.make_round_step_per_iteration(s["jc"], jsc)},
        dict.fromkeys(("spry", "spry_periter"), jspry.init_state(s["jbase"], s["jpeft"])),
        s["jbatch"])


@pytest.mark.parametrize("method", ["spry", "spry_periter"])
def test_fused_round_matches_reference(roberta, roberta_fused_rounds, method):
    s = roberta
    jsc, tsc = jcfgs.SpryConfig(**_FUSED_ROUND_KW), tcfgs.SpryConfig(**_FUSED_ROUND_KW)
    make_t = (tspry.make_round_step if method == "spry"
              else tspry.make_round_step_per_iteration)
    jstate, jmet = roberta_fused_rounds[method]
    tstate, tmet = make_t(s["tc"], tsc)(tspry.init_state(s["tbase"], s["tpeft"]),
                                        s["tbatch"], _reference_perturbations(s, jsc, 1))
    assert tspry.estimator_route(tsc) == jspry.estimator_route(jsc) == "fused"
    assert float(tmet["fused_route"]) == float(jmet["fused_route"]) == 1.0
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(jstate.peft),
                                 tree_leaves(tstate.peft),
                                 jax.tree.leaves(s["jpeft"])):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(old, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(old, np.float64)
        assert _rel(t_delta, j_delta) <= 1e-4
