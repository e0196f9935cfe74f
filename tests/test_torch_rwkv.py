"""The port's ssm family (rwkv6) against the JAX package.

Reduced rwkv6 (``reduce_config``: 2 layers, d=256, 8 WKV heads of hd=32).
Weights are the reference's own (``init_base`` / ``init_peft`` with every
LoRA B factor made non-zero), carried over with ``repro_torch.convert``;
tokens, labels and kernel operands are made with numpy from a seed, and the
reference's own perturbations are injected into the port. JAX runs on the
CPU (its 'jnp' dispatch backend: the plain recurrence). Tolerances:

- configs, the PEFT tree, LoRA targets and trainable units equal the
  reference's exactly;
- every rwkv6 function of ``models/ssm.py``, hidden states, the cls and lm
  losses and the split pieces at fp32 rel 1e-5; inside the port the split
  composition equals ``forward`` and the split loss the plain loss bitwise;
- the three kernel mirrors against ``repro/kernels/wkv6_scan/ref.py``: y
  and ydots at rel 1e-5, the contraction at 1e-6 x sum|terms| (odd S, T in
  {1, 3}, with and without a tangent of u);
- the fused route (the 'wkv6' site's contraction) against
  ``wkv6_scan_mt_jvps_ref`` at 1e-6 x sum|terms| and against the port's
  standard route at the reference's route tolerances (loss bitwise, jvps
  5e-6 of their scale, gradients rtol 1e-4). Not against the reference's
  own fused route, whose ssm case is red on jax 0.9
  (``tests/test_split_forward.py``);
- one ``spry`` and one ``spry_periter`` round on the standard route: loss
  and jvps rel 1e-5, PEFT updates rel 1e-4 (as tests/test_torch_spry.py);
- launches per estimate, counted on the plain versions' entry points, on
  both routes for the reduced config and for full rwkv6's depth (24 layers)
  at reduced width; they equal what ``chip_smoke.round_launches`` holds the
  card to;
- the train CLI with ``--arch rwkv6-1.6b --device cpu``, its ``--out``
  history holding the reference's history keys.
"""
import dataclasses
import importlib.util
import json
import math
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
from repro.kernels.wkv6_scan import ref as jwref
from repro.models import registry as jreg
from repro.models import rwkv_model as jrwkv
from repro.models import ssm as jssm
from repro.peft import init_peft as jinit_peft
from repro.peft.lora import default_lora_targets as jdefault_targets
from repro.peft.lora import target_dims as jtarget_dims
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.core import forward_grad as tfg
from repro_torch.core import spry as tspry
from repro_torch.kernels import dispatch
from repro_torch.kernels.wkv6_scan import ops as wops
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.models import rwkv_model as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.common import layer_slice
from repro_torch.peft import init_peft
from repro_torch.peft.lora import default_lora_targets as tdefault_targets
from repro_torch.peft.lora import target_dims as ttarget_dims
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from port_reference import unoptimized_reference  # noqa: F401 (autouse)
from test_torch_fused import reference_rounds

torch.set_num_threads(1)
M = 2
ARCH = "rwkv6-1.6b"
_ref_perturbations = jax.jit(jfg.stacked_perturbations)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    jc = jcfgs.reduce_config(jcfgs.get_config(ARCH))
    tc = tcfgs.reduce_config(tcfgs.get_config(ARCH))
    jbase = jax.jit(jrwkv.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1),
                                                        jcfgs.SpryConfig())
    for t, k in zip(("wr", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
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


def _first(s):
    return (jax.tree.map(lambda x: x[0], s["jbatch"]),
            {k: v[0] for k, v in s["tbatch"].items()})


# ---------------------------------------------------------------------------
# configs, PEFT tree, trainable units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_config_fields_equal_reference(variant):
    jc, tc = jcfgs.get_config(ARCH), tcfgs.get_config(ARCH)
    if variant == "reduced":
        jc, tc = jcfgs.reduce_config(jc), tcfgs.reduce_config(tc)
    for f in dataclasses.fields(tc):
        t, j = getattr(tc, f.name), getattr(jc, f.name)
        if f.name == "ssm":
            t, j = dataclasses.asdict(t), dataclasses.asdict(j)
        assert t == j, f.name
    assert tc.family == "ssm" and trwkv.split_site(tc) == jrwkv.split_site(jc)


def test_peft_tree_and_units_equal_reference(setup):
    s = setup
    jc, tc = s["jc"], s["tc"]
    assert tdefault_targets(tc) == jdefault_targets(jc) == ("wr", "wv")
    # the reference's table: wr and the ssm rule for wk/wv/wo are (d, d); wg
    # keeps the dense family's (d, d_ff) entry there (see ROADMAP)
    for t in ("wr", "wk", "wv", "wo", "wg"):
        assert ttarget_dims(tc, t) == jtarget_dims(jc, t)
    gen = torch.Generator().manual_seed(0)
    own = init_peft(tc, gen, tcfgs.SpryConfig())
    want = [(p, tuple(leaf.shape)) for p, leaf in tree_paths(
        jax.tree.map(np.asarray, s["jpeft"]))]
    assert [(p, tuple(leaf.shape)) for p, leaf in tree_paths(own)] == want
    ti, ji = tassign.enumerate_units(s["tpeft"]), jassign.enumerate_units(s["jpeft"])
    assert ti.units == ji.units and ti.spans == ji.spans
    tm = tassign.assignment_matrix(ti.n_units, 3, 1)
    jm = jassign.assignment_matrix(ji.n_units, 3, 1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the base tree carries across with its paths, shapes and dtypes
    jb = [(p, tuple(x.shape), str(x.dtype)) for p, x in
          tree_paths(jax.tree.map(np.asarray, s["jbase"]))]
    own_base = trwkv.init_base(tc, gen)
    assert [(p, tuple(x.shape)) for p, x in tree_paths(own_base)] == \
        [(p, sh) for p, sh, _ in jb]
    assert [str(x.dtype).replace("torch.", "") for _, x in tree_paths(s["tbase"])] == \
        [d for _, _, d in jb]


# ---------------------------------------------------------------------------
# the rwkv6 functions of models/ssm.py
# ---------------------------------------------------------------------------

def _layer0(s):
    jp = jax.tree.map(lambda t: t[0], s["jbase"]["layers"]["mix"])
    jpl = jax.tree.map(lambda t: t[0], s["jpeft"]["layers"])
    return (jp, jpl, layer_slice(s["tbase"]["layers"]["mix"], 0),
            layer_slice(s["tpeft"]["layers"], 0))


@pytest.mark.parametrize("fn", ["token_shift", "recurrence", "site_args", "finish",
                                "mixer_site", "time_mix", "channel_mix"])
def test_ssm_functions_match_reference(setup, fn):
    s = setup
    jc, tc = s["jc"], s["tc"]
    jp, jpl, tp, tpl = _layer0(s)
    B, S, D = 2, 9, jc.d_model
    H, hd = D // jc.ssm.head_dim, jc.ssm.head_dim
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    prev = rng.standard_normal((B, 1, D)).astype(np.float32)
    state = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jprev, tprev = jnp.asarray(prev), torch.from_numpy(prev)
    if fn == "token_shift":
        pairs = [(tssm._token_shift(tx, tprev), jssm._token_shift(jx, jprev))]
    elif fn in ("recurrence", "mixer_site"):
        (r, k, v, w, u), _ = jssm.rwkv6_site_args(jc, jp, jx, jpl)
        targs = tuple(torch.from_numpy(np.array(a)) for a in (r, k, v, w, u))
        if fn == "recurrence":
            jy, jst = jssm.wkv6_recurrence(r, k, v, w, u, jnp.asarray(state))
            ty, tst = tssm.wkv6_recurrence(*targs, torch.from_numpy(state))
            pairs = [(ty, jy), (tst, jst)]
        else:
            want = jssm.wkv6_mixer_site((r, k, v, w, u))
            with dispatch.forward_ad_region():          # the dispatched op
                inside = tssm.wkv6_mixer_site(targs)
            outside = tssm.wkv6_mixer_site(targs)
            assert torch.equal(inside, outside)
            pairs = [(outside, want)]
    elif fn == "site_args":
        jargs, jg = jssm.rwkv6_site_args(jc, jp, jx, jpl, shift_prev=jprev)
        targs, tg = tssm.rwkv6_site_args(tc, tp, tx, tpl, shift_prev=tprev)
        pairs = list(zip(targs, jargs)) + [(tg, jg)]
    elif fn == "finish":
        y = rng.standard_normal((B, S, H, hd)).astype(np.float32)
        g = rng.standard_normal((B, S, D)).astype(np.float32)
        pairs = [(tssm.rwkv6_finish(tc, tp, torch.from_numpy(y), torch.from_numpy(g),
                                    torch.float32, tpl),
                  jssm.rwkv6_finish(jc, jp, jnp.asarray(y), jnp.asarray(g),
                                    jnp.float32, jpl))]
    elif fn == "time_mix":
        jo, _, jl = jssm.rwkv6_time_mix(jc, jp, jx, jpl)
        to, tst, tl = tssm.rwkv6_time_mix(tc, tp, tx, tpl)
        jo2, jst2, _ = jssm.rwkv6_time_mix(jc, jp, jx, jpl, state=jnp.asarray(state),
                                           shift_prev=jprev)
        to2, tst2, _ = tssm.rwkv6_time_mix(tc, tp, tx, tpl,
                                           state=torch.from_numpy(state),
                                           shift_prev=tprev)
        pairs = [(to, jo), (tl, jl), (to2, jo2), (tst2, jst2)]
    else:
        jo, jl = jssm.rwkv6_channel_mix(jc, jp, jx)
        to, tl = tssm.rwkv6_channel_mix(tc, tp, tx)
        jo2, _ = jssm.rwkv6_channel_mix(jc, jp, jx, shift_prev=jprev)
        to2, _ = tssm.rwkv6_channel_mix(tc, tp, tx, shift_prev=tprev)
        pairs = [(to, jo), (tl, jl), (to2, jo2)]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got, want) <= 1e-5, fn


# ---------------------------------------------------------------------------
# the model and its split pieces
# ---------------------------------------------------------------------------

_LOSSES = ("cls_loss", "lm_loss", "cls_logits")


@pytest.fixture(scope="module")
def reference_forward(setup):
    """The reference's forward, losses and split pieces on the first
    client's batch, in one jit: hidden states, the three losses, the site
    operands, the post-head's context, the site output and the post-head's
    hidden states."""
    s = setup
    jb, _ = _first(s)

    @jax.jit
    def ref(p):
        args, ctx = jrwkv.split_forward(s["jc"], s["jbase"], p, jb["tokens"])
        y = jrwkv.mixer_site(s["jc"], args)
        return dict(h=jrwkv.forward(s["jc"], s["jbase"], p, jb["tokens"])[0],
                    losses=[getattr(jreg, n)(s["jc"], s["jbase"], p, jb) for n in _LOSSES],
                    args=args, ctx=ctx, y=y,
                    post_h=jrwkv.split_post(s["jc"], s["jbase"], y, ctx, p)[0])
    return ref(s["jpeft"])


def test_hidden_states_and_losses_match_reference(setup, reference_forward):
    s, ref = setup, reference_forward
    _, tb = _first(s)
    th, taux = trwkv.forward(s["tc"], s["tbase"], s["tpeft"], tb["tokens"])
    assert _rel(th, ref["h"]) <= 1e-5 and float(taux) == 0.0
    for name, want in zip(_LOSSES, ref["losses"]):
        got = getattr(treg, name)(s["tc"], s["tbase"], s["tpeft"], tb)
        assert _rel(got, want) <= 1e-5, name


def test_split_pieces_match_reference_and_compose_bitwise(setup, reference_forward):
    """split_forward / split_post against the reference's at rel 1e-5; in
    the port the composition is ``forward`` and the split loss the plain
    loss, bit for bit, outside and inside the forward-AD region."""
    s, ref = setup, reference_forward
    _, tb = _first(s)
    jargs, jctx, y, jh = ref["args"], ref["ctx"], ref["y"], ref["post_h"]
    targs, tctx = trwkv.split_forward(s["tc"], s["tbase"], s["tpeft"], tb["tokens"])
    for t, j in zip(targs, jargs):
        assert tuple(t.shape) == j.shape and _rel(t, j) <= 1e-5
    assert sorted(tctx) == sorted(jctx)
    for k in tctx:
        assert _rel(tctx[k], jctx[k]) <= 1e-5
    th, _ = trwkv.split_post(s["tc"], s["tbase"], torch.from_numpy(np.array(y)),
                             tctx, s["tpeft"])
    assert _rel(th, jh) <= 1e-5
    composed = trwkv.split_post(s["tc"], s["tbase"], trwkv.mixer_site(s["tc"], targs),
                                tctx, s["tpeft"])[0]
    assert torch.equal(composed, trwkv.forward(s["tc"], s["tbase"], s["tpeft"],
                                               tb["tokens"])[0])
    for task in ("cls", "lm"):
        split = treg.get_loss_fn(task, split=True)(s["tc"], s["tbase"], tb)
        assert split.kind == "wkv6"
        plain = treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb)
        assert torch.equal(split(s["tpeft"]), plain)
        with dispatch.forward_ad_region():
            inside = treg.get_loss_fn(task)(s["tc"], s["tbase"], s["tpeft"], tb)
            assert torch.equal(split(s["tpeft"]), inside)
        assert torch.equal(inside, plain)


# ---------------------------------------------------------------------------
# the kernel mirrors against the reference's oracles
# ---------------------------------------------------------------------------

def _wkv6_operands(B, S, H, hd, T, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=0.5):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    prim = (rn(B, S, H, hd), rn(B, S, H, hd), rn(B, S, H, hd),
            np.exp(-np.exp(0.5 + rn(B, S, H, hd))).astype(np.float32),
            rn(H, hd, scale=0.3))
    tang = tuple(rn(T, B, S, H, hd, scale=0.3) for _ in range(3)) + (
        rn(T, B, S, H, hd, scale=0.05),)
    return prim, tang, rn(T, H, hd, scale=0.3), rn(B, S, H, hd, scale=1.0)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module")
def oracle():
    """One problem at an odd S with T=3 tangents, and the reference
    oracles' outputs on it, with the tangent of u and with none (zeros, as
    ``ref.wkv6_scan_mt_ref`` takes a missing one): one compile of each
    oracle for all mirror cases. Lane t of a T=3 oracle is the T=1 oracle
    of tangent t (its lanes are independent jvps)."""
    prim, tang, uds, gy = _wkv6_operands(2, 7, 3, 8, 3, 13)
    mt = jax.jit(jwref.wkv6_scan_mt_ref)
    jvps = jax.jit(jwref.wkv6_scan_mt_jvps_ref)
    out = {"prim": prim, "tang": tang, "uds": uds, "gy": gy,
           "y": np.asarray(jax.jit(lambda *a: jwref.wkv6_scan_ref(*a)[0])(*prim))}
    for has_ud, u in ((False, np.zeros_like(uds)), (True, uds)):
        out["yd", has_ud] = np.asarray(mt(*prim, *tang, u)[1])
        out["jvps", has_ud] = np.asarray(jvps(*prim, *tang, gy, u))
    return out


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("T", [1, 3])
def test_kernel_mirrors_match_reference_oracles(oracle, T, has_ud):
    """The plain versions (and the wrappers, which take them on CPU
    tensors) against ``ref.wkv6_scan_ref``, ``wkv6_scan_mt_ref`` and
    ``wkv6_scan_mt_jvps_ref`` at an odd S: y and ydots at rel 1e-5, the
    contraction at 1e-6 x sum|terms|; without a tangent of u the port is
    given none."""
    o = oracle
    tp, gy = tuple(map(_t, o["prim"])), _t(o["gy"])
    tt = tuple(torch.from_numpy(x[:T]) for x in o["tang"])
    tud = torch.from_numpy(o["uds"][:T]) if has_ud else None
    jyd, jjv = o["yd", has_ud][:T], o["jvps", has_ud][:T]
    y_ref, yd_ref = wops.wkv6_scan_mt_ref(*tp, *tt, tud)
    assert _rel(y_ref, o["y"]) <= 1e-5 and _rel(yd_ref, jyd) <= 1e-5
    assert _rel(wops.wkv6_scan_ref(*tp)[0], o["y"]) <= 1e-5
    mag = np.abs(o["gy"][None].astype(np.float64) * jyd.astype(np.float64)).sum(
        axis=(1, 2, 3, 4))
    for got in (wops.wkv6_scan_mt_jvps_ref(*tp, *tt, gy, tud),
                wops.wkv6_scan_mt_jvps(*tp, *tt, gy, tud)):
        err = np.abs(got.numpy().astype(np.float64) - jjv.astype(np.float64))
        assert (err <= 1e-6 * mag).all(), (err, mag)
    # the wrappers on CPU tensors: the plain versions, after the reference's
    # fp32 casts (bf16 operands are read as fp32)
    assert torch.equal(wops.wkv6_scan(*tp), y_ref)
    assert torch.equal(wops.wkv6_scan_mt_tangents(*tp, *tt, tud), yd_ref)
    half = tuple(x.bfloat16() for x in tp)
    assert torch.equal(wops.wkv6_scan(*half),
                       wops.wkv6_scan_ref(*(x.float() for x in half))[0])


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("chunk", [4, 32])
def test_chunked_form_matches_reference_oracles(oracle, chunk, T, has_ud):
    """The chunked form the S <= 32 multi-tangent kernel computes
    (``wkv6_chunked_ref``: L and Ld by running products, A and Ad summed in
    fp64, the state carried from chunk to chunk) against
    ``ref.wkv6_scan_ref``, ``wkv6_scan_mt_ref`` and ``wkv6_scan_mt_jvps_ref``
    at S=7: y and ydots at rel 1e-5, the contraction of its ydots with gy at
    1e-6 x sum|terms|. chunk=4 splits S into a full and a ragged chunk."""
    o = oracle
    tp, gy = tuple(map(_t, o["prim"])), _t(o["gy"])
    tt = tuple(torch.from_numpy(x[:T]) for x in o["tang"])
    tud = torch.from_numpy(o["uds"][:T]) if has_ud else None
    jyd, jjv = o["yd", has_ud][:T], o["jvps", has_ud][:T]
    y, yd = wops.wkv6_chunked_ref(*tp, *tt, tud, chunk=chunk)
    assert y.shape == tp[0].shape and yd.shape == (T,) + tp[0].shape
    assert _rel(y, o["y"]) <= 1e-5 and _rel(yd, jyd) <= 1e-5
    assert _rel(wops.wkv6_chunked_ref(*tp, chunk=chunk), o["y"]) <= 1e-5
    mag = np.abs(o["gy"][None].astype(np.float64) * jyd.astype(np.float64)).sum(
        axis=(1, 2, 3, 4))
    got = torch.einsum("bshd,tbshd->t", gy.double(), yd.double()).numpy()
    err = np.abs(got - jjv.astype(np.float64))
    assert (err <= 1e-6 * mag).all(), (err, mag)


def test_chunked_form_stays_finite_where_the_decay_underflows(oracle):
    """w0 = 3 (w = exp(-exp(3 + z)), about 1e-9 a token) drives L to 0 in
    fp32 within a few tokens of the chunk. The chunked form divides by no
    product of decays, so y and ydots stay finite and agree with the
    reference's recurrence."""
    o = oracle
    r, k, v, w, u = o["prim"]
    w3 = np.exp(-np.exp(3.0 + np.log(-np.log(w.astype(np.float64))) - 0.5)
                ).astype(np.float32)
    prim = (r, k, v, w3, u)
    assert (np.prod(w3[:, 1:6], axis=1) == 0).any()       # L underflows
    jy, jyd = jax.jit(jwref.wkv6_scan_mt_ref)(*prim, *o["tang"], o["uds"])
    y, yd = wops.wkv6_chunked_ref(*map(_t, prim), *map(_t, o["tang"]),
                                  _t(o["uds"]))
    assert torch.isfinite(y).all() and torch.isfinite(yd).all()
    assert _rel(y, np.asarray(jy)) <= 1e-5 and _rel(yd, np.asarray(jyd)) <= 1e-5


@pytest.mark.parametrize("S,path", [(1, "chunk"), (29, "chunk"), (32, "chunk"),
                                    (33, "rec"), (1024, "rec")])
def test_tangent_route_rule(S, path):
    """The multi-tangent wrapper's route is the sequence length alone: the
    chunked kernel serves one chunk (S <= 32, every main-path launch), the
    recurrent kernel longer S."""
    assert wops.wkv6_mt_path(S) == path


def test_wrappers_raise_on_other_devices():
    prim = tuple(torch.zeros(s, device="meta") for s in
                 ((1, 2, 1, 4),) * 4 + ((1, 4),))
    tang = tuple(torch.zeros((1, 1, 2, 1, 4), device="meta") for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device"):
        wops.wkv6_scan(*prim)
    with pytest.raises(ValueError, match="unsupported device"):
        wops.wkv6_scan_mt_tangents(*prim, *tang)
    with pytest.raises(ValueError, match="unsupported device"):
        wops.wkv6_scan_mt_jvps(*prim, *tang, prim[0])


# ---------------------------------------------------------------------------
# the estimator on both routes
# ---------------------------------------------------------------------------

def test_fused_site_contraction_matches_oracle(setup):
    """The 'wkv6' site's contraction on the fused route, for K=3 stacked
    tangents of the split forward, against the reference's
    ``wkv6_scan_mt_jvps_ref`` on the same operands (1e-6 x sum|terms|); the
    frozen u's tangent is exact zeros and goes to the contraction, as on
    the fused route (``forward_grad._site_contract``)."""
    s = setup
    _, tb = _first(s)
    split = treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], tb)
    vs = tfg.stacked_perturbations(4, s["tpeft"], [0, 1, 2])

    def site_tangents(v):
        (args, _), (argdots, _) = torch.func.jvp(split.pre, (s["tpeft"],), (v,))
        return args, argdots
    with dispatch.forward_ad_region():
        args, argdots = torch.func.vmap(site_tangents, out_dims=(None, 0))(vs)
        y = split.site(args)
    ctx = split.pre(s["tpeft"])[1]
    _, post_vjp = torch.func.vjp(lambda y_: split.post(y_, ctx, s["tpeft"]), y)
    (gy,) = post_vjp(torch.ones(()))
    assert float(argdots[4].abs().max()) == 0.0           # u is frozen
    got = torch.func.vmap(
        lambda *tangents: dispatch.wkv6_jvp_contract(gy, *args, *tangents))(*argdots)
    np_ = lambda t: t.detach().numpy()                     # noqa: E731
    want, yd = jax.jit(lambda a, t, g: (jwref.wkv6_scan_mt_jvps_ref(*a, *t, g),
                                        jwref.wkv6_scan_mt_ref(*a, *t)[1]))(
        tuple(map(np_, args)), tuple(map(np_, argdots[:4])), np_(gy))
    mag = np.abs(np_(gy)[None].astype(np.float64) * np.asarray(yd, np.float64)).sum(
        axis=(1, 2, 3, 4))
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * mag).all(), (err, mag)


def test_fused_agrees_with_standard_inside_the_port(setup):
    """Loss bitwise, jvps within 5e-6 of their scale, gradients rtol 1e-4
    (the reference's route tolerances, tests/test_split_forward.py)."""
    s = setup
    _, tb = _first(s)
    for task in ("cls", "lm"):
        split = treg.get_loss_fn(task, split=True)(s["tc"], s["tbase"], tb)
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


_ROUND_KW = dict(n_clients_per_round=M, k_perturbations=4, local_lr=5e-3,
                 server_lr=1e-2, seed=3)


@pytest.fixture(scope="module")
def reference_rounds_of(setup):
    """The reference's ``spry`` and ``spry_periter`` rounds, in one jit
    (``test_torch_fused.reference_rounds``)."""
    s, jsc = setup, jcfgs.SpryConfig(**_ROUND_KW)
    return reference_rounds(
        {"spry": jspry.make_round_step(s["jc"], jsc),
         "spry_periter": jspry.make_round_step_per_iteration(s["jc"], jsc)},
        dict.fromkeys(("spry", "spry_periter"), jspry.init_state(s["jbase"], s["jpeft"])),
        s["jbatch"])


@pytest.mark.parametrize("method", ["spry", "spry_periter"])
def test_round_matches_reference(setup, reference_rounds_of, method):
    """One round on the standard route with the reference's perturbations:
    loss and mean |jvp| at rel 1e-5, each PEFT update at rel 1e-4."""
    s = setup
    jsc, tsc = jcfgs.SpryConfig(**_ROUND_KW), tcfgs.SpryConfig(**_ROUND_KW)
    tstep = (tspry.make_round_step(s["tc"], tsc) if method == "spry"
             else tspry.make_round_step_per_iteration(s["tc"], tsc))
    jstate, jmet = reference_rounds_of[method]
    tstate, tmet = tstep(tspry.init_state(s["tbase"], s["tpeft"]), s["tbatch"],
                         _reference_perturbations(s, jsc, 1))
    assert float(tmet["fused_route"]) == float(jmet["fused_route"]) == 0.0
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

_ENTRIES = {   # wkv6-path counter name -> (dispatch entry point, index of T)
    "lora_dual_mt": ("lora_dual_mt_tangents", 4),
    "lora_dual_mt_jvps": ("lora_dual_mt_jvps", 3),
    "wkv6_scan": ("wkv6_scan", None),
    "wkv6_scan_mt": ("wkv6_scan_mt_tangents", 5),
    "wkv6_scan_mt_jvps": ("wkv6_scan_mt_jvps", 5),
}


@pytest.fixture(scope="module")
def rwkv6_depth(setup):
    """Full rwkv6's 24 layers at reduced width: (cfg, base, peft, batch)."""
    cfg = dataclasses.replace(setup["tc"], n_layers=tcfgs.get_config(ARCH).n_layers)
    gen = torch.Generator().manual_seed(0)
    base = treg.get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, tcfgs.SpryConfig())
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4))),
             "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, (1,)))}
    return cfg, base, peft, batch


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("depth", ["reduced", "rwkv6_depth"])
def test_launches_per_estimate(setup, request, monkeypatch, depth, fused):
    """One estimate (K=3) makes exactly the launches chip_smoke.py holds the
    card to, each multi-tangent call carrying all K tangents: per layer one
    LoRA call for each of wr and wv, one primal and one multi-tangent wkv6
    call; on the fused route the final layer's multi-tangent call is ONE
    contraction epilogue, and its wr / wv calls stay (they come before the
    site)."""
    if depth == "rwkv6_depth":
        cfg, base, peft, batch = request.getfixturevalue("rwkv6_depth")
    else:
        cfg, base, peft = setup["tc"], setup["tbase"], setup["tpeft"]
        _, batch = _first(setup)
    calls = {k: [] for k in _ENTRIES}
    for name, (attr, t_arg) in _ENTRIES.items():
        def f(*a, _fn=getattr(dispatch, attr), _n=name, _t=t_arg, **k):
            calls[_n].append(a[_t].shape[0] if _t is not None else 1)
            return _fn(*a, **k)
        monkeypatch.setattr(dispatch, attr, f)
    split = treg.get_loss_fn("cls", split=True)(cfg, base, batch)
    K = 3
    loss, _, jvps = tfg.forward_gradient(split, peft, 5, K, fused_contraction=fused)
    assert math.isfinite(float(loss)) and torch.isfinite(jvps).all()
    want = _chip_smoke().round_launches(cfg, "fused" if fused else "standard", 1)
    assert {k: n for k, n in want.items() if n} == \
        {k: len(v) for k, v in calls.items() if v}
    for name, (_, t_arg) in _ENTRIES.items():
        assert calls[name] == [K if t_arg is not None else 1] * want[name], name
    L = cfg.n_layers
    assert want["lora_dual_mt"] == 2 * L and want["wkv6_scan"] == L
    assert (want["wkv6_scan_mt"], want["wkv6_scan_mt_jvps"]) == \
        ((L - 1, 1) if fused else (L, 0))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

# the keys of the reference's eval history (repro/launch/train.py, the
# in-process path's ``entry`` and the last entry's personalized_acc)
REFERENCE_HISTORY_KEYS = {"round", "acc", "loss", "t", "route"}


def test_cli_runs_on_cpu_and_writes_history(tmp_path, capsys):
    """``--arch rwkv6-1.6b --device cpu`` through the entry point (the fused
    route; the rounds above hold the standard one), ``--out`` writing the
    reference's history keys."""
    out = tmp_path / "history.json"
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--rounds", "1", "--clients", "2",
                 "--total-clients", "40", "--batch-size", "4", "--k", "2",
                 "--fused-contraction", "--out", str(out),
                 "--telemetry", str(tmp_path / "telemetry.jsonl")])
    assert "estimator route: fused" in capsys.readouterr().out
    hist = json.loads(out.read_text())
    assert len(hist) == 1 and REFERENCE_HISTORY_KEYS <= set(hist[-1])
    assert "personalized_acc" in hist[-1] and hist[-1]["route"] == "fused"
    assert math.isfinite(hist[-1]["loss"]) and 0.0 <= hist[-1]["acc"] <= 1.0
