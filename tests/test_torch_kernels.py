"""Port kernels' plain versions and dispatch rules against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU. The plain versions are held against the JAX oracles
(``lora_dual_mt_ref``, ``swa_attention_gqa_ref``, ``swa_attention_mt_ref``,
``lora_dual_mt_jvps_ref``, ``swa_attention_mt_jvps_ref``,
``mamba2_scan_ref``, ``mamba2_scan_mt_ref``, ``mamba2_scan_mt_jvps_ref``, and
the reference's ``lora_dual_mt_jvps(impl='reassoc')``) at fp32 rel 1e-5, as is
the chunked form the mamba2 kernels compute (``mamba2_chunked_ref``); the
plain versions of the scan epilogues' chunk route
(``mamba2_scan_mt_jvps_chunked_ref``, ``wkv6_scan_mt_jvps_chunked_ref``)
against the jvps oracles at 1e-6 x sum|terms|; and
one small case of each against the Pallas kernels in interpret mode, as
tests/test_kernels.py, tests/test_jvps_epilogue.py and
tests/test_mamba2_mt.py run them. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lora_dual.ops import lora_dual_mt_jvps as jax_lora_jvps
from repro.kernels.lora_dual.ops import lora_dual_mt_tangents as jax_lora_mt_pallas
from repro.kernels.lora_dual.ref import lora_dual_mt_jvps_ref, lora_dual_mt_ref
from repro.kernels.mamba2_scan.ops import mamba2_scan as jax_m2_pallas
from repro.kernels.mamba2_scan.ops import mamba2_scan_mt_jvps as jax_m2_jvps_pallas
from repro.kernels.mamba2_scan.ops import (
    mamba2_scan_mt_tangents as jax_m2_mt_pallas,
)
from repro.kernels.mamba2_scan.ref import (
    mamba2_scan_mt_jvps_ref as jax_m2_jvps_ref,
)
from repro.kernels.mamba2_scan.ref import mamba2_scan_mt_ref as jax_m2_mt_ref
from repro.kernels.mamba2_scan.ref import mamba2_scan_ref as jax_m2_ref
from repro.kernels.swa_attention.ops import swa_attention as jax_swa_pallas
from repro.kernels.swa_attention.ops import swa_attention_mt_jvps as jax_swa_jvps
from repro.kernels.swa_attention.ops import (
    swa_attention_mt_tangents as jax_swa_mt_pallas,
)
from repro.kernels.swa_attention.ref import (
    swa_attention_gqa_ref,
    swa_attention_mt_jvps_ref,
    swa_attention_mt_ref,
)
from repro.kernels.wkv6_scan import ref as jax_w6_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.lora_dual import ops as lora_ops
from repro_torch.kernels.mamba2_scan import ops as m2_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.wkv6_scan import ops as w6_ops

torch.set_num_threads(1)
RTOL = 1e-5

# the JAX oracles compiled once a shape (jax.jit) instead of dispatched op by
# op: the same functions, several seconds less a call on the CPU
lora_dual_mt_ref = jax.jit(lora_dual_mt_ref)
lora_dual_mt_jvps_ref = jax.jit(lora_dual_mt_jvps_ref)
swa_attention_gqa_ref = jax.jit(swa_attention_gqa_ref, static_argnames="window")
swa_attention_mt_ref = jax.jit(swa_attention_mt_ref, static_argnames="window")
swa_attention_mt_jvps_ref = jax.jit(swa_attention_mt_jvps_ref, static_argnames="window")
jax_m2_ref = jax.jit(jax_m2_ref)
jax_m2_mt_ref = jax.jit(jax_m2_mt_ref)
jax_m2_jvps_ref = jax.jit(jax_m2_jvps_ref)
jax_w6_mt_ref = jax.jit(jax_w6_ref.wkv6_scan_mt_ref)
jax_w6_mt_jvps_ref = jax.jit(jax_w6_ref.wkv6_scan_mt_jvps_ref)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _lora_inputs(seed, M, K, N, r, T, has_xd):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    s = np.float32(1.0 / np.sqrt(K))
    return dict(x=f(M, K), xdots=f(T, M, K) if has_xd else None,
                w=f(K, N) * s, a=f(K, r) * s,
                adots=f(T, K, r), b=f(r, N), bdots=f(T, r, N))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("M,K,N,r,T,has_xd", [
    (64, 256, 256, 1, 1, True),
    (64, 256, 256, 1, 4, False),
    (37, 100, 72, 2, 3, True),     # ragged widths
    (8, 64, 128, 4, 8, True),
])
def test_lora_mt_plain_matches_jax_ref(M, K, N, r, T, has_xd):
    d = _lora_inputs(0, M, K, N, r, T, has_xd)
    _, want = lora_dual_mt_ref(*(None if v is None else jnp.asarray(v)
                                 for v in d.values()), scale=0.5)
    got = lora_ops.lora_dual_mt_tangents(*(_t(v) for v in d.values()), 0.5)
    assert got.shape == (T, M, N)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("has_xd", [True, False])
def test_lora_mt_plain_matches_pallas_interpret(has_xd):
    d = _lora_inputs(1, 40, 96, 80, 1, 2, has_xd)
    want = jax_lora_mt_pallas(*(None if v is None else jnp.asarray(v)
                                for v in d.values()), scale=1.0, block_m=32,
                              block_n=32, block_k=32, interpret=True)
    got = lora_ops.lora_dual_mt_tangents(*(_t(v) for v in d.values()), 1.0)
    assert _rel(got, want) <= RTOL


def _swa_inputs(seed, B, H, KV, S, hd, T):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, S, hd), f(B, KV, S, hd), f(B, KV, S, hd),
            f(T, B, H, S, hd), f(T, B, KV, S, hd), f(T, B, KV, S, hd))


SWA_CASES = [
    (2, 4, 4, 32, 64, None),
    (1, 4, 2, 32, 32, 8),          # GQA + band
    (1, 8, 2, 24, 16, None),
    (2, 2, 1, 17, 64, 5),          # ragged S, MQA
    # the dense configs' head widths: h2o-danube's 120 and gemma3-12b's 256,
    # G = H / KV of 2, 4 and 12 (command-r's), full and banded
    (1, 4, 2, 24, 120, None),
    (1, 8, 2, 21, 256, 8),
    (1, 12, 1, 18, 120, 5),
    (1, 12, 1, 16, 256, None),
]


@pytest.mark.parametrize("B,H,KV,S,hd,window", SWA_CASES)
def test_swa_plain_matches_jax_gqa_ref(B, H, KV, S, hd, window):
    q, k, v, *_ = _swa_inputs(2, B, H, KV, S, hd, 1)
    want = swa_attention_gqa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 window=window)
    got = swa_ops.swa_attention(_t(q), _t(k), _t(v), window)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("B,H,KV,S,hd,window", SWA_CASES)
def test_swa_mt_plain_matches_jax_mt_ref(B, H, KV, S, hd, window):
    arrs = _swa_inputs(3, B, H, KV, S, hd, 3)
    _, want = swa_attention_mt_ref(*map(jnp.asarray, arrs), window=window)
    got = swa_ops.swa_attention_mt_tangents(*map(_t, arrs), window)
    assert got.shape == (3, B, H, S, hd)
    assert _rel(got, want) <= RTOL


def test_swa_plain_matches_pallas_interpret():
    arrs = _swa_inputs(4, 1, 4, 2, 64, 32, 2)
    jarrs = list(map(jnp.asarray, arrs))
    want = jax_swa_pallas(*jarrs[:3], window=24, block_q=32, block_k=32,
                          interpret=True)
    want_d = jax_swa_mt_pallas(*jarrs, window=24, block_q=32, block_k=32,
                               interpret=True)
    tarrs = list(map(_t, arrs))
    assert _rel(swa_ops.swa_attention(*tarrs[:3], 24), want) <= RTOL
    assert _rel(swa_ops.swa_attention_mt_tangents(*tarrs, 24), want_d) <= RTOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,KV,S,hd,window,T", [
    (1, 4, 2, 100, 32, 40, 2),     # GQA, band, ragged S (two 64-key tiles)
    (2, 2, 2, 64, 16, None, 3),
    (1, 2, 1, 70, 64, None, 2),    # MQA, one key past a tile
    (1, 4, 1, 70, 120, 24, 2),     # h2o-danube's width: the kernel pads it to 128
])
def test_swa_mt_tiled_plain_matches_pallas_interpret(B, H, KV, S, hd, window, T, dtype):
    """The tiled plain walk, rounding psd as the reference does, against the
    TPU kernel's ``_mt_kernel`` in interpret mode at the same 64-key tiles
    (ragged S zero-padded by the reference's wrapper). bf16: within one bf16
    ulp of each value and 1e-3 of the largest (``chip_smoke.close_tiled``;
    most values are bitwise equal, the untiled plain version in fp32 is
    1.4e-2 to 2.3e-2 off); fp32: the cross-framework 1e-5."""
    arrs = _swa_inputs(6, B, H, KV, S, hd, T)
    want = jax_swa_mt_pallas(*(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs),
                             window=window, block_q=64, block_k=64, interpret=True)
    want = np.array(want.astype(jnp.float32))
    got = swa_ops.swa_attention_mt_tiled_ref(
        *(_t(a).to(getattr(torch, dtype)) for a in arrs), window, round_psd=True)
    assert got.shape == (T, B, H, S, hd) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert _rel(got, want) <= RTOL
    else:
        torch.testing.assert_close(got.float(), torch.from_numpy(want), rtol=2 ** -7,
                                   atol=1e-3 * float(np.abs(want).max()))


def test_lora_proj_rule_matches_jax_jvp_and_vmaps_to_one_call(monkeypatch):
    """The LoRA rule's tangent equals jax.jvp of the same projection, and
    K stacked tangents reach the multi-tangent wrapper as ONE T=K call."""
    calls = []
    real = dispatch.lora_dual_mt_tangents

    def counting(*args):
        calls.append(args[4].shape[0])
        return real(*args)
    monkeypatch.setattr(dispatch, "lora_dual_mt_tangents", counting)
    d = _lora_inputs(5, 12, 32, 24, 1, 4, True)
    x, w, a, b = (_t(d[k]) for k in ("x", "w", "a", "b"))
    xds, ads, bds = (_t(d[k]) for k in ("xdots", "adots", "bdots"))

    def f(x_, a_, b_):
        return dispatch.lora_proj(x_, w, a_, b_, 0.5)

    def jf(x_, a_, b_):
        y = x_ @ d["w"]
        return y + (x_ @ a_) @ b_ * 0.5
    with dispatch.forward_ad_region():
        _, yd = torch.func.vmap(
            lambda xd, ad, bd: torch.func.jvp(f, (x, a, b), (xd, ad, bd)),
            out_dims=(None, 0))(xds, ads, bds)
    assert calls == [4]
    want = jax.vmap(lambda xd, ad, bd: jax.jvp(
        jf, (d["x"], d["a"], d["b"]), (xd, ad, bd))[1])(
        d["xdots"], d["adots"], d["bdots"])
    assert _rel(yd, want) <= RTOL
    # outside the region the rule takes plain ops and agrees
    _, yd0 = torch.func.jvp(f, (x, a, b), (xds[0], ads[0], bds[0]))
    assert _rel(yd0, want[0]) <= RTOL
    assert calls == [4]


def test_swa_attend_rule_matches_jax_jvp():
    arrs = _swa_inputs(6, 1, 4, 2, 16, 32, 3)
    q, k, v, qd, kd, vd = map(_t, arrs)
    f = functools.partial(dispatch.swa_attend, window=None)
    with dispatch.forward_ad_region():
        out, outd = torch.func.vmap(
            lambda a, b_, c: torch.func.jvp(lambda *p: f(*p), (q, k, v), (a, b_, c)),
            out_dims=(None, 0))(qd, kd, vd)
    want, want_d = swa_attention_mt_ref(*map(jnp.asarray, arrs), window=None)
    assert _rel(out, want) <= RTOL
    assert _rel(outd, want_d) <= RTOL


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    d = {k: _t(v) for k, v in _lora_inputs(7, 8, 16, 8, 1, 2, True).items()}
    lora_ops._check(*(d[k] for k in ("x", "xdots", "w", "a", "adots", "b", "bdots")))
    with pytest.raises(ValueError, match="contiguous"):
        lora_ops._check(d["x"], d["xdots"], d["w"].T.contiguous().T, d["a"],
                        d["adots"], d["b"], d["bdots"])
    with pytest.raises(TypeError, match="float32"):
        lora_ops._check(d["x"], d["xdots"], d["w"], d["a"].double(), d["adots"],
                        d["b"], d["bdots"])
    with pytest.raises(ValueError, match="r<=16"):
        big = torch.zeros(16, 17)
        lora_ops._check(d["x"], d["xdots"], d["w"], big, torch.zeros(2, 16, 17),
                        torch.zeros(17, 8), torch.zeros(2, 17, 8))
    q, k, v, qd, kd, vd = map(_t, _swa_inputs(8, 1, 4, 3, 8, 16, 1))
    with pytest.raises(ValueError, match="GQA"):
        swa_ops._check("swa", q, k, v)
    swa_ops._check("swa", *(torch.zeros(1, 2, 4, 256) for _ in range(3)))   # gemma3-12b
    with pytest.raises(ValueError, match="hd"):
        swa_ops._check("swa", *(torch.zeros(1, 2, 4, 264) for _ in range(3)))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no card here the
    wrappers must raise and must not reach their plain versions."""
    def plain_reached(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")
    for mod, names in ((lora_ops, ("lora_dual_mt_tangents_ref",)),
                       (swa_ops, ("swa_attention_ref",
                                  "swa_attention_mt_tangents_ref"))):
        for n in names:
            monkeypatch.setattr(mod, n, plain_reached)
        monkeypatch.setattr(mod, "_check", lambda *a, **k: None)

    class OnCuda:
        """Stands in for a CUDA tensor (this torch has no CUDA)."""
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (1, 2, 4, 8)

        def numel(self):
            return 64
    t = OnCuda()
    z = torch.zeros(8, 8)
    with pytest.raises(Exception):    # no CUDA in this torch
        lora_ops.lora_dual_mt_tangents(t, None, z, z[:, :1], z[None, :, :1],
                                       z[:1], z[None, :1])
    with pytest.raises(Exception):    # no CUDA in this torch
        swa_ops.swa_attention(t, t, t, None)
    with pytest.raises(Exception):    # no CUDA in this torch
        swa_ops.swa_attention_mt_tangents(t, t, t, z[None], z[None], z[None])
    assert lora_ops.launches["lora_dual_mt"] == 0


# ---------------------------------------------------------------------------
# contraction epilogues (<gy, ydot_t> with no tangent output)
# ---------------------------------------------------------------------------

LORA_JVPS_CASES = [
    (64, 256, 256, 1, 4, True),
    (64, 256, 256, 1, 4, False),
    (37, 100, 72, 2, 3, True),     # ragged widths
    (8, 64, 128, 4, 1, False),
]


def _lora_jvps_inputs(seed, M, K, N, r, T, has_xd):
    d = _lora_inputs(seed, M, K, N, r, T, has_xd)
    d["gy"] = np.random.default_rng(seed + 100).standard_normal((M, N)).astype(np.float32)
    return d


def _lora_jvps_args(d, conv):
    return ([conv(d[k]) for k in ("x", "w", "a", "adots", "b", "bdots", "gy")],
            None if d["xdots"] is None else conv(d["xdots"]))


@pytest.mark.parametrize("M,K,N,r,T,has_xd", LORA_JVPS_CASES)
def test_lora_mt_jvps_plain_matches_jax(M, K, N, r, T, has_xd):
    """The plain version (the reassociated rank-r form) against the JAX
    oracle (materialize, then contract) and the reference's own
    ``impl='reassoc'`` mirror."""
    d = _lora_jvps_inputs(10, M, K, N, r, T, has_xd)
    jargs, jxd = _lora_jvps_args(d, jnp.asarray)
    targs, txd = _lora_jvps_args(d, _t)
    got = lora_ops.lora_dual_mt_jvps(*targs, 0.5, xdots=txd)
    assert got.shape == (T,) and got.dtype == torch.float32
    assert _rel(got, lora_dual_mt_jvps_ref(*jargs, 0.5, xdots=jxd)) <= RTOL
    assert _rel(got, jax_lora_jvps(*jargs, scale=0.5, xdots=jxd,
                                   impl="reassoc")) <= RTOL


@pytest.mark.parametrize("has_xd", [True, False])
def test_lora_mt_jvps_plain_matches_pallas_interpret(has_xd):
    d = _lora_jvps_inputs(11, 40, 96, 80, 1, 2, has_xd)
    jargs, jxd = _lora_jvps_args(d, jnp.asarray)
    targs, txd = _lora_jvps_args(d, _t)
    want = jax_lora_jvps(*jargs, scale=1.0, xdots=jxd, impl="kernel", block_m=32,
                         block_n=32, block_k=32, interpret=True)
    assert _rel(lora_ops.lora_dual_mt_jvps(*targs, 1.0, xdots=txd), want) <= RTOL


@pytest.mark.parametrize("M,K,N,r,T,has_xd,steps", [
    (37, 104, 200, 2, 3, True, 1),      # ragged M, N past the last 64-column stage
    (37, 104, 200, 2, 3, False, 1),
    (64, 256, 320, 1, 4, True, 2),      # slices of two stages, the last one short
    (70, 136, 1032, 3, 2, True, None),  # the kernel's own plan: 17 slices of one stage
    (8, 64, 128, 4, 1, False, None),
])
def test_lora_jvps_split_ref_matches_jax(M, K, N, r, T, has_xd, steps):
    """The N-sliced plain version (the tc kernel's association: per slice of
    N, <gy W^T, xdot_t> + s<gy, udot_t B + u Bdot_t>, slices summed in order)
    against the JAX oracle at fp32 rel 1e-5."""
    if steps is None:
        grid, steps_plan = lora_ops.jvps_split_plan(M, K, N)
        assert grid[2] > 1 or N <= 128
    d = _lora_jvps_inputs(30, M, K, N, r, T, has_xd)
    jargs, jxd = _lora_jvps_args(d, jnp.asarray)
    targs, txd = _lora_jvps_args(d, _t)
    got = lora_ops.lora_dual_mt_jvps_split_ref(*targs, 0.5, xdots=txd, steps=steps)
    assert got.shape == (T,) and got.dtype == torch.float32
    assert _rel(got, lora_dual_mt_jvps_ref(*jargs, 0.5, xdots=jxd)) <= RTOL


@pytest.mark.parametrize("M,K,N,want", [
    (256, 1024, 1024, ((4, 8, 4), 4)),      # roberta-large: 32 tiles, N split 4 ways
    (256, 4096, 4096, ((4, 32, 1), 64)),    # llama2-7b widths: 128 tiles, no split
    (200, 1024, 1032, ((4, 8, 4), 5)),      # 17 stages of N: slices of 5, the last of 2
    (4096, 4096, 4096, ((64, 32, 1), 64)),
    (8, 64, 64, ((1, 1, 1), 1)),
])
def test_lora_jvps_split_plan_depends_on_widths_only(M, K, N, want):
    """The tc contraction's tile plan: about one wave of blocks, from
    (M, K, N) alone (never T, so a tangent's sum is the same in any T)."""
    assert lora_ops.jvps_split_plan(M, K, N) == want


def _gy(seed, B, H, S, hd):
    return np.random.default_rng(seed).standard_normal((B, H, S, hd)).astype(np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd,window", SWA_CASES)
def test_swa_mt_jvps_plain_matches_jax_ref(B, H, KV, S, hd, window):
    arrs = _swa_inputs(12, B, H, KV, S, hd, 3)
    gy = _gy(13, B, H, S, hd)
    want = swa_attention_mt_jvps_ref(*map(jnp.asarray, arrs), jnp.asarray(gy),
                                     window=window)
    got = swa_ops.swa_attention_mt_jvps(*map(_t, arrs), _t(gy), window)
    assert got.shape == (3,) and got.dtype == torch.float32
    assert _rel(got, want) <= RTOL


def test_swa_mt_jvps_plain_matches_pallas_interpret():
    arrs = _swa_inputs(14, 1, 4, 2, 64, 32, 2)          # GQA + band
    gy = _gy(15, 1, 4, 64, 32)
    want = jax_swa_jvps(*map(jnp.asarray, arrs), jnp.asarray(gy), window=24,
                        block_q=32, block_k=32, interpret=True)
    assert _rel(swa_ops.swa_attention_mt_jvps(*map(_t, arrs), _t(gy), 24),
                want) <= RTOL


@pytest.mark.parametrize("site", ["lora", "lora_no_xd", "swa"])
def test_contract_rules_vmap_to_one_call(monkeypatch, site):
    """K stacked tangents reach the contraction epilogue as ONE T=K call,
    and the contraction equals gy contracted with the site's tangents."""
    calls = []
    name = "swa_attention_mt_jvps" if site == "swa" else "lora_dual_mt_jvps"
    real = getattr(dispatch, name)

    def counting(*args, **kw):
        calls.append(args[3].shape[0])      # adots (lora) / qds (swa): T
        return real(*args, **kw)
    monkeypatch.setattr(dispatch, name, counting)
    if site == "swa":
        q, k, v, qd, kd, vd = map(_t, _swa_inputs(16, 1, 4, 2, 16, 32, 4))
        gy = _t(_gy(17, 1, 4, 16, 32))
        got = torch.func.vmap(lambda a, b_, c: dispatch.swa_jvp_contract(
            gy, q, k, v, a, b_, c, 8))(qd, kd, vd)
        want = torch.einsum("bhsd,tbhsd->t", gy,
                            swa_ops.swa_attention_mt_tangents_ref(q, k, v, qd, kd, vd, 8))
    else:
        d = {k: _t(v) for k, v in _lora_jvps_inputs(18, 12, 32, 24, 2, 4, True).items()}
        xd = d["xdots"] if site == "lora" else None
        got = torch.func.vmap(
            lambda x_d, a_d, b_d: dispatch.lora_jvp_contract(
                d["gy"], d["x"], d["w"], d["a"], d["b"], a_d, b_d, xd=x_d, scale=0.5),
            in_dims=(None if xd is None else 0, 0, 0))(xd, d["adots"], d["bdots"])
        yd = lora_ops.lora_dual_mt_tangents_ref(d["x"], xd, d["w"], d["a"], d["adots"],
                                                d["b"], d["bdots"], 0.5)
        want = torch.einsum("mn,tmn->t", d["gy"], yd)
    assert calls == [4]
    assert _rel(got, want) <= RTOL


def test_lora_proj_backward_matches_jax_grad():
    """Reverse mode through ``lora_proj`` (plain ops, no kernel) equals
    jax.grad of the same projection, for x, A and B."""
    d = _lora_inputs(19, 12, 32, 24, 2, 1, False)
    gy = np.random.default_rng(20).standard_normal((12, 24)).astype(np.float32)

    def jf(x_, a_, b_):
        return jnp.sum((x_ @ d["w"] + (x_ @ a_) @ b_ * 0.5) * gy)
    want = jax.grad(jf, argnums=(0, 1, 2))(d["x"], d["a"], d["b"])
    x, a, b = (_t(d[k]).requires_grad_(True) for k in ("x", "a", "b"))
    (dispatch.lora_proj(x, _t(d["w"]), a, b, 0.5) * _t(gy)).sum().backward()
    for got, w_ in zip((x.grad, a.grad, b.grad), want):
        assert _rel(got, w_) <= RTOL


def test_jvps_wrappers_check_and_never_take_the_plain_version(monkeypatch):
    """The epilogue wrappers reject what their kernels do not take, and a
    CUDA tensor never reaches a plain version (no card here: they raise)."""
    d = {k: _t(v) for k, v in _lora_jvps_inputs(21, 8, 16, 8, 1, 2, True).items()}
    args = [d[k] for k in ("x", "xdots", "w", "a", "adots", "b", "bdots")]
    lora_ops._check(*args, d["gy"], what="lora_dual_mt_jvps", t_max=lora_ops.JT_MAX)
    with pytest.raises(ValueError, match="gy"):
        lora_ops._check(*args, d["gy"][:4], what="lora_dual_mt_jvps")
    with pytest.raises(TypeError, match="dtype"):
        lora_ops._check(*args, d["gy"].double(), what="lora_dual_mt_jvps")
    with pytest.raises(ValueError, match="T<=64"):
        big = [d["x"], None, d["w"], d["a"], torch.zeros(65, 16, 1), d["b"],
               torch.zeros(65, 1, 8)]
        lora_ops._check(*big, d["gy"], what="lora_dual_mt_jvps", t_max=lora_ops.JT_MAX)
    q, k, v, qd, kd, vd = map(_t, _swa_inputs(22, 1, 4, 2, 8, 16, 2))
    assert swa_ops._check_jvps(q, k, v, qd, kd, vd, q) == 2
    with pytest.raises(ValueError, match="gy"):
        swa_ops._check_jvps(q, k, v, qd, kd, vd, q[:, :, :4].contiguous())

    def plain_reached(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")
    monkeypatch.setattr(lora_ops, "lora_dual_mt_jvps_ref", plain_reached)
    monkeypatch.setattr(swa_ops, "swa_attention_mt_jvps_ref", plain_reached)
    monkeypatch.setattr(lora_ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(swa_ops, "_check_jvps", lambda *a, **k: 1)

    class OnCuda:
        """Stands in for a CUDA tensor (this torch has no CUDA)."""
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (1, 2, 4, 8)

        def numel(self):
            return 64
    t = OnCuda()
    z = torch.zeros(8, 8)
    with pytest.raises(Exception):    # no CUDA in this torch
        lora_ops.lora_dual_mt_jvps(t, z, z[:, :1], z[None, :, :1], z[:1], z[None, :1], t)
    with pytest.raises(Exception):    # no nvcc, no CUDA here
        swa_ops.swa_attention_mt_jvps(t, t, t, t, t, t, t)
    assert lora_ops.launches["lora_dual_mt_jvps"] == 0
    assert swa_ops.launches["swa_attention_mt_jvps"] == 0


# ---------------------------------------------------------------------------
# the mamba2 recurrence (primal, multi-tangent, contraction)
# ---------------------------------------------------------------------------

def _m2_inputs(seed, B, S, H, hd, N, T):
    """Operands at the model's scales (decay in (0, 1)), as
    tests/test_mamba2_mt.py makes them, plus a cotangent gy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dec = (1.0 / (1.0 + np.exp(-f(B, S, H)))).astype(np.float32)
    return ((f(B, S, H, hd) * 0.3, f(B, S, N) * 0.3, f(B, S, N) * 0.3, dec),
            (f(T, B, S, H, hd) * 0.3, f(T, B, S, N) * 0.3, f(T, B, S, N) * 0.3,
             f(T, B, S, H) * 0.1), f(B, S, H, hd))


M2_CASES = [
    (2, 16, 3, 8, 16, 3),
    (1, 9, 2, 12, 5, 1),           # ragged S, hd and N
    (2, 12, 4, 16, 32, 4),
]


@pytest.mark.parametrize("B,S,H,hd,N,T", M2_CASES)
def test_mamba2_plain_matches_jax_ref(B, S, H, hd, N, T):
    prim, tang, _ = _m2_inputs(30, B, S, H, hd, N, T)
    want_y, want_state = jax_m2_ref(*map(jnp.asarray, prim))
    got_y, got_state = m2_ops.mamba2_scan_ref(*map(_t, prim))
    assert _rel(got_y, want_y) <= RTOL and _rel(got_state, want_state) <= RTOL
    _, want_d = jax_m2_mt_ref(*map(jnp.asarray, prim + tang))
    got_d = m2_ops.mamba2_scan_mt_tangents(*map(_t, prim + tang))
    assert got_d.shape == (T, B, S, H, hd)
    assert _rel(m2_ops.mamba2_scan(*map(_t, prim)), want_y) <= RTOL
    assert _rel(got_d, want_d) <= RTOL


# the chunked form at one chunk (M2_CASES) and over several: a chunk and a
# token, two whole chunks, five chunks with a ragged last one
M2_CHUNKED_CASES = [c + (32,) for c in M2_CASES] + [
    (2, 9, 3, 8, 6, 2, 8),
    (1, 16, 2, 12, 5, 3, 8),
    (2, 37, 2, 8, 16, 2, 8),
]


@pytest.mark.parametrize("B,S,H,hd,N,T,chunk", M2_CHUNKED_CASES)
def test_mamba2_chunked_form_matches_jax_ref(B, S, H, hd, N, T, chunk):
    """The chunked state-space-dual form the CUDA kernels compute (G = C B^T,
    L and Ld by running products, the state carried from chunk to chunk)
    against the JAX oracles' recurrence, primal and tangents."""
    prim, tang, _ = _m2_inputs(35, B, S, H, hd, N, T)
    want_y, want_d = jax_m2_mt_ref(*map(jnp.asarray, prim + tang))
    got_y, got_d = m2_ops.mamba2_chunked_ref(*map(_t, prim + tang), chunk=chunk)
    assert got_y.shape == (B, S, H, hd) and got_d.shape == (T, B, S, H, hd)
    assert _rel(got_y, want_y) <= RTOL and _rel(got_d, want_d) <= RTOL
    assert _rel(m2_ops.mamba2_chunked_ref(*map(_t, prim), chunk=chunk), want_y) <= RTOL


@pytest.mark.parametrize("B,S,H,hd,N,T", M2_CASES)
def test_mamba2_mt_jvps_plain_matches_jax_ref(B, S, H, hd, N, T):
    prim, tang, gy = _m2_inputs(31, B, S, H, hd, N, T)
    want = jax_m2_jvps_ref(*map(jnp.asarray, prim + tang + (gy,)))
    got = m2_ops.mamba2_scan_mt_jvps(*map(_t, prim + tang + (gy,)))
    assert got.shape == (T,)
    assert _rel(got, want) <= RTOL


def _jvps_within(got, want, gy, yds, rtol=1e-6):
    """A contraction of n products against the oracle's: |err| <= rtol x
    sum|terms| per tangent, the terms gy * yds of the oracle's tangents."""
    mag = np.abs(np.asarray(gy, np.float64)[None] * np.asarray(yds, np.float64)).sum(
        axis=(1, 2, 3, 4))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape and (err <= rtol * mag).all(), (err, mag)


# one chunk: the main path's S = 32, S = 31 and small and ragged S, hd, N
M2_JVPS_CHUNK_CASES = [(2, 32, 3, 8, 16, 3), (1, 31, 2, 12, 5, 2)] + M2_CASES


@pytest.mark.parametrize("B,S,H,hd,N,T", M2_JVPS_CHUNK_CASES)
def test_mamba2_jvps_chunked_plain_matches_jax_ref(B, S, H, hd, N, T):
    """The chunk route's plain version (the chunked form's fp32 tangents
    contracted with gy in fp64, rounded once) against the JAX oracle
    ``mamba2_scan_mt_jvps_ref`` at S <= 32: 1e-6 x sum|terms|, the terms
    from the oracle's own tangents."""
    prim, tang, gy = _m2_inputs(36, B, S, H, hd, N, T)
    assert m2_ops.mamba2_jvps_path(S) == "chunk"
    want = jax_m2_jvps_ref(*map(jnp.asarray, prim + tang + (gy,)))
    _, yds = jax_m2_mt_ref(*map(jnp.asarray, prim + tang))
    got = m2_ops.mamba2_scan_mt_jvps_chunked_ref(*map(_t, prim + tang + (gy,)))
    assert got.dtype == torch.float32
    _jvps_within(got.numpy(), np.asarray(want), gy, yds)


def _w6_inputs(seed, B, S, H, hd, T):
    """Operands at rwkv6's scales (w = exp(-exp(0.5 + z / 2)) in (0, 1)),
    a tangent of u and a cotangent gy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = np.exp(-np.exp(0.5 + 0.5 * f(B, S, H, hd))).astype(np.float32)
    prim = (f(B, S, H, hd) * 0.5, f(B, S, H, hd) * 0.5, f(B, S, H, hd) * 0.5, w,
            f(H, hd) * 0.3)
    tang = (f(T, B, S, H, hd) * 0.3, f(T, B, S, H, hd) * 0.3, f(T, B, S, H, hd) * 0.3,
            f(T, B, S, H, hd) * 0.05)
    return prim, tang, f(T, H, hd) * 0.3, f(B, S, H, hd)


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("B,S,H,hd,T", [(2, 32, 2, 8, 3), (1, 29, 3, 12, 2),
                                        (2, 7, 1, 5, 1)])
def test_wkv6_jvps_chunked_plain_matches_jax_ref(B, S, H, hd, T, has_ud):
    """The chunk route's plain version (``wkv6_chunked_ref``'s fp32
    tangents contracted with gy in fp64, rounded once) against the JAX
    oracle ``wkv6_scan_mt_jvps_ref`` at S <= 32, with and without a tangent
    of u: 1e-6 x sum|terms|, the terms from the oracle's own tangents."""
    prim, tang, uds, gy = _w6_inputs(37, B, S, H, hd, T)
    assert w6_ops.wkv6_jvps_path(S) == "chunk"
    ju = jnp.asarray(uds) if has_ud else None
    jp, jt = tuple(map(jnp.asarray, prim)), tuple(map(jnp.asarray, tang))
    want = jax_w6_mt_jvps_ref(*jp, *jt, jnp.asarray(gy), ju)
    _, yds = jax_w6_mt_ref(*jp, *jt, ju)
    got = w6_ops.wkv6_scan_mt_jvps_chunked_ref(*map(_t, prim + tang + (gy,)),
                                               _t(uds) if has_ud else None)
    assert got.dtype == torch.float32
    _jvps_within(got.numpy(), np.asarray(want), gy, yds)


def test_mamba2_plain_matches_pallas_interpret():
    """One tiny case of each plain version against the Pallas kernels in
    interpret mode (ragged S against block_s, as tests/test_mamba2_mt.py)."""
    prim, tang, gy = _m2_inputs(32, 1, 10, 2, 8, 4, 2)
    jp, jt = list(map(jnp.asarray, prim)), list(map(jnp.asarray, tang))
    tp, tt = list(map(_t, prim)), list(map(_t, tang))
    assert _rel(m2_ops.mamba2_scan(*tp),
                jax_m2_pallas(*jp, block_s=4, interpret=True)) <= RTOL
    assert _rel(m2_ops.mamba2_scan_mt_tangents(*tp, *tt),
                jax_m2_mt_pallas(*jp, *jt, block_s=4, interpret=True)) <= RTOL
    assert _rel(m2_ops.mamba2_scan_mt_jvps(*tp, *tt, _t(gy)),
                jax_m2_jvps_pallas(*jp, *jt, jnp.asarray(gy), block_s=4,
                                   interpret=True)) <= RTOL


@pytest.mark.parametrize("bc_tangents", [True, False], ids=["all", "x_only"])
def test_mamba2_mix_rule_matches_jax_jvp_and_vmaps_to_one_call(monkeypatch,
                                                                bc_tangents):
    """The recurrence's rule equals jax.jvp of the reference oracle, and K
    stacked tangents reach the multi-tangent wrapper as ONE T=K call. With
    tangents on xdt only (layer 0: B, C and decay come from the embedding)
    the missing tangents go in as zeros and the launch still happens."""
    calls = []
    real = dispatch.mamba2_scan_mt_tangents

    def counting(*args):
        calls.append(args[4].shape[0])
        return real(*args)
    monkeypatch.setattr(dispatch, "mamba2_scan_mt_tangents", counting)
    prim, tang, _ = _m2_inputs(33, 2, 11, 3, 8, 6, 4)
    if not bc_tangents:
        tang = (tang[0],) + tuple(np.zeros_like(t) for t in tang[1:])
    tp, tt = tuple(map(_t, prim)), tuple(map(_t, tang))
    with dispatch.forward_ad_region():
        if bc_tangents:
            y, yd = torch.func.vmap(
                lambda *d: torch.func.jvp(dispatch.mamba2_mix, tp, d),
                out_dims=(None, 0))(*tt)
        else:
            y, yd = torch.func.vmap(
                lambda xd: torch.func.jvp(lambda x_: dispatch.mamba2_mix(x_, *tp[1:]),
                                          (tp[0],), (xd,)),
                out_dims=(None, 0))(tt[0])
    assert calls == [4]
    want_y, want_d = jax_m2_mt_ref(*map(jnp.asarray, prim + tang))
    assert _rel(y, want_y) <= RTOL
    assert _rel(yd, want_d) <= RTOL


def test_mamba2_contract_rule_vmaps_to_one_call(monkeypatch):
    """K stacked tangents reach the contraction epilogue as ONE T=K call,
    equal to gy contracted with the recurrence's tangents."""
    calls = []
    real = dispatch.mamba2_scan_mt_jvps

    def counting(*args):
        calls.append(args[4].shape[0])
        return real(*args)
    monkeypatch.setattr(dispatch, "mamba2_scan_mt_jvps", counting)
    prim, tang, gy = _m2_inputs(34, 2, 10, 2, 8, 6, 4)
    tp, tt, tg = tuple(map(_t, prim)), tuple(map(_t, tang)), _t(gy)
    got = torch.func.vmap(lambda *d: dispatch.mamba2_jvp_contract(tg, *tp, *d))(*tt)
    assert calls == [4]
    want = jax_m2_jvps_ref(*map(jnp.asarray, prim + tang + (gy,)))
    assert _rel(got, want) <= RTOL


def test_mamba2_wrappers_check_and_never_take_the_plain_version(monkeypatch):
    """The wrappers reject what the kernels do not take (fp32 only, N <= 128,
    agreeing shapes), and a CUDA tensor never reaches a plain version (no
    card here: they raise)."""
    prim, tang, gy = _m2_inputs(35, 1, 4, 2, 8, 4, 2)
    tp, tt = tuple(map(_t, prim)), tuple(map(_t, tang))
    assert m2_ops._check_tangents("m2", *tp, *tt) == (1, 4, 2, 8, 4, 2)
    with pytest.raises(TypeError, match="fp32"):
        m2_ops._check("m2", tp[0].double(), *tp[1:])
    with pytest.raises(ValueError, match="contiguous"):
        m2_ops._check("m2", tp[0].transpose(1, 2).contiguous().transpose(1, 2), *tp[1:])
    with pytest.raises(ValueError, match="agree"):
        m2_ops._check("m2", tp[0], tp[1], tp[2], tp[3][:, :, :1].contiguous())
    with pytest.raises(ValueError, match="N <= 128"):
        wide = torch.zeros(1, 4, 129)
        m2_ops._check("m2", tp[0], wide, wide, tp[3])
    with pytest.raises(ValueError, match="tangent stacks"):
        m2_ops._check_tangents("m2", *tp, tt[0], tt[1][:1], *tt[2:])

    def plain_reached(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")
    for n in ("mamba2_scan_ref", "mamba2_scan_mt_ref", "mamba2_scan_mt_jvps_ref",
              "mamba2_chunked_ref", "mamba2_scan_mt_jvps_chunked_ref"):
        monkeypatch.setattr(m2_ops, n, plain_reached)
    monkeypatch.setattr(m2_ops, "_check", lambda *a, **k: (1, 4, 2, 8, 4))
    monkeypatch.setattr(m2_ops, "_check_tangents", lambda *a, **k: (1, 4, 2, 8, 4, 2))

    class OnCuda:
        """Stands in for a CUDA tensor (this torch has no CUDA)."""
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (1, 4, 2, 8)

        def numel(self):
            return 64
    t = OnCuda()
    with pytest.raises(Exception):    # no CUDA in this torch
        m2_ops.mamba2_scan(t, t, t, t)
    with pytest.raises(Exception):
        m2_ops.mamba2_scan_mt_tangents(t, t, t, t, t, t, t, t)
    for S in (4, 40):                 # the contraction on either route
        assert m2_ops.mamba2_jvps_path(S) == ("chunk" if S <= 32 else "rec")
        monkeypatch.setattr(m2_ops, "_check_tangents",
                            lambda *a, S=S, **k: (1, S, 2, 8, 4, 2))
        with pytest.raises(Exception):
            m2_ops.mamba2_scan_mt_jvps(t, t, t, t, t, t, t, t, t)
    assert m2_ops.launches == {"mamba2_scan": 0, "mamba2_scan_mt": 0,
                               "mamba2_scan_mt_jvps": 0}
    assert m2_ops.launches_by_path == {"mamba2_scan_mt_jvps": {"chunk": 0, "rec": 0}}


def test_wkv6_wrappers_check_and_never_take_the_plain_version(monkeypatch):
    """The wrappers reject what the kernels do not take (hd <= 64,
    agreeing shapes), and a CUDA tensor never reaches a plain version on
    either route of the tangents or the contraction (no card here: they
    raise without moving a counter)."""
    prim, tang, uds, gy = _w6_inputs(38, 1, 4, 2, 8, 2)
    tp, tt = tuple(map(_t, prim)), tuple(map(_t, tang))
    assert w6_ops._check_tangents("w6", *tp, *tt, _t(uds)) == (1, 4, 2, 8, 2)
    with pytest.raises(TypeError, match="fp32"):
        w6_ops._check("w6", tp[0].double(), *tp[1:])
    with pytest.raises(ValueError, match="hd <= 64"):
        wide = torch.zeros(1, 4, 1, 80)
        w6_ops._check("w6", wide, wide, wide, wide, torch.zeros(1, 80))
    with pytest.raises(ValueError, match="tangent stacks"):
        w6_ops._check_tangents("w6", *tp, tt[0][:1], *tt[1:], None)

    def plain_reached(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")
    for n in ("wkv6_scan_ref", "wkv6_scan_mt_ref", "wkv6_scan_mt_jvps_ref",
              "wkv6_chunked_ref", "wkv6_scan_mt_jvps_chunked_ref"):
        monkeypatch.setattr(w6_ops, n, plain_reached)

    class OnCuda:
        """Stands in for a CUDA tensor (this torch has no CUDA)."""
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (1, 4, 2, 8)

        def float(self):
            return self

        def contiguous(self):
            return self

        def numel(self):
            return 64
    t = OnCuda()
    for S in (4, 40):                 # either route of the tangents and the contraction
        assert w6_ops.wkv6_mt_path(S) == w6_ops.wkv6_jvps_path(S) == \
            ("chunk" if S <= 32 else "rec")
        monkeypatch.setattr(w6_ops, "_check_tangents", lambda *a, S=S, **k: (1, S, 2, 8, 2))
        for ud in (None, t):
            with pytest.raises(Exception):    # no CUDA in this torch
                w6_ops.wkv6_scan_mt_tangents(t, t, t, t, t, t, t, t, t, ud)
            with pytest.raises(Exception):
                w6_ops.wkv6_scan_mt_jvps(t, t, t, t, t, t, t, t, t, t, ud)
    monkeypatch.setattr(w6_ops, "_check", lambda *a, **k: (1, 4, 2, 8))
    with pytest.raises(Exception):
        w6_ops.wkv6_scan(t, t, t, t, t)
    assert w6_ops.launches == {"wkv6_scan": 0, "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}
    assert w6_ops.launches_by_path == {"wkv6_scan_mt": {"chunk": 0, "rec": 0},
                                       "wkv6_scan_mt_jvps": {"chunk": 0, "rec": 0}}


# ---------------------------------------------------------------------------
# kernel routes: which kernel a CUDA call takes (decided on the host, so it
# is tested here without a card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,K,N,has_xd,aligned,want", [
    (torch.bfloat16, 1024, 1024, True, True, "tc"),       # roberta-large
    (torch.bfloat16, 1024, 1024, False, True, "store"),   # no input tangent
    (torch.bfloat16, 4096, 4096, True, True, "tc"),       # llama2-7b
    (torch.bfloat16, 2048, 8192, True, True, "tc"),       # zamba2 in_proj
    (torch.bfloat16, 8, 8, False, True, "store"),         # the smallest aligned widths
    (torch.bfloat16, 1004, 1024, True, True, "simt"),     # K off the 8-element rows
    (torch.bfloat16, 1024, 1020, False, True, "simt"),    # N off them
    (torch.bfloat16, 100, 72, True, True, "simt"),
    (torch.bfloat16, 1024, 1024, True, False, "simt"),    # an operand off 16 bytes
    (torch.bfloat16, 1024, 1024, False, False, "simt"),
    (torch.float32, 1024, 1024, True, True, "simt"),      # fp32 stays exact fp32
    (torch.float32, 1024, 1024, False, True, "simt"),
    (torch.float16, 1024, 1024, True, True, "simt"),
])
def test_lora_mt_path_rule(dtype, K, N, has_xd, aligned, want):
    assert lora_ops.lora_mt_path(dtype, K, N, has_xd, aligned) == want


@pytest.mark.parametrize("dtype,K,N,has_xd,aligned,want", [
    (torch.bfloat16, 1024, 1024, True, True, "tc"),       # roberta-large
    (torch.bfloat16, 1024, 1024, False, True, "tc"),      # no input tangent: rank-r terms
    (torch.bfloat16, 4096, 4096, True, True, "tc"),       # llama2-7b
    (torch.bfloat16, 4096, 4096, False, True, "tc"),
    (torch.bfloat16, 8, 8, True, True, "tc"),             # the smallest aligned widths
    (torch.bfloat16, 1004, 1024, True, True, "simt"),     # K off the 8-element rows
    (torch.bfloat16, 1024, 1020, False, True, "simt"),    # N off them
    (torch.bfloat16, 100, 72, True, True, "simt"),
    (torch.bfloat16, 1024, 1024, True, False, "simt"),    # an operand off 16 bytes
    (torch.bfloat16, 1024, 1024, False, False, "simt"),
    (torch.float32, 1024, 1024, True, True, "simt"),      # fp32 stays exact fp32
    (torch.float32, 1024, 1024, False, True, "simt"),
    (torch.float16, 1024, 1024, True, True, "simt"),
])
def test_lora_jvps_path_rule(dtype, K, N, has_xd, aligned, want):
    assert lora_ops.lora_jvps_path(dtype, K, N, has_xd, aligned) == want


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (torch.bfloat16, 64, True, "tc"), (torch.bfloat16, 128, True, "tc"),
    (torch.bfloat16, 16, True, "tc"), (torch.bfloat16, 48, True, "tc"),
    (torch.bfloat16, 256, True, "tc"),         # gemma3-12b: the wide plan
    (torch.bfloat16, 120, True, "tc"),         # h2o-danube: padded to 128 in the kernel
    (torch.bfloat16, 64, False, "simt"),       # a view off the 16-byte copies
    (torch.bfloat16, 40, True, "tc"), (torch.bfloat16, 72, True, "tc"),
    (torch.bfloat16, 8, True, "tc"), (torch.bfloat16, 36, True, "simt"),
    (torch.bfloat16, 120, False, "simt"), (torch.float32, 64, True, "simt"),
    (torch.float32, 128, True, "simt"), (torch.float32, 256, True, "simt"),
    (torch.float32, 120, True, "simt"), (torch.float16, 64, True, "simt"),
])
def test_swa_path_rule(dtype, hd, aligned, want):
    assert swa_ops.swa_path(dtype, hd, aligned) == want


@pytest.mark.parametrize("dtype,M,K,N,aligned,want", [
    (torch.bfloat16, 4, 4096, 4096, True, "stream"),      # llama2-7b decode
    (torch.bfloat16, 1, 16, 8, True, "stream"),
    (torch.bfloat16, 16, 1000, 136, True, "stream"),      # K off the slices, N off 128
    (torch.bfloat16, 4, 1001, 4096, True, "simt"),        # K off the 8-element copies
    (torch.bfloat16, 16, 8192, 4096, True, "stream"),
    (torch.bfloat16, 17, 4096, 4096, True, "simt"),       # more rows
    (torch.bfloat16, 256, 4096, 4096, True, "simt"),
    (torch.bfloat16, 4, 12288, 12288, True, "stream"),    # command-r-plus-104b wq
    (torch.bfloat16, 4, 12288, 1024, True, "stream"),     # and wv
    (torch.bfloat16, 4, 12296, 4096, True, "simt"),       # x's slice past shared memory
    (torch.bfloat16, 4, 8193, 4096, True, "simt"),        # K off the 8-element copies
    (torch.bfloat16, 4, 1000, 333, True, "simt"),         # N off the 8-column loads
    (torch.bfloat16, 4, 4096, 4096, False, "simt"),       # x or W off 16 bytes
    (torch.float32, 4, 4096, 4096, True, "simt"),         # fp32 stays on the fp32 kernel
    (torch.float16, 4, 4096, 4096, True, "simt"),
])
def test_lora_multi_path_rule(dtype, M, K, N, aligned, want):
    assert lora_ops.lora_multi_path(dtype, M, K, N, aligned) == want


@pytest.mark.parametrize("S,want", [(1, "chunk"), (31, "chunk"), (32, "chunk"),
                                    (33, "rec"), (1024, "rec")])
@pytest.mark.parametrize("rule", ["mamba2", "wkv6"])
def test_scan_jvps_path_rule(rule, S, want):
    """The scan contraction epilogues' route is the sequence length alone:
    the chunked kernel with a contraction finish serves one chunk (S <= 32,
    every main-path launch), the recurrent kernel longer S."""
    path = m2_ops.mamba2_jvps_path if rule == "mamba2" else w6_ops.wkv6_jvps_path
    assert path(S) == want


def test_engine_decode_takes_the_stream_route():
    """Every adapted projection of llama2-7b's batched decode (bf16, rows up
    to the engine's batch) streams W; the reduced fp32 engine takes simt."""
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.peft.lora import target_dims
    cfg = get_config("llama2-7b")
    for t in SpryConfig().lora_targets:
        K, N = target_dims(cfg, t)
        for batch in (1, 4, 16):
            assert lora_ops.lora_multi_path(torch.bfloat16, batch, K, N) == "stream"
        K, N = target_dims(reduce_config(cfg), t)
        assert lora_ops.lora_multi_path(torch.float32, 2, K, N) == "simt"


@pytest.mark.parametrize("arch", ["roberta-large-lora", "llama2-7b", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_full_width_main_path_takes_the_tensor_core_routes(arch):
    """At full published width (bf16) every LoRA target and attention head
    width of the training path is aligned for the tensor-core kernels, the
    contraction epilogues' included."""
    from repro_torch.configs import SpryConfig, get_config
    from repro_torch.peft.lora import default_lora_targets, target_dims
    cfg = get_config(arch)
    targets = list(default_lora_targets(cfg))
    if cfg.family == "hybrid":
        targets += list(SpryConfig().lora_targets)      # the shared attention's
    for t in targets:
        K, N = target_dims(cfg, t)
        assert lora_ops.lora_mt_path(torch.bfloat16, K, N, True) == "tc", (t, K, N)
        assert lora_ops.lora_mt_path(torch.bfloat16, K, N, False) == "store", (t, K, N)
        for has_xd in (True, False):
            assert lora_ops.lora_jvps_path(torch.bfloat16, K, N, has_xd) == "tc", (t, K, N)
    if cfg.family in ("dense", "hybrid"):
        assert swa_ops.swa_path(torch.bfloat16, cfg.hd) == "tc"


def test_route_counters_reset_with_the_launch_counters():
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    lora_ops.launches_by_path["lora_dual_mt"]["tc"] += 2
    swa_ops.launches_by_path["swa_attention"]["simt"] += 1
    lora_ops.launches_by_path["lora_dual_mt_jvps"]["tc"] += 1
    swa_ops.launches_by_path["swa_attention_mt_jvps"]["simt"] += 1
    m2_ops.launches_by_path["mamba2_scan_mt_jvps"]["chunk"] += 1
    w6_ops.launches_by_path["wkv6_scan_mt_jvps"]["rec"] += 1
    try:
        assert launch_paths()["lora_dual_mt"]["tc"] >= 2
        assert launch_paths()["lora_dual_mt_jvps"]["tc"] >= 1
        assert launch_paths()["swa_attention_mt_jvps"]["simt"] >= 1
        assert launch_paths()["mamba2_scan_mt_jvps"]["chunk"] >= 1
        assert launch_paths()["wkv6_scan_mt_jvps"]["rec"] >= 1
        assert set(launch_paths()) == {"lora_dual_mt", "swa_attention",
                                       "swa_attention_mt", "lora_dual_multi",
                                       "wkv6_scan_mt", "lora_dual_mt_jvps",
                                       "swa_attention_mt_jvps", "mamba2_scan_mt_jvps",
                                       "wkv6_scan_mt_jvps"}
        assert set(launch_paths()["wkv6_scan_mt"]) == {"chunk", "rec"}
        assert set(launch_paths()["mamba2_scan_mt_jvps"]) == {"chunk", "rec"}
        assert set(launch_paths()["wkv6_scan_mt_jvps"]) == {"chunk", "rec"}
        assert set(launch_paths()["swa_attention_mt"]) == {"tc", "simt"}
        assert set(launch_paths()["lora_dual_mt_jvps"]) == {"tc", "simt"}
        assert set(launch_paths()["swa_attention_mt_jvps"]) == {"tc", "simt"}
        assert set(launch_paths()["lora_dual_multi"]) == {"stream", "simt"}
        assert set(launch_paths()["lora_dual_mt"]) == {"tc", "store", "simt"}
    finally:
        reset_launch_counts()
    assert all(n == 0 for by in launch_paths().values() for n in by.values())
    assert set(launch_counts()) >= {"lora_dual_mt", "swa_attention"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensors_never_take_the_plain_version_on_any_route(monkeypatch, dtype):
    """As above, on each route: a stand-in CUDA tensor of either dtype
    raises without reaching a plain version or moving a counter."""
    def plain_reached(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")
    monkeypatch.setattr(lora_ops, "lora_dual_mt_tangents_ref", plain_reached)
    monkeypatch.setattr(swa_ops, "swa_attention_ref", plain_reached)
    monkeypatch.setattr(lora_ops, "lora_dual_mt_jvps_ref", plain_reached)
    monkeypatch.setattr(lora_ops, "lora_dual_mt_jvps_split_ref", plain_reached)
    monkeypatch.setattr(swa_ops, "swa_attention_mt_jvps_ref", plain_reached)
    monkeypatch.setattr(lora_ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(swa_ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(swa_ops, "_check_jvps", lambda *a, **k: 1)

    class OnCuda:
        """Stands in for a CUDA tensor (this torch has no CUDA)."""
        device = torch.device("cuda")
        shape = (1, 2, 4, 64)

        def __init__(self, dt):
            self.dtype = dt

        def numel(self):
            return 512
    t = OnCuda(dtype)
    z = torch.zeros(64, 64, dtype=dtype)
    from repro_torch.kernels import launch_paths
    before = launch_paths()
    for xd in (None, z[None]):
        with pytest.raises(Exception):    # no CUDA in this torch
            lora_ops.lora_dual_mt_tangents(t, xd, z, z[:, :1].float(),
                                           z[None, :, :1].float(), z[:1].float(),
                                           z[None, :1].float())
    with pytest.raises(Exception):
        swa_ops.swa_attention(t, t, t, None)
    for xd in (None, z[None]):        # the contraction epilogues, either route
        with pytest.raises(Exception):
            lora_ops.lora_dual_mt_jvps(t, z, z[:, :1].float(), z[None, :, :1].float(),
                                       z[:1].float(), z[None, :1].float(), t, xdots=xd)
    with pytest.raises(Exception):
        swa_ops.swa_attention_mt_jvps(t, t, t, t, t, t, t)
    assert launch_paths() == before
    assert lora_ops.launches["lora_dual_mt_jvps"] == 0
    assert swa_ops.launches["swa_attention_mt_jvps"] == 0


def test_build_hash_covers_included_headers(monkeypatch, tmp_path):
    """A library is cached by its source and every header the source
    includes with quotes: editing a header changes the target."""
    from repro_torch.kernels import build
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b, v1\n")
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"k": "k.cu"})
    assert [p.name for p in build._inputs(tmp_path / "k.cu")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, v2\n")
    assert build._target("k") != first
    csrc = Path(build.__file__).resolve().parents[1] / "csrc"
    for src in ("lora_dual_mt.cu", "swa_attention.cu", "mamba2_ssd.cu",
                "wkv6_chunk.cu", "wkv6_scan.cu"):
        assert [p.name for p in build._inputs(csrc / src)] == [src, "hopper.cuh"]
