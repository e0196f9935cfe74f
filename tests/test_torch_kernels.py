"""Port kernels' plain versions and dispatch rules against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU. The plain versions are held against the JAX oracles
(``lora_dual_mt_ref``, ``swa_attention_gqa_ref``, ``swa_attention_mt_ref``)
at fp32 rel 1e-5, and one small case of each against the Pallas kernels in
interpret mode, as tests/test_kernels.py runs them. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lora_dual.ops import lora_dual_mt_tangents as jax_lora_mt_pallas
from repro.kernels.lora_dual.ref import lora_dual_mt_ref
from repro.kernels.swa_attention.ops import swa_attention as jax_swa_pallas
from repro.kernels.swa_attention.ops import (
    swa_attention_mt_tangents as jax_swa_mt_pallas,
)
from repro.kernels.swa_attention.ref import swa_attention_gqa_ref, swa_attention_mt_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.lora_dual import ops as lora_ops
from repro_torch.kernels.swa_attention import ops as swa_ops

torch.set_num_threads(1)
RTOL = 1e-5


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
    with pytest.raises(ValueError, match="hd"):
        swa_ops._check("swa", *(torch.zeros(1, 2, 4, 160) for _ in range(3)))


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
