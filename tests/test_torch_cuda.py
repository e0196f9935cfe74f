"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the card, and one
reduced estimate per estimator route shows one multi-tangent launch per
site (standard) or one contraction epilogue at the final site (fused) for
all K tangents. This file imports no JAX (the machine with the card has none);
run it there with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips (decided in the fixture, never at import).
"""
import dataclasses
import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32(args):
    """The plain version's reference runs in fp32 on the same values."""
    return tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:   # sums run in another order
        tol = dict(rtol=1e-4, atol=1e-5 * max(float(want.abs().max()), 1.0))
    else:
        tol = dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r,T,has_xd", [
    (256, 1024, 1024, 1, 8, True),
    (256, 1024, 1024, 1, 8, False),
    (37, 100, 72, 3, 3, True),       # ragged edges
    (5, 16, 130, 16, 1, True),
])
def test_lora_kernel_matches_plain(dev, dtype, M, K, N, r, T, has_xd):
    from repro_torch.kernels.lora_dual import ops
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, K).to(dtype)
    xd = rn(T, M, K).to(dtype) if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    args = (x, xd, w, rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K),
            rn(r, N), rn(T, r, N), 0.5)
    before = ops.launches["lora_dual_mt"]
    out = ops.lora_dual_mt_tangents(*args)
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_mt"] == before + 1
    _close(out, ops.lora_dual_mt_tangents_ref(*_f32(args)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window,T", [
    (2, 4, 4, 32, 64, None, 8),
    (1, 8, 2, 100, 128, 40, 3),      # GQA, band, ragged S
    (2, 4, 1, 33, 48, None, 1),      # MQA, hd not a multiple of 32
    (1, 2, 2, 300, 32, 64, 16),
    (1, 4, 2, 40, 128, None, 64),    # T_MAX tangents at hd=128: one warp a block
])
def test_swa_kernels_match_plain(dev, dtype, B, H, KV, S, hd, window, T):
    from repro_torch.kernels.swa_attention import ops
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
    out = ops.swa_attention(q, k, v, window)
    outd = ops.swa_attention_mt_tangents(q, k, v, qd, kd, vd, window)
    torch.cuda.synchronize()
    _close(out, ops.swa_attention_ref(*_f32((q, k, v)), window), dtype)
    _close(outd, ops.swa_attention_mt_tangents_ref(*_f32((q, k, v, qd, kd, vd)),
                                                   window), dtype)


def test_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels.lora_dual import ops as lops
    from repro_torch.kernels.swa_attention import ops as sops
    x = torch.randn(8, 16, device=dev)
    w = torch.randn(16, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        lops.lora_dual_mt_tangents(x, None, w.T.contiguous().T, torch.randn(16, 1, device=dev),
                                   torch.randn(1, 16, 1, device=dev),
                                   torch.randn(1, 8, device=dev),
                                   torch.randn(1, 1, 8, device=dev))
    q = torch.randn(1, 2, 8, 256, device=dev)
    with pytest.raises(ValueError, match="hd"):
        sops.swa_attention(q, q, q)


def test_one_launch_per_site_for_k_tangents(dev):
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import forward_gradient
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import cls_loss, get_model
    from repro_torch.peft import init_peft
    cfg = dataclasses.replace(reduce_config(get_config("roberta-large-lora")),
                              n_classes=2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    base = get_model(cfg).init_base(cfg, g)
    peft = init_peft(cfg, g, SpryConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), device=dev),
             "labels": torch.randint(0, 2, (2,), device=dev)}
    reset_launch_counts()
    loss, grad, jvps = forward_gradient(
        lambda p: cls_loss(cfg, base, p, batch), peft, 3, k_perturbations=8)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert torch.isfinite(loss) and torch.isfinite(jvps).all()
    assert launch_counts() == {"lora_dual_mt": 2 * L, "lora_dual_mt_jvps": 0,
                               "swa_attention": L, "swa_attention_mt": L,
                               "swa_attention_mt_jvps": 0}


def _jvps_close(got, want, mag):
    """Contractions of n terms, summed in another order: the error is held
    against the terms' absolute sum ``mag``, at 1e-6 in both dtypes (bf16
    inputs are read exactly into the same fp32 sums; a typical contraction
    is about mag / sqrt(n), so a wrong or dropped term fails)."""
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-6 * mag).all()), (err, mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r,T,has_xd", [
    (256, 1024, 1024, 1, 8, True),
    (256, 1024, 1024, 1, 8, False),
    (37, 100, 72, 3, 3, True),       # ragged edges
    (70, 33, 65, 16, 64, True),      # rank and tangent limits
])
def test_lora_jvps_kernel_matches_plain(dev, dtype, M, K, N, r, T, has_xd):
    from repro_torch.kernels.lora_dual import ops
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, K).to(dtype)
    xd = rn(T, M, K).to(dtype) if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, ad, b, bd = rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K), rn(r, N), rn(T, r, N)
    gy = rn(M, N).to(dtype)
    before = ops.launches["lora_dual_mt_jvps"]
    got = ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd)
    again = ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd)
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_mt_jvps"] == before + 2
    assert torch.equal(got, again)               # no atomics: the same sum
    f = lambda t: None if t is None else t.float()  # noqa: E731
    yd = ops.lora_dual_mt_tangents_ref(f(x), f(xd), f(w), a, ad, b, bd, 0.5)
    mag = (gy.float()[None] * yd).abs().sum(dim=(1, 2))
    _jvps_close(got, ops.lora_dual_mt_jvps_ref(f(x), f(w), a, ad, b, bd, f(gy), 0.5,
                                               f(xd)), mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window,T", [
    (8, 16, 16, 32, 64, None, 8),
    (1, 8, 2, 100, 128, 40, 3),      # GQA, band, ragged S
    (2, 4, 1, 33, 48, None, 1),      # MQA, hd not a multiple of 32
    (1, 4, 2, 40, 128, None, 64),    # T_MAX tangents at hd=128
])
def test_swa_jvps_kernel_matches_plain(dev, dtype, B, H, KV, S, hd, window, T):
    from repro_torch.kernels.swa_attention import ops
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
    gy = rn(B, H, S, hd)
    got = ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window)
    again = ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    od = ops.swa_attention_mt_tangents_ref(*_f32((q, k, v, qd, kd, vd)), window)
    mag = (gy.float()[None] * od).abs().sum(dim=(1, 2, 3, 4))
    _jvps_close(got, torch.einsum("bhsd,tbhsd->t", gy.float(), od), mag)


def test_fused_route_one_epilogue_per_estimate(dev):
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import forward_gradient
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_loss_fn, get_model
    from repro_torch.peft import init_peft
    cfg = dataclasses.replace(reduce_config(get_config("llama2-7b")), n_classes=2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    base = get_model(cfg).init_base(cfg, g)
    peft = init_peft(cfg, g, SpryConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), device=dev),
             "labels": torch.randint(0, 2, (2,), device=dev)}
    split = get_loss_fn("cls", split=True)(cfg, base, batch)
    reset_launch_counts()
    loss, grad, jvps = forward_gradient(split, peft, 3, k_perturbations=8,
                                        fused_contraction=True)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert torch.isfinite(loss) and torch.isfinite(jvps).all()
    assert launch_counts() == {"lora_dual_mt": 2 * L, "lora_dual_mt_jvps": 0,
                               "swa_attention": L, "swa_attention_mt": L - 1,
                               "swa_attention_mt_jvps": 1}
    # the standard route on the same perturbations agrees
    _, _, jvps_std = forward_gradient(lambda p: split(p), peft, 3, k_perturbations=8)
    torch.testing.assert_close(jvps, jvps_std, rtol=1e-4,
                               atol=1e-5 * float(jvps_std.abs().max()))
