"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the card, and one
reduced estimate shows one multi-tangent launch per site for all K
tangents. This file imports no JAX (the machine with the card has none);
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
    assert launch_counts() == {"lora_dual_mt": 2 * L, "swa_attention": L,
                               "swa_attention_mt": L}
