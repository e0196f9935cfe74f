"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the card (the
mamba2 kernels also lane by lane: a T=8 launch is eight T=1 launches bit
for bit), one reduced estimate per estimator route and family shows
one multi-tangent launch per site (standard) or one contraction epilogue
at the final site (fused) for all K tangents, and a reduced serving engine
makes ``chip_smoke.serve_launches`` multi-adapter launches and the ids of
the same engine on the CPU. This file imports no JAX (the machine with the card has none);
run it there with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips (decided in the fixture, never at import).
"""
import dataclasses
import importlib.util
import math
import os

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


def _chip_smoke():
    """chip_smoke.py, whose ``round_launches`` states the launches a round
    must make."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
                               "swa_attention_mt_jvps": 0, "mamba2_scan": 0,
                               "mamba2_scan_mt": 0, "mamba2_scan_mt_jvps": 0,
                               "lora_dual_multi": 0}


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
                               "swa_attention_mt_jvps": 1, "mamba2_scan": 0,
                               "mamba2_scan_mt": 0, "mamba2_scan_mt_jvps": 0,
                               "lora_dual_multi": 0}
    # the standard route on the same perturbations agrees
    _, _, jvps_std = forward_gradient(lambda p: split(p), peft, 3, k_perturbations=8)
    torch.testing.assert_close(jvps, jvps_std, rtol=1e-4,
                               atol=1e-5 * float(jvps_std.abs().max()))


def _m2_inputs(B, S, H, hd, N, T, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    prim = (rn(B, S, H, hd) * 0.3, rn(B, S, N) * 0.3, rn(B, S, N) * 0.3,
            torch.sigmoid(rn(B, S, H)))
    tang = (rn(T, B, S, H, hd) * 0.3, rn(T, B, S, N) * 0.3, rn(T, B, S, N) * 0.3,
            rn(T, B, S, H) * 0.1)
    return prim, tang, rn(B, S, H, hd)


@pytest.mark.parametrize("B,S,H,hd,N,T", [
    (8, 32, 64, 64, 64, 8),          # zamba2 shapes, one client estimate
    (3, 37, 5, 24, 20, 3),           # ragged S, hd, N and rows a block
    (2, 19, 3, 40, 100, 64),         # N > 64, tangents in 8 chunks
    (1, 5, 1, 1, 1, 1),
])
def test_mamba2_kernels_match_plain(dev, B, S, H, hd, N, T):
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(B, S, H, hd, N, T, dev, 4)
    before = dict(ops.launches)
    y = ops.mamba2_scan(*prim)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in ops.launches.items()} == \
        {"mamba2_scan": 1, "mamba2_scan_mt": 1, "mamba2_scan_mt_jvps": 1}
    y_ref, yd_ref = ops.mamba2_scan_mt_ref(*prim, *tang)
    _close(y, y_ref, torch.float32)
    _close(yd, yd_ref, torch.float32)
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    _jvps_close(jv, torch.einsum("bshd,tbshd->t", gy, yd_ref), mag)


def test_mamba2_lanes_bitwise_and_jvps_repeat(dev):
    """Each tangent of a T=8 launch equals its own T=1 launch bit for bit
    (tangents and contraction), and two contraction launches on the same
    inputs give the same jvps (no atomics)."""
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(3, 37, 5, 24, 20, 8, dev, 5)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in tang)
        assert torch.equal(ops.mamba2_scan_mt_tangents(*prim, *one)[0], yd[t])
        assert torch.equal(ops.mamba2_scan_mt_jvps(*prim, *one, gy)[0], jv[t])
    assert torch.equal(ops.mamba2_scan_mt_jvps(*prim, *tang, gy), jv)


def test_mamba2_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(1, 4, 2, 8, 4, 2, dev, 6)
    with pytest.raises(TypeError, match="fp32"):
        ops.mamba2_scan(prim[0].bfloat16(), *prim[1:])
    with pytest.raises(ValueError, match="N <= 128"):
        wide = torch.zeros(1, 4, 200, device=dev)
        ops.mamba2_scan(prim[0], wide, wide, prim[3])


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("final", ["swa", "mamba2"])
def test_hybrid_launches_per_estimate(dev, final, fused):
    """Reduced zamba2 (final site attention: 2 layers, the shared block
    after each; final site mamba2: 3 layers, after every 2nd), one estimate
    with K=8 on the card: one launch per site, or the final site's ONE
    contraction epilogue on the fused route."""
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import forward_gradient
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_loss_fn, get_model
    from repro_torch.peft import init_peft
    cfg = dataclasses.replace(reduce_config(get_config("zamba2-1.2b")), n_classes=2)
    if final == "mamba2":
        cfg = dataclasses.replace(cfg, n_layers=3, hybrid_attn_every=2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    base = get_model(cfg).init_base(cfg, g)
    peft = init_peft(cfg, g, SpryConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), device=dev),
             "labels": torch.randint(0, 2, (2,), device=dev)}
    split = get_loss_fn("cls", split=True)(cfg, base, batch)
    assert split.kind == final
    reset_launch_counts()
    loss, _, jvps = forward_gradient(split, peft, 3, k_perturbations=8,
                                     fused_contraction=fused)
    torch.cuda.synchronize()
    want = _chip_smoke().round_launches(cfg, "fused" if fused else "standard", 1)
    assert torch.isfinite(loss) and torch.isfinite(jvps).all()
    assert launch_counts() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,P,r", [
    (4, 4096, 4096, 4, 1),          # llama2-7b engine decode
    (256, 1024, 1024, 4, 1),
    (5, 1000, 333, 3, 4),           # ragged edges, every page hit
    (9, 16, 40, 2, 16),             # two row blocks, the rank limit
])
def test_lora_multi_kernel_matches_plain(dev, dtype, M, K, N, P, r):
    from repro_torch.kernels.lora_dual import ops
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, 1, K).to(dtype)                       # engine rows (B, 1, K)
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, b = rn(P, K, r) / math.sqrt(K), rn(P, r, N)
    idx = (torch.arange(M, device=dev) % P).to(torch.int32)
    before = ops.launches["lora_dual_multi"]
    out = ops.lora_dual_multi(x, idx, w, a, b, 0.5)
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_multi"] == before + 1
    assert out.shape == (M, 1, N) and out.dtype == dtype
    _close(out, ops.lora_dual_multi_ref(x.float(), idx, w.float(), a, b, 0.5), dtype)


def test_lora_multi_wrapper_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.lora_dual import ops
    x = torch.randn(4, 16, device=dev)
    w = torch.randn(16, 8, device=dev)
    a, b = torch.randn(2, 16, 1, device=dev), torch.randn(2, 1, 8, device=dev)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.lora_dual_multi(x, idx, w, a.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lora_dual_multi(x, idx, w.T.contiguous().T, a, b)
    with pytest.raises(ValueError, match="r<=16"):
        ops.lora_dual_multi(x, idx, w, torch.randn(2, 16, 17, device=dev),
                            torch.randn(2, 17, 8, device=dev))
    # a page outside [0, P) reads nothing and comes back NaN
    out = ops.lora_dual_multi(x, torch.tensor([0, 1, 2, -1], dtype=torch.int32,
                                              device=dev), w, a, b)
    assert torch.isfinite(out[:2]).all() and torch.isnan(out[2:]).all()


def test_engine_launches_per_decode_step(dev):
    """Reduced llama2 (fp32) through the ServingEngine on the card: exactly
    ``chip_smoke.serve_launches`` multi-adapter launches, the ids of the
    same engine on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serving import Request, ServingEngine
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_map
    cfg = reduce_config(get_config("llama2-7b"))
    base = get_model(cfg).init_base(cfg, torch.Generator().manual_seed(0))
    store = SyntheticAdapterStore(cfg, seed=0)

    class CardStore:
        def template(self):
            return self.load(0)

        def load(self, aid):
            return tree_map(lambda t: t.to(dev), store.load(aid))

    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", i % 3, rng.integers(0, cfg.vocab, 6).astype(np.int32),
                    (4, 2, 5, 3)[i]) for i in range(4)]
    out = {}
    for where, st, b in (("cpu", store, base),
                         ("cuda", CardStore(), tree_map(lambda t: t.to(dev), base))):
        eng = ServingEngine(cfg, b, AdapterCache(st, 2), max_batch=2, cache_len=12)
        reset_launch_counts()
        out[where] = eng.run(reqs)
        counts = launch_counts()
    torch.cuda.synchronize()
    assert counts == _chip_smoke().serve_launches(cfg, eng.steps)
    assert counts["lora_dual_multi"] == 2 * cfg.n_layers * eng.steps > 0
    assert out["cuda"] == out["cpu"]
