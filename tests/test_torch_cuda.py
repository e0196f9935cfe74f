"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the card (the
mamba2 and wkv6 kernels and the bf16 LoRA and attention contraction
epilogues also lane by lane: a T=8 launch is eight T=1 launches bit for
bit; the mamba2 and wkv6 contraction epilogues' chunk route also against
the fp64 contraction of the tangent pass's output), one reduced estimate
per estimator route and family shows one multi-tangent launch per site
(standard) or one contraction epilogue
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
    out = _one_launch_by(ops.launches_by_path["lora_dual_mt"],
                         ops.lora_mt_path(dtype, K, N, has_xd),
                         lambda: ops.lora_dual_mt_tangents(*args))
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_mt"] == before + 1
    _close(out, ops.lora_dual_mt_tangents_ref(*_f32(args)), dtype)


def _one_launch_by(counter, route, call):
    """``call()``, which must count exactly one launch, on ``route`` of the
    per-route ``counter``."""
    before = dict(counter)
    out = call()
    assert {p: n - before[p] for p, n in counter.items() if n != before[p]} == {route: 1}
    return out


LORA_ROUTE_CASES = (
    [(256, K, K, r, T, xd) for K in (1024, 4096) for r in (1, 16) for T in (1, 8, 64)
     for xd in (True, False)]
    + [(200, K, K, r, 3, xd) for K in (1024, 4096) for r in (1, 16)    # tiles straddle
       for xd in (True, False)])                                      # two tangents


@pytest.mark.parametrize("M,K,N,r,T,has_xd", LORA_ROUTE_CASES)
def test_lora_bf16_routes_match_plain(dev, M, K, N, r, T, has_xd):
    """The bf16 routes at the main path's widths and their edges: tensor-core
    GEMM with an input tangent, the store kernel without, both held to the
    plain version at the bf16 tolerance."""
    from repro_torch.kernels.lora_dual import ops
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, K).bfloat16()
    xd = rn(T, M, K).bfloat16() if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).bfloat16()
    args = (x, xd, w, rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K),
            rn(r, N), rn(T, r, N), 0.5)
    out = _one_launch_by(ops.launches_by_path["lora_dual_mt"],
                         "tc" if has_xd else "store",
                         lambda: ops.lora_dual_mt_tangents(*args))
    torch.cuda.synchronize()
    _close(out, ops.lora_dual_mt_tangents_ref(*_f32(args)), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window,T", [
    (2, 4, 4, 32, 64, None, 8),
    (1, 8, 2, 100, 128, 40, 3),      # GQA, band, ragged S
    (2, 4, 1, 33, 48, None, 1),      # MQA, hd not a multiple of 32
    (1, 2, 2, 300, 32, 64, 16),
    (1, 4, 2, 40, 128, None, 64),    # T_MAX tangents at hd=128
    (8, 16, 16, 32, 64, None, 1),    # roberta-large's main shape, T = 1 and 8
    (8, 16, 16, 32, 64, None, 8),
    (8, 32, 32, 32, 128, None, 8),   # llama2-7b widths
    (1, 4, 4, 20, 40, 7, 5),         # hd off the 16 multiple: padded to 48 in bf16
    (1, 4, 4, 20, 36, 7, 5),         # hd off the 8 multiple: simt in bf16
    (8, 16, 8, 32, 256, None, 8),    # gemma3-12b: the wide plan (hd split over two blocks)
    (2, 16, 8, 100, 256, 40, 3),     # its one key buffer over two tiles, band
    (8, 32, 8, 32, 120, None, 8),    # h2o-danube: padded to 128
    (2, 12, 1, 100, 120, 40, 3),     # G = 12, band
    (1, 4, 2, 70, 200, None, 2),     # a wide width off 32: padded to 224
])
def test_swa_kernels_match_plain(dev, dtype, B, H, KV, S, hd, window, T):
    """Primal and tangents against the plain versions, each on the route
    ``swa_path`` gives; the tensor-core tangents also against the tiled
    plain walk in their own roundings, at ``chip_smoke.close_tiled``'s
    tighter limit."""
    from repro_torch.kernels.swa_attention import ops
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
    route = ops.swa_path(dtype, hd)
    out = _one_launch_by(ops.launches_by_path["swa_attention"], route,
                         lambda: ops.swa_attention(q, k, v, window))
    outd = _one_launch_by(ops.launches_by_path["swa_attention_mt"], route,
                          lambda: ops.swa_attention_mt_tangents(q, k, v, qd, kd, vd, window))
    torch.cuda.synchronize()
    _close(out, ops.swa_attention_ref(*_f32((q, k, v)), window), dtype)
    _close(outd, ops.swa_attention_mt_tangents_ref(*_f32((q, k, v, qd, kd, vd)),
                                                   window), dtype)
    if route == "tc":
        _chip_smoke().close_tiled("swa_attention_mt", outd, ops.swa_attention_mt_tiled_ref(
            q, k, v, qd, kd, vd, window))


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("kv_div", [1, 4], ids=["KV=H", "KV=H/4"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [1, 17, 32, 2048])
def test_swa_primal_tensor_core_route_matches_plain(dev, S, hd, kv_div, window):
    """The bf16 primal on tensor cores from one query row to a long
    sequence, full and banded, MHA and GQA."""
    from repro_torch.kernels.swa_attention import ops
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    B, H = (1, 8) if S == 2048 else (2, 8)
    KV = H // kv_div
    rn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    out = _one_launch_by(ops.launches_by_path["swa_attention"], "tc",
                         lambda: ops.swa_attention(q, k, v, window))
    torch.cuda.synchronize()
    _close(out, ops.swa_attention_ref(*_f32((q, k, v)), window), torch.bfloat16)


def test_unaligned_bf16_operands_take_the_simt_route(dev):
    """A view that starts off a 16-byte boundary cannot feed the TMA or
    cp.async copies, nor the vector loads of the fp32 LoRA factors: the
    wrappers take the plain-FMA kernels, which hold. Shifted once x and
    xdots, once adots alone."""
    from repro_torch.kernels.lora_dual import ops as lops
    from repro_torch.kernels.swa_attention import ops as sops
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def rn(*shape, shift=False, scale=1.0, dtype=torch.float32):
        """contiguous; with ``shift`` one element past an aligned start"""
        n = math.prod(shape)
        t = (torch.randn(n + 1, generator=g, device=dev) * scale).to(dtype)
        return t[int(shift):n + int(shift)].view(shape)
    M, K, N, T = 64, 256, 128, 4
    sk = 1 / math.sqrt(K)
    for shift_x, shift_adots in ((True, False), (False, True)):
        bf = torch.bfloat16
        args = (rn(M, K, shift=shift_x, dtype=bf), rn(T, M, K, shift=shift_x, dtype=bf),
                rn(K, N, scale=sk, dtype=bf), rn(K, 1, scale=sk),
                rn(T, K, 1, shift=shift_adots, scale=sk), rn(1, N), rn(T, 1, N), 0.5)
        assert (args[0].data_ptr() % 16 != 0) == shift_x
        assert (args[4].data_ptr() % 16 != 0) == shift_adots
        out = _one_launch_by(lops.launches_by_path["lora_dual_mt"], "simt",
                             lambda: lops.lora_dual_mt_tangents(*args))
        torch.cuda.synchronize()
        _close(out, lops.lora_dual_mt_tangents_ref(*_f32(args)), torch.bfloat16)
    q, k, v = (rn(1, 4, 40, 64, shift=True, dtype=torch.bfloat16) for _ in range(3))
    att = _one_launch_by(sops.launches_by_path["swa_attention"], "simt",
                         lambda: sops.swa_attention(q, k, v))
    torch.cuda.synchronize()
    _close(att, sops.swa_attention_ref(*_f32((q, k, v))), torch.bfloat16)


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
    q = torch.randn(1, 2, 8, 264, device=dev)
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
                               "lora_dual_multi": 0, "wkv6_scan": 0,
                               "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}


def _jvps_close(got, want, mag):
    """Contractions of n terms, summed in another order: the error is held
    against the terms' absolute sum ``mag``, at 1e-6 in both dtypes (bf16
    inputs are read exactly into the same fp32 sums; a typical contraction
    is about mag / sqrt(n), so a wrong or dropped term fails)."""
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-6 * mag).all()), (err, mag)


def _fp64_contraction_close(jv, gy, yd):
    """The scan epilogues' chunk route sums exact fp64 products of the fp32
    tangents ``yd`` and gy, and rounds once to fp32: jv within 1e-12 x
    sum|terms| of ``einsum(gy.double(), yd.double())`` plus half an fp32
    ulp of jv."""
    y64, g64 = yd.double(), gy.double()
    want = torch.einsum("bshd,tbshd->t", g64, y64)
    mag = (g64[None] * y64).abs().sum(dim=(1, 2, 3, 4))
    a = jv.abs()
    half_ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double() / 2
    err = (jv.double() - want).abs()
    assert bool((err <= 1e-12 * mag + half_ulp).all()), (err, mag, half_ulp)


def _lora_jvps_inputs(M, K, N, r, T, has_xd, dtype, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, K).to(dtype)
    xd = rn(T, M, K).to(dtype) if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, ad, b, bd = rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K), rn(r, N), rn(T, r, N)
    return x, xd, w, a, ad, b, bd, rn(M, N).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r,T,has_xd", [
    (256, 1024, 1024, 1, 8, True),
    (256, 1024, 1024, 1, 8, False),
    (37, 100, 72, 3, 3, True),       # ragged edges
    (70, 33, 65, 16, 64, True),      # rank and tangent limits
    (256, 4096, 4096, 1, 8, True),   # llama2-7b widths
    (256, 4096, 4096, 1, 8, False),
    (200, 1032, 1032, 16, 3, True),  # M, K and N off the tc tiles, rank 16
    (200, 1032, 1032, 16, 3, False),
    (64, 1024, 1024, 1, 64, True),   # 64 tangents through the tc ring
])
def test_lora_jvps_kernel_matches_plain(dev, dtype, M, K, N, r, T, has_xd):
    from repro_torch.kernels.lora_dual import ops
    x, xd, w, a, ad, b, bd, gy = _lora_jvps_inputs(M, K, N, r, T, has_xd, dtype, dev, 2)
    before = ops.launches["lora_dual_mt_jvps"]
    got = _one_launch_by(ops.launches_by_path["lora_dual_mt_jvps"],
                         ops.lora_jvps_path(dtype, K, N, has_xd),
                         lambda: ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd))
    again = ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd)
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_mt_jvps"] == before + 2
    assert torch.equal(got, again)               # no atomics: the same sum
    f = lambda t: None if t is None else t.float()  # noqa: E731
    yd = ops.lora_dual_mt_tangents_ref(f(x), f(xd), f(w), a, ad, b, bd, 0.5)
    mag = (gy.float()[None] * yd).abs().sum(dim=(1, 2))
    _jvps_close(got, ops.lora_dual_mt_jvps_ref(f(x), f(w), a, ad, b, bd, f(gy), 0.5,
                                               f(xd)), mag)


def _swa_jvps_inputs(B, H, KV, S, hd, T, dtype, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    return (rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd), rn(T, B, H, S, hd),
            rn(T, B, KV, S, hd), rn(T, B, KV, S, hd), rn(B, H, S, hd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window,T", [
    (8, 16, 16, 32, 64, None, 8),
    (1, 8, 2, 100, 128, 40, 3),      # GQA, band, ragged S
    (2, 4, 1, 33, 48, None, 1),      # MQA, hd not a multiple of 32
    (1, 4, 2, 40, 128, None, 64),    # T_MAX tangents at hd=128
    (8, 32, 32, 32, 128, None, 8),   # llama2-7b widths
    (1, 4, 1, 300, 32, 64, 5),       # four tangents a group, two key buffers, band
    (8, 16, 8, 32, 256, None, 8),    # gemma3-12b: a partial a column half
    (2, 16, 8, 100, 256, 40, 3),
    (8, 32, 8, 32, 120, None, 8),    # h2o-danube: padded to 128
    (2, 12, 1, 100, 120, 40, 3),
])
def test_swa_jvps_kernel_matches_plain(dev, dtype, B, H, KV, S, hd, window, T):
    from repro_torch.kernels.swa_attention import ops
    q, k, v, qd, kd, vd, gy = _swa_jvps_inputs(B, H, KV, S, hd, T, dtype, dev, 3)
    got = _one_launch_by(ops.launches_by_path["swa_attention_mt_jvps"],
                         ops.swa_path(dtype, hd),
                         lambda: ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window))
    again = ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    od = ops.swa_attention_mt_tangents_ref(*_f32((q, k, v, qd, kd, vd)), window)
    mag = (gy.float()[None] * od).abs().sum(dim=(1, 2, 3, 4))
    _jvps_close(got, torch.einsum("bhsd,tbhsd->t", gy.float(), od), mag)


@pytest.mark.parametrize("has_xd", [True, False], ids=["xd", "no_xd"])
@pytest.mark.parametrize("M,K,N", [(200, 1032, 1032), (256, 1024, 1024)])
def test_lora_jvps_lanes_bitwise_and_repeat(dev, M, K, N, has_xd):
    """On the tc route each tangent of a T=8 launch equals its own T=1
    launch bit for bit (the tile plan and every sum's order depend on
    (M, K, N) alone), and two launches on the same inputs give the same
    jvps; the kernel's plan is the one ``jvps_split_plan`` states."""
    from repro_torch.kernels.lora_dual import ops
    x, xd, w, a, ad, b, bd, gy = _lora_jvps_inputs(M, K, N, 2, 8, has_xd, torch.bfloat16,
                                                   dev, 5)
    grid, _ = ops.jvps_split_plan(M, K, N)
    assert ops._fn("lora_dual_mt_jvps_bf16_blocks")(M, K, N) == math.prod(grid)
    jv = _one_launch_by(ops.launches_by_path["lora_dual_mt_jvps"], "tc",
                        lambda: ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd))
    for t in range(8):
        one = ops.lora_dual_mt_jvps(x, w, a, ad[t:t + 1].contiguous(), b,
                                    bd[t:t + 1].contiguous(), gy, 0.5,
                                    xdots=None if xd is None else xd[t:t + 1].contiguous())
        assert torch.equal(one[0], jv[t]), t
    assert torch.equal(ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd), jv)


@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (8, 16, 16, 32, 64, None),       # roberta-large: two tangents a group
    (2, 8, 2, 100, 128, 40),         # one a group, GQA, band, ragged S
    (1, 4, 1, 150, 32, None),        # four a group, two key buffers
    (8, 16, 8, 32, 256, None),       # gemma3-12b: two column halves a tangent
    (2, 16, 8, 100, 256, 40),        # and one key buffer over two tiles
    (8, 32, 8, 32, 120, None),       # h2o-danube: padded to 128
])
def test_swa_jvps_lanes_bitwise_and_repeat(dev, B, H, KV, S, hd, window):
    """On the tc route each tangent of a T=8 launch (in any slot of any
    tangent group) equals its own T=1 launch bit for bit, and two launches
    on the same inputs give the same jvps."""
    from repro_torch.kernels.swa_attention import ops
    q, k, v, qd, kd, vd, gy = _swa_jvps_inputs(B, H, KV, S, hd, 8, torch.bfloat16, dev, 6)
    jv = _one_launch_by(ops.launches_by_path["swa_attention_mt_jvps"], "tc",
                        lambda: ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window))
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in (qd, kd, vd))
        assert torch.equal(ops.swa_attention_mt_jvps(q, k, v, *one, gy, window)[0], jv[t]), t
    assert torch.equal(ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window), jv)


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
                               "lora_dual_multi": 0, "wkv6_scan": 0,
                               "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}
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
    (2, 19, 3, 40, 100, 64),         # N > 64, 64 tangents
    (1, 5, 1, 1, 1, 1),
    (2, 70, 3, 40, 64, 8),           # three 32-token chunks: the state carry
    (2, 32, 4, 64, 64, 4),           # one whole chunk
    (2, 33, 4, 64, 64, 4),           # one token past it
])
def test_mamba2_kernels_match_plain(dev, B, S, H, hd, N, T):
    """Each kernel against its plain version, the contraction on the route
    ``mamba2_jvps_path`` gives (chunk for S <= 32)."""
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(B, S, H, hd, N, T, dev, 4)
    before = dict(ops.launches)
    y = ops.mamba2_scan(*prim)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    route = ops.mamba2_jvps_path(S)
    assert route == ("chunk" if S <= 32 else "rec")
    jv = _one_launch_by(ops.launches_by_path["mamba2_scan_mt_jvps"], route,
                        lambda: ops.mamba2_scan_mt_jvps(*prim, *tang, gy))
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in ops.launches.items()} == \
        {"mamba2_scan": 1, "mamba2_scan_mt": 1, "mamba2_scan_mt_jvps": 1}
    y_ref, yd_ref = ops.mamba2_scan_mt_ref(*prim, *tang)
    _close(y, y_ref, torch.float32)
    _close(yd, yd_ref, torch.float32)
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    _jvps_close(jv, torch.einsum("bshd,tbshd->t", gy, yd_ref), mag)
    if route == "chunk":
        _jvps_close(jv, ops.mamba2_scan_mt_jvps_chunked_ref(*prim, *tang, gy), mag)


@pytest.mark.parametrize("S", [32, 37], ids=["chunk", "rec"])
def test_mamba2_lanes_bitwise_and_jvps_repeat(dev, S):
    """Each tangent of a T=8 launch equals its own T=1 launch bit for bit
    (tangents and contraction, on both contraction routes), and two
    contraction launches on the same inputs give the same jvps (no
    atomics)."""
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(3, S, 5, 24, 20, 8, dev, 5)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in tang)
        assert torch.equal(ops.mamba2_scan_mt_tangents(*prim, *one)[0], yd[t])
        assert torch.equal(ops.mamba2_scan_mt_jvps(*prim, *one, gy)[0], jv[t])
    assert torch.equal(ops.mamba2_scan_mt_jvps(*prim, *tang, gy), jv)


@pytest.mark.parametrize("B,S,H,hd,N,T", [
    (8, 32, 64, 64, 64, 8),          # zamba2 shapes
    (2, 19, 3, 40, 100, 64),         # ragged, N > 64, 64 tangents
    (3, 29, 5, 24, 20, 3),
])
def test_mamba2_jvps_chunk_route_is_the_fp64_contraction_of_the_tangents(
        dev, B, S, H, hd, N, T):
    """On the chunk route the contraction is row 11's stored tangents
    contracted with gy in fp64 (``_fp64_contraction_close``), and a repeat
    launch gives the same jvps."""
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = _m2_inputs(B, S, H, hd, N, T, dev, 10)
    assert ops.mamba2_jvps_path(S) == "chunk"
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    _fp64_contraction_close(jv, gy, yd)
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


def _wkv6_inputs(B, S, H, hd, T, has_ud, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    prim = (rn(B, S, H, hd) * 0.5, rn(B, S, H, hd) * 0.5, rn(B, S, H, hd) * 0.5,
            torch.exp(-torch.exp(0.5 + 0.5 * rn(B, S, H, hd))), rn(H, hd) * 0.3)
    tang = (rn(T, B, S, H, hd) * 0.3, rn(T, B, S, H, hd) * 0.3,
            rn(T, B, S, H, hd) * 0.3, rn(T, B, S, H, hd) * 0.05)
    return prim, tang, (rn(T, H, hd) * 0.3 if has_ud else None), rn(B, S, H, hd)


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("B,S,H,hd,T", [
    (8, 32, 32, 64, 8),              # rwkv6-1.6b shapes, one client estimate
    (3, 29, 5, 40, 3),               # the chunk route: ragged S, B*H and hd
    (3, 37, 5, 40, 3),               # ragged S, B*H, hd not a tile multiple
    (2, 19, 3, 16, 64),              # hd <= 16, tangents in 8 chunks
    (1, 5, 1, 1, 1),
    (2, 70, 3, 24, 2),               # the primal's ring of chunks, hd % 4 == 0
])
def test_wkv6_kernels_match_plain(dev, B, S, H, hd, T, has_ud):
    """Each kernel against its plain version, the tangents and the
    contraction on the routes ``wkv6_mt_path`` and ``wkv6_jvps_path`` give
    (chunk for S <= 32) and, on the chunk route, the tangents also against
    the plain chunked form (``wkv6_chunked_ref``)."""
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = _wkv6_inputs(B, S, H, hd, T, has_ud, dev, 7)
    before = dict(ops.launches)
    y = ops.wkv6_scan(*prim)
    route = ops.wkv6_mt_path(S)
    assert route == ("chunk" if S <= 32 else "rec")
    yd = _one_launch_by(ops.launches_by_path["wkv6_scan_mt"], route,
                        lambda: ops.wkv6_scan_mt_tangents(*prim, *tang, uds))
    assert ops.wkv6_jvps_path(S) == route
    jv = _one_launch_by(ops.launches_by_path["wkv6_scan_mt_jvps"], route,
                        lambda: ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds))
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in ops.launches.items()} == \
        {"wkv6_scan": 1, "wkv6_scan_mt": 1, "wkv6_scan_mt_jvps": 1}
    y_ref, yd_ref = ops.wkv6_scan_mt_ref(*prim, *tang, uds)
    _close(y, y_ref, torch.float32)
    _close(yd, yd_ref, torch.float32)
    if route == "chunk":
        _close(yd, ops.wkv6_chunked_ref(*prim, *tang, uds)[1], torch.float32)
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    _jvps_close(jv, torch.einsum("bshd,tbshd->t", gy, yd_ref), mag)
    if route == "chunk":
        _jvps_close(jv, ops.wkv6_scan_mt_jvps_chunked_ref(*prim, *tang, gy, uds), mag)


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("S", [29, 32, 37], ids=["chunk", "chunk_full", "rec"])
def test_wkv6_lanes_bitwise_and_jvps_repeat(dev, S, has_ud):
    """Each tangent of a T=8 launch equals its own T=1 launch bit for bit
    (tangents on both routes, and the contraction), and two contraction
    launches on the same inputs give the same jvps (no atomics)."""
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = _wkv6_inputs(3, S, 5, 40, 8, has_ud, dev, 8)
    yd = ops.wkv6_scan_mt_tangents(*prim, *tang, uds)
    jv = ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds)
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in tang)
        ud1 = None if uds is None else uds[t:t + 1].contiguous()
        assert torch.equal(ops.wkv6_scan_mt_tangents(*prim, *one, ud1)[0], yd[t])
        assert torch.equal(ops.wkv6_scan_mt_jvps(*prim, *one, gy, ud1)[0], jv[t])
    assert torch.equal(ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds), jv)


@pytest.mark.parametrize("has_ud", [False, True], ids=["no_ud", "ud"])
@pytest.mark.parametrize("B,S,H,hd,T", [
    (8, 32, 32, 64, 8),              # rwkv6-1.6b shapes
    (3, 29, 5, 40, 64),              # ragged, 64 tangents
    (2, 19, 3, 16, 3),
])
def test_wkv6_jvps_chunk_route_is_the_fp64_contraction_of_the_tangents(
        dev, B, S, H, hd, T, has_ud):
    """On the chunk route the contraction is row 8's stored tangents
    contracted with gy in fp64 (``_fp64_contraction_close``), and a repeat
    launch gives the same jvps."""
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = _wkv6_inputs(B, S, H, hd, T, has_ud, dev, 11)
    assert ops.wkv6_jvps_path(S) == "chunk"
    yd = ops.wkv6_scan_mt_tangents(*prim, *tang, uds)
    jv = ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds)
    _fp64_contraction_close(jv, gy, yd)
    assert torch.equal(ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds), jv)


def test_wkv6_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = _wkv6_inputs(1, 4, 2, 8, 2, False, dev, 9)
    with pytest.raises(ValueError, match="hd <= 64"):
        wide = torch.zeros(1, 4, 1, 80, device=dev)
        ops.wkv6_scan(wide, wide, wide, wide, torch.zeros(1, 80, device=dev))
    with pytest.raises(ValueError, match="do not agree"):
        ops.wkv6_scan(*prim[:4], prim[4][:1])
    with pytest.raises(ValueError, match="tangent stacks"):
        ops.wkv6_scan_mt_tangents(*prim, tang[0][:1], *tang[1:])


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_rwkv6_launches_per_estimate(dev, fused):
    """Reduced rwkv6, one estimate with K=8 on the card: one LoRA launch per
    adapted projection (wr, wv) and one primal and one multi-tangent wkv6
    launch per layer, or the final site's ONE contraction epilogue on the
    fused route; the fused jvps agree with the standard route's."""
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import forward_gradient
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_loss_fn, get_model
    from repro_torch.peft import init_peft
    cfg = dataclasses.replace(reduce_config(get_config("rwkv6-1.6b")), n_classes=2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    base = get_model(cfg).init_base(cfg, g)
    peft = init_peft(cfg, g, SpryConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), device=dev),
             "labels": torch.randint(0, 2, (2,), device=dev)}
    split = get_loss_fn("cls", split=True)(cfg, base, batch)
    assert split.kind == "wkv6"
    reset_launch_counts()
    loss, _, jvps = forward_gradient(split, peft, 3, k_perturbations=8,
                                     fused_contraction=fused)
    torch.cuda.synchronize()
    want = _chip_smoke().round_launches(cfg, "fused" if fused else "standard", 1)
    assert torch.isfinite(loss) and torch.isfinite(jvps).all()
    assert launch_counts() == want
    _, _, jvps_std = forward_gradient(split, peft, 3, k_perturbations=8)
    torch.testing.assert_close(jvps, jvps_std, rtol=1e-4,
                               atol=1e-5 * float(jvps_std.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,P,r", [
    (4, 4096, 4096, 4, 1),          # llama2-7b engine decode
    (256, 1024, 1024, 4, 1),
    (5, 1000, 333, 3, 4),           # ragged edges, every page hit (N: simt)
    (9, 16, 40, 2, 16),             # two row blocks, the rank limit
    (1, 4096, 4096, 3, 1),          # one row
    (16, 4096, 4096, 4, 2),         # the stream route's most rows, repeated pages
    (6, 1000, 136, 2, 3),           # K off the 8 slices, N off the 128-column strip
    (3, 1001, 64, 2, 1),            # K off the 8-element copies: simt in bf16
    (4, 12288, 12288, 4, 1),        # command-r-plus-104b's decode: wq
    (4, 12288, 1024, 4, 1),         # and wv, the stream route's largest K
])
def test_lora_multi_kernel_matches_plain(dev, dtype, M, K, N, P, r):
    """Against the plain version on the route ``lora_multi_path`` gives; a
    second launch on the same inputs is bitwise equal."""
    from repro_torch.kernels.lora_dual import ops
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(M, 1, K).to(dtype)                       # engine rows (B, 1, K)
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, b = rn(P, K, r) / math.sqrt(K), rn(P, r, N)
    idx = (torch.arange(M, device=dev) % P).to(torch.int32)
    before = ops.launches["lora_dual_multi"]
    out = _one_launch_by(ops.launches_by_path["lora_dual_multi"],
                         ops.lora_multi_path(dtype, M, K, N),
                         lambda: ops.lora_dual_multi(x, idx, w, a, b, 0.5))
    again = ops.lora_dual_multi(x, idx, w, a, b, 0.5)
    torch.cuda.synchronize()
    assert ops.launches["lora_dual_multi"] == before + 2
    assert out.shape == (M, 1, N) and out.dtype == dtype
    assert torch.equal(out, again)
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
    # a page outside [0, P) reads nothing and comes back NaN, on both routes
    bad = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)
    for xw, route in (((x, w), "simt"), ((x.bfloat16(), w.bfloat16()), "stream")):
        out = _one_launch_by(ops.launches_by_path["lora_dual_multi"], route,
                             lambda xw=xw: ops.lora_dual_multi(*xw[:1], bad, xw[1], a, b))
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
    store = SyntheticAdapterStore(cfg, seed=0, device="cpu")

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
