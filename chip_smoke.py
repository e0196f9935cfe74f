#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``), one H100.

    python3 chip_smoke.py                 # every phase, as a check
    python3 chip_smoke.py --only kernels  # one phase while iterating

Phases, in order (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch's name
  2. build    nvcc builds every CUDA source of the path for sm_90a, in
              parallel; prints each kernel's registers, shared memory and
              spills (-Xptxas -v)
  3. kernels  each of the five kernels against its plain PyTorch version on
              the card at the main path's shapes (roberta-large, llama2-7b)
              and one long shape, T in {1, 8}, with and without an input
              tangent (and odd M/N/K for the LoRA contraction), window in
              {None, 256}, KV in {H, H/4}; fp32 (rtol 1e-4, atol 1e-5 x
              max|plain|: sums run in another order) and bf16 (the kernel's
              bf16 output against the plain version run in fp32 on the same
              bf16-valued inputs, rtol = atol = 2e-2). The two contraction
              epilogues return sums of n products, held against 1e-6 x
              sum|terms| in both dtypes (the kernel reads bf16 exactly into
              the same fp32 sums as fp32; a typical contraction is about
              sum|terms| / sqrt(n), so a wrong or dropped term fails), and
              print err / sum|terms| as ``err_over_terms``. Times the
              kernel, the plain version and either one PyTorch call that
              computes the same function (library_ms) or, where none does,
              a yardstick (yardstick_ms: the kernel's largest GEMM; for the
              attention epilogue, the multi-tangent kernel followed by the
              contraction) (CUDA events), and computes each case's bound
              from its shapes
  4. parity   one reduced-roberta SPRY round on the card (kernels) against
              the same round on the CPU (plain versions) with the same
              weights, batch and perturbations, on the standard and on the
              fused-contraction route
  5. site     the single-projection LoRA estimator (a ``SplitLoss`` of kind
              'lora', through ``forward_gradient``) at roberta-large and
              llama2-7b widths, K=8, with and without an input tangent:
              exactly one LoRA contraction epilogue an estimate
  6. train    ``repro_torch.launch.train.run_training`` at full published
              width and depth: roberta-large-lora on sst2, 4 clients (spry K=1,
              spry K=8, spry_periter K=8 on the standard route; spry K=8 and
              spry_periter K=8 on the fused route; fedfgd K=8; 2 rounds each;
              fedavg, fedyogi, fedsgd, fedavgsplit, fedmezo, baffle, fwdllm,
              1 round each) and llama2-7b, 2 clients (spry K=4 on both routes
              and fedavg, 1 round each). Every launch counter is zeroed just
              before and read just after each run; a round must launch
              exactly one multi-tangent kernel per site and estimate on the
              standard route, L-1 attention ones plus ONE attention
              contraction epilogue per estimate on the fused route, and no
              kernel at all on the backprop and zero-order rounds. Prints
              each run's loss, test accuracy, seconds per round and peak
              device memory of a round (weights included, model init
              excluded), and SPRY's and FedAvg's llama2-7b round peaks side
              by side.
Every kernel must have launched over phases 5 and 6 (the main path). The
line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s

# TPU kernels the port's kernels replace (file:line of the pallas_call entry)
REPLACES = {
    "lora_dual_mt": "src/repro/kernels/lora_dual/kernel.py:92",
    "swa_attention": "src/repro/kernels/swa_attention/kernel.py:140",
    "swa_attention_mt": "src/repro/kernels/swa_attention/kernel.py:365",
    "swa_attention_mt_jvps": "src/repro/kernels/swa_attention/kernel.py:313",
    "lora_dual_mt_jvps": "src/repro/kernels/lora_dual/kernel.py:225",
}
SOURCES = {
    "lora_dual_mt": "src/repro_torch/csrc/lora_dual_mt.cu",
    "swa_attention": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt_jvps": "src/repro_torch/csrc/swa_attention.cu",
    "lora_dual_mt_jvps": "src/repro_torch/csrc/lora_dual_mt.cu",
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events), after
    ``warmup`` calls; ``iters`` shrinks (to >= 3) so a slow case stays near
    0.3 s."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup
    iters = max(3, min(iters, int(0.3 / max(per_call, 1e-9))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, dtype):
    import torch
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _f32(args):
    import torch
    return tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)


def close(name, got, want, dtype):
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    # fp32: sums of up to 4096 products run in another order than the plain
    # version's, so the absolute tolerance scales with the output's size
    scale = float(want.abs().max())
    rtol, atol = ((1e-4, 1e-5 * max(scale, 1.0)) if dtype == torch.float32
                  else (2e-2, 2e-2))
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err:.3e} "
                             f"beyond rtol {rtol} atol {atol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def lora_case(M, K, N, r, T, has_xd, dtype, gen, timed):
    import torch
    from repro_torch.kernels.lora_dual import ops
    dev = "cuda"
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    x = rn(M, K).to(dtype)
    xd = rn(T, M, K).to(dtype) if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, ad = rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K)
    b, bd = rn(r, N), rn(T, r, N)
    args = (x, xd, w, a, ad, b, bd, 1.0)
    out = ops.lora_dual_mt_tangents(*args)
    ref = ops.lora_dual_mt_tangents_ref(*_f32(args))
    torch.cuda.synchronize()
    name = f"lora_dual_mt M={M} K={K} N={N} r={r} T={T} xd={has_xd} {dtype}"
    res = {"max_abs_err": close(name, out, ref, dtype)}
    if timed:
        es = x.element_size()
        flops = (2 * T * M * K * N * has_xd + 2 * M * K * r * (1 + T * (1 + has_xd))
                 + 4 * T * M * r * N)
        nbytes = (es * (M * K * (1 + T * has_xd) + has_xd * K * N + T * M * N)
                  + 4 * (K * r + r * N) * (1 + T))
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(lambda: ops.lora_dual_mt_tangents(*args))
        res["plain_ms"] = time_ms(lambda: ops.lora_dual_mt_tangents_ref(*args))
        # no one PyTorch call computes this function; the batched GEMM
        # xdot_t @ W alone is timed as a yardstick
        res["library_ms"] = None
        res["yardstick_ms"] = (time_ms(lambda: torch.matmul(xd, w)) if has_xd
                               else None)
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


JVPS_RTOL = 1e-6


def close_jvps(name, got, want, mag):
    """A contraction of n products against its plain version, both summed in
    fp32 whatever the inputs' dtype: |err| <= JVPS_RTOL * sum|terms| (``mag``,
    per tangent). Returns (max |err|, max |err| / sum|terms|)."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    if not bool((err <= JVPS_RTOL * mag).all()):
        raise AssertionError(f"{name}: kernel vs plain |err| {err.tolist()} beyond "
                             f"{JVPS_RTOL} x sum|terms| {mag.tolist()}")
    return float(err.max()), float((err / mag).max())


def lora_jvps_case(M, K, N, r, T, has_xd, dtype, gen, timed):
    import torch
    from repro_torch.kernels.lora_dual import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x = rn(M, K).to(dtype)
    xd = rn(T, M, K).to(dtype) if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, ad = rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K)
    b, bd = rn(r, N), rn(T, r, N)
    gy = rn(M, N).to(dtype)
    args = (x, w, a, ad, b, bd, gy, 1.0, xd)
    got = ops.lora_dual_mt_jvps(*args)
    want = ops.lora_dual_mt_jvps_ref(*_f32(args))
    yd = ops.lora_dual_mt_tangents_ref(*_f32((x, xd, w, a, ad, b, bd, 1.0)))
    mag = (gy.float()[None] * yd.float()).abs().sum(dim=(1, 2))
    torch.cuda.synchronize()
    name = f"lora_dual_mt_jvps M={M} K={K} N={N} r={r} T={T} xd={has_xd} {dtype}"
    err, rel = close_jvps(name, got, want, mag)
    res = {"max_abs_err": err, "err_over_terms": rel}
    if timed:
        es = x.element_size()
        flops = (2 * M * K * r + 2 * M * N * r * 2 + 2 * T * M * K * r * (1 + has_xd)
                 + 2 * T * (M * r + r * N) + has_xd * (2 * M * N * K + 2 * T * M * K))
        nbytes = (es * (M * K * (1 + T * has_xd) + has_xd * K * N + M * N)
                  + 4 * (K * r + r * N) * (1 + T) + 4 * T)
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(lambda: ops.lora_dual_mt_jvps(*args))
        res["plain_ms"] = time_ms(lambda: ops.lora_dual_mt_jvps_ref(*args))
        # no one PyTorch call computes this function; its frozen-W product
        # gy @ W^T alone is timed as a yardstick
        res["library_ms"] = None
        res["yardstick_ms"] = time_ms(lambda: torch.matmul(gy, w.T))
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


def swa_jvps_case(B, H, KV, S, hd, window, T, dtype, gen, timed):
    import torch
    from repro_torch.kernels.swa_attention import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
    gy = rn(B, H, S, hd)
    args = (q, k, v, qd, kd, vd, gy, window)
    got = ops.swa_attention_mt_jvps(*args)
    od = ops.swa_attention_mt_tangents_ref(*_f32(args[:6]), window)
    want = torch.einsum("bhsd,tbhsd->t", gy.float(), od)
    mag = (gy.float()[None] * od).abs().sum(dim=(1, 2, 3, 4))
    del od
    torch.cuda.synchronize()
    name = (f"swa_attention_mt_jvps B={B} H={H} KV={KV} S={S} hd={hd} "
            f"window={window} T={T} {dtype}")
    err, rel = close_jvps(name, got, want, mag)
    res = {"max_abs_err": err, "err_over_terms": rel}
    if timed:
        es = q.element_size()
        pairs = B * H * _kept_pairs(S, window)
        flops = 4 * hd * pairs + 8 * hd * T * pairs + 2 * T * B * H * S * hd
        nbytes = es * (B * H * S * hd * (2 + T) + 2 * B * KV * S * hd * (1 + T)) + 4 * T
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(lambda: ops.swa_attention_mt_jvps(*args))
        res["plain_ms"] = time_ms(lambda: ops.swa_attention_mt_jvps_ref(*args))
        # no one PyTorch call computes this function; the multi-tangent
        # kernel followed by the contraction (the route it replaces) is
        # timed as a yardstick
        res["library_ms"] = None
        res["yardstick_ms"] = time_ms(lambda: torch.einsum(
            "bhsd,tbhsd->t", gy.float(),
            ops.swa_attention_mt_tangents(*args[:6], window).float()))
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


def _kept_pairs(S, window):
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


def swa_case(B, H, KV, S, hd, window, T, dtype, gen, timed):
    """T=0 checks the primal kernel, T>0 the multi-tangent kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd)
    if T:
        qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
        args = (q, k, v, qd, kd, vd, window)
        kernel, ref_fn = ops.swa_attention_mt_tangents, ops.swa_attention_mt_tangents_ref
        kname = "swa_attention_mt"
    else:
        args = (q, k, v, window)
        kernel, ref_fn = ops.swa_attention, ops.swa_attention_ref
        kname = "swa_attention"
    run = lambda: kernel(*args)  # noqa: E731
    plain = lambda: ref_fn(*args)  # noqa: E731
    out, ref = run(), ref_fn(*_f32(args))
    torch.cuda.synchronize()
    name = f"{kname} B={B} H={H} KV={KV} S={S} hd={hd} window={window} T={T} {dtype}"
    res = {"max_abs_err": close(name, out, ref, dtype)}
    if timed:
        es = q.element_size()
        pairs = B * H * _kept_pairs(S, window)
        flops = 4 * hd * pairs + 8 * hd * T * pairs
        nbytes = es * (B * H * S * hd * (1 + 2 * T) + 2 * B * KV * S * hd * (1 + T))
        if not T:
            nbytes = es * (2 * B * H * S * hd + 2 * B * KV * S * hd)
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(run)
        res["plain_ms"] = time_ms(plain)
        kr = k.repeat_interleave(H // KV, dim=1)
        vr = v.repeat_interleave(H // KV, dim=1)
        if T:
            # no one PyTorch call computes the tangents; the batched score
            # GEMM qdot_t @ k^T alone is timed as a yardstick
            res["library_ms"] = None
            res["yardstick_ms"] = time_ms(lambda: torch.matmul(qd, kr.transpose(-1, -2)))
        elif window is None:
            res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True))
        else:
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask))
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


def phase_kernels():
    """Every case; returns the timed main-path case of each kernel
    (roberta-large shapes in bf16, the full-size dtype, T=8)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main, worst = {}, {}

    def note(name, dtype, res):         # the largest err / sum|terms| seen
        key = f"{name} {dtype}"
        worst[key] = max(worst.get(key, 0.0), res["err_over_terms"])
        return res

    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for K in (1024, 4096):              # roberta-large, llama2-7b widths
            for T in (1, 8):
                for has_xd in (True, False):
                    res = lora_case(8 * 32, K, K, 1, T, has_xd, dtype, gen,
                                    timed=(bf and T == 8))
                    if bf and K == 1024 and T == 8 and has_xd:
                        main["lora_dual_mt"] = res
                    res = note("lora_dual_mt_jvps", dtype, lora_jvps_case(
                        8 * 32, K, K, 1, T, has_xd, dtype, gen, timed=(bf and T == 8)))
                    if bf and K == 1024 and T == 8 and has_xd:
                        main["lora_dual_mt_jvps"] = res
        for T in (1, 8):                    # odd M, N, K and rank
            for has_xd in (True, False):
                note("lora_dual_mt_jvps", dtype, lora_jvps_case(
                    37, 100, 72, 3, T, has_xd, dtype, gen, timed=False))
        note("lora_dual_mt_jvps", dtype, lora_jvps_case(   # rank, tangent limits
            70, 33, 65, 16, 64, True, dtype, gen, timed=False))
        shapes = [(8, 16, 32, 64), (8, 32, 32, 128), (1, 16, 2048, 128)]
        for si, (B, H, S, hd) in enumerate(shapes):
            for window in (None, 256):
                for KV in (H, H // 4):
                    for T in (0, 1, 8):
                        timed = bf and T != 1
                        res = swa_case(B, H, KV, S, hd, window, T, dtype, gen, timed)
                        if bf and si == 0 and window is None and KV == H:
                            if T == 0:
                                main["swa_attention"] = res
                            elif T == 8:
                                main["swa_attention_mt"] = res
                        if T:
                            res = note("swa_attention_mt_jvps", dtype, swa_jvps_case(
                                B, H, KV, S, hd, window, T, dtype, gen, timed))
                            if bf and si == 0 and window is None and KV == H and T == 8:
                                main["swa_attention_mt_jvps"] = res
    log(f"[kernels] contraction epilogues, largest err / sum|terms| (limit "
        f"{JVPS_RTOL}): " + json.dumps(worst))
    return main


# ---------------------------------------------------------------------------
# phase 4: one reduced round, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def phase_parity(fused):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import init_state, make_round_step, stacked_perturbations
    from repro_torch.models import get_model
    from repro_torch.peft import init_peft
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = dataclasses.replace(reduce_config(get_config("roberta-large-lora")),
                              n_classes=2)
    K, M = 4, 2
    sc = SpryConfig(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
                    server_lr=1e-2, seed=0, fused_contraction=fused)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, sc)
    peft["layers"]["wq"]["B"] = torch.randn(peft["layers"]["wq"]["B"].shape,
                                            generator=gen) * 0.1
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (M, 4, 32))),
             "labels": torch.as_tensor(rng.integers(0, 2, (M, 4)))}
    perts = [[stacked_perturbations(1000 + m, peft, list(range(K)))] for m in range(M)]
    step = make_round_step(cfg, sc)
    cpu_state, cpu_met = step(init_state(base, peft), batch, perts)
    to_cuda = lambda t: tree_map(lambda x: x.cuda(), t)  # noqa: E731
    gpu_state, gpu_met = step(init_state(to_cuda(base), to_cuda(peft)),
                              to_cuda(batch), [[to_cuda(p[0])] for p in perts])
    torch.cuda.synchronize()
    jv_err = float((gpu_met["jvps"].cpu() - cpu_met["jvps"]).abs().max()
                   / cpu_met["jvps"].abs().max())
    p_err = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for g, c in zip(tree_leaves(gpu_state.peft), tree_leaves(cpu_state.peft)))
    res = {"loss_gpu": float(gpu_met["loss"]), "loss_cpu": float(cpu_met["loss"]),
           "jvps_rel_err": jv_err, "peft_rel_err": p_err}
    route = "fused" if fused else "standard"
    log(f"[parity] reduced roberta, 1 spry round K=4, {route} route, card vs cpu: "
        + json.dumps(res))
    if not (jv_err <= 1e-4 and p_err <= 1e-4 and
            abs(res["loss_gpu"] - res["loss_cpu"]) <= 1e-5 * abs(res["loss_cpu"])):
        raise AssertionError(f"parity ({route}): card round disagrees with cpu round {res}")


# ---------------------------------------------------------------------------
# phase 5: the single-projection LoRA estimator (SplitLoss kind 'lora')
# ---------------------------------------------------------------------------

def phase_site(totals):
    """forward_gradient on a LoRA site at full widths, K=8: the fused route
    makes one LoRA contraction epilogue an estimate (plus, with an input
    tangent, the upstream projection's one multi-tangent launch) and agrees
    with the standard route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SplitLoss, forward_gradient
    from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    for arch in ("roberta-large-lora", "llama2-7b"):
        d = get_config(arch).d_model
        x0 = (rn(8 * 32, d) * 0.3).bfloat16()
        w0, w1 = ((rn(d, d) / math.sqrt(d)).bfloat16() for _ in range(2))
        for x_has_tangent in (False, True):
            peft = {"A1": rn(d, 1) / math.sqrt(d), "B1": rn(1, d) * 0.1}
            if x_has_tangent:
                peft.update({"A0": rn(d, 1) / math.sqrt(d), "B0": rn(1, d) * 0.1})

            def pre(p, xt=x_has_tangent):
                x = dispatch.lora_proj(x0, w0, p["A0"], p["B0"], 1.0) if xt else x0
                return (x, w1, p["A1"], p["B1"]), None
            split = SplitLoss(pre, "lora", lambda y, ctx, p: (y.float() ** 2).mean(),
                              x_has_tangent=x_has_tangent)
            reset_launch_counts()
            loss, _, jvps = forward_gradient(split, peft, 7, 8, fused_contraction=True)
            torch.cuda.synchronize()
            counts = launch_counts()
            _, _, jvps_std = forward_gradient(split, peft, 7, 8)
            want = {k: 0 for k in counts}
            want.update({"lora_dual_mt_jvps": 1, "lora_dual_mt": int(x_has_tangent)})
            err = float((jvps - jvps_std).abs().max() / jvps_std.abs().max())
            res = {"arch": arch, "x_has_tangent": x_has_tangent, "loss": float(loss),
                   "jvps_rel_err_vs_standard": err, "launches": counts}
            log("[site] lora SplitLoss K=8: " + json.dumps(res))
            if counts != want:
                raise AssertionError(f"site {arch}: launches {counts} != {want}")
            # the standard route rounds each tangent output to bf16 before
            # contracting it; the epilogue contracts in fp32
            if not (math.isfinite(float(loss)) and err <= 2e-2):
                raise AssertionError(f"site {arch}: fused vs standard jvps {err}")
            for k, n in counts.items():
                totals[k] += n


# ---------------------------------------------------------------------------
# phase 6: full-size training through the entry point
# ---------------------------------------------------------------------------

def round_launches(kind, L, estimates):
    """The launches one round must make: per estimate, one multi-tangent
    kernel per site on the standard route; L-1 attention ones and one
    attention contraction epilogue on the fused route; none by reverse mode
    or by the zero-order clients."""
    want = {"lora_dual_mt": 0, "lora_dual_mt_jvps": 0, "swa_attention": 0,
            "swa_attention_mt": 0, "swa_attention_mt_jvps": 0}
    if kind in ("standard", "fused"):
        want.update({"lora_dual_mt": estimates * 2 * L,       # wq, wv per layer
                     "swa_attention": estimates * L,
                     "swa_attention_mt": estimates * (L - (kind == "fused")),
                     "swa_attention_mt_jvps": estimates * (kind == "fused")})
    return want


def phase_train(phases, totals):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run_training

    results = []
    for arch, method, K, rounds, clients, fused in phases:
        L = get_config(arch).n_layers
        reset_launch_counts()
        hist = run_training(arch=arch, task="sst2", method=method, rounds=rounds,
                            clients_per_round=clients, batch_size=8,
                            k_perturbations=K, eval_every=1, reduced=False,
                            fused_contraction=fused, device="cuda",
                            log=lambda s: log("  " + s))
        torch.cuda.synchronize()
        counts = launch_counts()
        # the route each round reported; the launch counts below hold the
        # entry point to it, and it must be the route that was asked for
        routes = [h.get("route", "none") for h in hist]
        asked = ("fused" if fused else "standard") if method in (
            "spry", "spry_periter", "fedfgd") else "none"
        if routes != [asked] * len(hist):
            raise AssertionError(f"train {arch} {method}: rounds reported routes "
                                 f"{routes}, asked for {asked}")
        kind = routes[-1]
        res = {"arch": arch, "method": method, "K": K, "clients": clients,
               "route": kind, "loss": [h["loss"] for h in hist],
               "test_acc": [h["acc"] for h in hist],
               "round_s": [h["round_s"] for h in hist],
               "personalized_acc": hist[-1]["personalized_acc"],
               "round_peak_GiB": max(h["round_peak_bytes"] for h in hist) / 2 ** 30,
               "launches": counts, "round_launches": [h["launches"] for h in hist]}
        log(f"[train] {arch} {method} K={K} {kind}: " + json.dumps(res))
        if not all(math.isfinite(x) for x in res["loss"]):
            raise AssertionError(f"train {arch} {method}: loss not finite")
        for route, rl in zip(routes, res["round_launches"]):
            want = round_launches(route, L, clients)   # one estimate a client
            if rl != want:
                raise AssertionError(f"train {arch} {method} K={K} {kind}: round "
                                     f"launches {rl} != {want}")
        for k, n in counts.items():
            totals[k] += n
        results.append(res)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test of repro_torch")
    ap.add_argument("--only", choices=("kernels", "parity", "train"), default=None,
                    help="run one phase; 'train' covers the site and train phases")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    from repro_torch.kernels import build
    tb = time.time()
    build.build()
    log(f"[build] {len(build.SOURCES)} CUDA sources built in {time.time() - tb:.1f}s")
    for name, text in build.ptxas_logs.items():
        for line in text.splitlines():
            if any(s in line for s in ("Compiling entry", "registers", "spill")):
                log(f"[build] {name}: {line.strip()}")

    main_cases = phase_kernels() if args.only in (None, "kernels") else {}
    if args.only in (None, "parity"):
        phase_parity(fused=False)
        phase_parity(fused=True)
    from repro_torch.kernels import launch_counts
    totals = {k: 0 for k in launch_counts()}
    if args.only in (None, "train"):
        phase_site(totals)
        rb, ll = "roberta-large-lora", "llama2-7b"
        results = phase_train(
            [(rb, "spry", 1, 2, 4, False), (rb, "spry", 8, 2, 4, False),
             (rb, "spry_periter", 8, 2, 4, False),
             (rb, "spry", 8, 2, 4, True), (rb, "spry_periter", 8, 2, 4, True),
             (rb, "fedfgd", 8, 2, 4, False)]
            + [(rb, m, 1, 1, 4, False) for m in ("fedavg", "fedyogi", "fedsgd",
                                                 "fedavgsplit", "fedmezo", "baffle",
                                                 "fwdllm")]
            + [(ll, "spry", 4, 1, 2, False), (ll, "spry", 4, 1, 2, True),
               (ll, "fedavg", 1, 1, 2, False)], totals)
        peak = {f"{r['method']}_{r['route']}": r["round_peak_GiB"]
                for r in results if r["arch"] == ll}
        log("[train] llama2-7b peak device memory GiB (2 clients, batch 8 x 32 "
            "tokens, one round): " + json.dumps(peak))
        missing = [k for k, n in totals.items() if n == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
    log(f"[done] {time.time() - t0:.1f}s")
    kernels = []
    for name in ("lora_dual_mt", "swa_attention", "swa_attention_mt",
                 "swa_attention_mt_jvps", "lora_dual_mt_jvps"):
        c = main_cases.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": totals.get(name, 0),
                        "max_abs_err": c.get("max_abs_err"), "ms": c.get("ms"),
                        "plain_ms": c.get("plain_ms"), "bound_ms": c.get("bound_ms"),
                        "bound_by": c.get("bound_by"),
                        "library_ms": c.get("library_ms"),
                        "yardstick_ms": c.get("yardstick_ms")})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
