#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``), one H100.

    python3 chip_smoke.py                 # every phase, as a check
    python3 chip_smoke.py --only kernels  # one phase while iterating
                                          # (kernels|parity|train|serve)

Phases, in order (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch's name
  2. build    nvcc builds every CUDA source of the path for sm_90a, in
              parallel; prints each kernel's registers, shared memory and
              spills (-Xptxas -v)
  3. kernels  each of the nine kernels against its plain PyTorch version on
              the card at the main path's shapes (roberta-large, llama2-7b,
              zamba2) and one long shape. The multi-adapter projection at
              llama2-7b's engine decode (M=4, K=N=4096, P=4, r=1), a
              prefill-sized M=256 with random pages and a ragged case (M=5,
              K=1000, N=333, P=3, r=4, every page hit, with repeats), fp32
              and bf16 at the tolerances below. LoRA and attention: T in {1, 8},
              with and without an input tangent (and odd M/N/K for the LoRA
              contraction), window in {None, 256}, KV in {H, H/4}; fp32
              (rtol 1e-4, atol 1e-5 x max|plain|: sums run in another order)
              and bf16 (the kernel's bf16 output against the plain version
              run in fp32 on the same bf16-valued inputs, rtol = atol =
              2e-2). The mamba2 recurrence (fp32 only, as the reference's
              kernels): zamba2's shapes (B=8, S=32, H=64, hd=N=64), a ragged
              shape and N=100, T in {1, 8, 64}; a T=8 launch must equal eight
              T=1 launches bit for bit (tangents and contraction) and two
              contraction launches must agree bit for bit. The three
              contraction epilogues return sums of n products, held against
              1e-6 x sum|terms| in every dtype (the kernel reads bf16 exactly
              into the same fp32 sums as fp32; a typical contraction is about
              sum|terms| / sqrt(n), so a wrong or dropped term fails), and
              print err / sum|terms| as ``err_over_terms``. Times the
              kernel, the plain version and either one PyTorch call that
              computes the same function (library_ms) or, where none does,
              a yardstick (yardstick_ms: the kernel's largest GEMM, for the
              recurrence the batched GEMM of its quadratic form; for the
              contraction epilogues, the multi-tangent kernel followed by
              the contraction) (CUDA events), and computes each case's bound
              from its shapes
  4. parity   one reduced SPRY round on the card (kernels) against the same
              round on the CPU (plain versions) with the same weights, batch
              and perturbations, on the standard and on the fused-contraction
              route: roberta, zamba2 with n_layers=3, hybrid_attn_every=2
              (final site mamba2) and reduced zamba2 (final site attention);
              loss and jvps within 1e-5 relative; the new PEFT within 1e-5
              of the CPU round replayed with the card's jvps (aggregation and
              server step) and end to end within PEFT_RTOL, set per config
              from its readings (1e-5 roberta, 3e-5 zamba2)
  5. site     the single-projection LoRA estimator (a ``SplitLoss`` of kind
              'lora', through ``forward_gradient``) at roberta-large and
              llama2-7b widths, K=8, with and without an input tangent:
              exactly one LoRA contraction epilogue an estimate
  6. train    ``repro_torch.launch.train.run_training`` at full published
              width and depth: roberta-large-lora on sst2, 4 clients (spry K=1,
              spry K=8, spry_periter K=8 on the standard route; spry K=8 and
              spry_periter K=8 on the fused route; fedfgd K=8; 2 rounds each;
              fedavg, fedyogi, fedsgd, fedavgsplit, fedmezo, baffle, fwdllm,
              1 round each), llama2-7b, 2 clients (spry K=4 on both routes
              and fedavg, 1 round each) and zamba2-1.2b, 4 clients (spry K=8
              on the standard route, 2 rounds; spry K=8 and spry_periter K=8
              on the fused route and fedavg, 1 round each). Every launch
              counter is zeroed just before and read just after each run; a
              round must make exactly the launches ``round_launches`` derives
              from the config (per estimate one primal and one multi-tangent
              kernel per mixer site and one LoRA kernel per adapted
              projection on the standard route; on the fused route the final
              site's tangent kernel replaced by ONE contraction epilogue), and
              no kernel at all on the backprop and zero-order rounds. Prints
              each run's loss, test accuracy, seconds per round and peak
              device memory of a round (weights included, model init
              excluded), and SPRY's and FedAvg's round peaks side by side for
              llama2-7b and zamba2.
  7. serve    reduced llama2 (fp32) through the ``ServingEngine`` on the card
              and on the CPU, the same weights, adapters and requests (5
              requests over 3 adapters, max_batch 2, capacity 2: admissions
              mid-flight and an eviction): every decode step's logits within
              SERVE_RTOL, equal ids, the smallest top-2 logit margin printed.
              Then llama2-7b at full width and depth in bf16 through
              ``launch/serve.py``: ``run_engine`` (8 requests on 6 adapters,
              max_batch 4, capacity 4, P=16, 32 new tokens) must make exactly
              ``serve_launches`` (2 L multi-adapter launches a decode step),
              each request's first decode-step logits held against its own
              B=1 greedy run (the plain single-adapter primal) at the bf16
              tolerance, the count of id sequences equal to greedy's printed;
              ``greedy_generate`` (B=4, P=16, 32 steps) must launch nothing.
              Prints end-to-end and steady-state decode tokens/s, decode
              steps, the adapter cache's stats and peak device memory.
Every kernel must have launched over phases 5, 6 and 7 (the main path). The
line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
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
    "mamba2_scan": "src/repro/kernels/mamba2_scan/kernel.py:55",
    "mamba2_scan_mt": "src/repro/kernels/mamba2_scan/kernel.py:222",
    "mamba2_scan_mt_jvps": "src/repro/kernels/mamba2_scan/kernel.py:177",
    "lora_dual_multi": "src/repro/kernels/lora_dual/kernel.py:320",
}
SOURCES = {
    "lora_dual_mt": "src/repro_torch/csrc/lora_dual_mt.cu",
    "swa_attention": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt_jvps": "src/repro_torch/csrc/swa_attention.cu",
    "lora_dual_mt_jvps": "src/repro_torch/csrc/lora_dual_mt.cu",
    "mamba2_scan": "src/repro_torch/csrc/mamba2_scan.cu",
    "mamba2_scan_mt": "src/repro_torch/csrc/mamba2_scan.cu",
    "mamba2_scan_mt_jvps": "src/repro_torch/csrc/mamba2_scan.cu",
    "lora_dual_multi": "src/repro_torch/csrc/lora_dual_multi.cu",
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


def mamba2_inputs(B, S, H, hd, N, T, gen):
    """Recurrence operands at the model's scales: decay in (0, 1)."""
    import torch
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    prim = (rn(B, S, H, hd) * 0.3, rn(B, S, N) * 0.3, rn(B, S, N) * 0.3,
            torch.sigmoid(rn(B, S, H)))
    tang = (rn(T, B, S, H, hd) * 0.3, rn(T, B, S, N) * 0.3, rn(T, B, S, N) * 0.3,
            rn(T, B, S, H) * 0.1)
    return prim, tang, rn(B, S, H, hd)


def mamba2_cases(B, S, H, hd, N, T, gen, timed):
    """The three mamba2 kernels on one problem (fp32, their only dtype):
    primal and tangents against the plain versions (``close``), the
    contraction against JVPS_RTOL x sum|terms|. Returns {kernel: result}."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = mamba2_inputs(B, S, H, hd, N, T, gen)
    shape = f"B={B} S={S} H={H} hd={hd} N={N}"
    out = {}
    y = ops.mamba2_scan(*prim)
    y_ref, yd_ref = ops.mamba2_scan_mt_ref(*prim, *tang)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    jv_ref = torch.einsum("bshd,tbshd->t", gy, yd_ref)
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    torch.cuda.synchronize()
    out["mamba2_scan"] = {"max_abs_err": close(f"mamba2_scan {shape}", y, y_ref,
                                               torch.float32)}
    out["mamba2_scan_mt"] = {"max_abs_err": close(
        f"mamba2_scan_mt {shape} T={T}", yd, yd_ref, torch.float32)}
    err, rel = close_jvps(f"mamba2_scan_mt_jvps {shape} T={T}", jv, jv_ref, mag)
    out["mamba2_scan_mt_jvps"] = {"max_abs_err": err, "err_over_terms": rel}
    del yd_ref
    if timed:
        el = B * S * H * hd * N            # state elements walked a token
        prim_bytes = 4 * (2 * B * S * H * hd + 2 * B * S * N + B * S * H)
        tang_bytes = 4 * T * (2 * B * S * H * hd + 2 * B * S * N + B * S * H)
        # the primal walk: 3 flops an element for the state update, 2 for
        # the readout y = h C, which the tangent modes do not emit
        costs = {"mamba2_scan": (5 * el, prim_bytes),
                 "mamba2_scan_mt": (3 * el + 11 * T * el,
                                    prim_bytes - 4 * B * S * H * hd + tang_bytes),
                 "mamba2_scan_mt_jvps": (3 * el + 11 * T * el + 2 * T * B * S * H * hd,
                                         prim_bytes + tang_bytes
                                         - 4 * T * B * S * H * hd + 4 * T)}
        runs = {"mamba2_scan": (lambda: ops.mamba2_scan(*prim),
                                lambda: ops.mamba2_scan_ref(*prim)),
                "mamba2_scan_mt": (lambda: ops.mamba2_scan_mt_tangents(*prim, *tang),
                                   lambda: ops.mamba2_scan_mt_ref(*prim, *tang)),
                "mamba2_scan_mt_jvps": (
                    lambda: ops.mamba2_scan_mt_jvps(*prim, *tang, gy),
                    lambda: ops.mamba2_scan_mt_jvps_ref(*prim, *tang, gy))}
        # no one PyTorch call computes a linear recurrence; the yardstick is
        # the batched GEMM of its quadratic (SSD) form, (S x S) scores times
        # x, per head (and tangent); for the contraction, the multi-tangent
        # kernel followed by the contraction (the route it replaces)
        g = torch.randn((B * H, S, S), generator=gen, device="cuda")
        xb = prim[0].permute(0, 2, 1, 3).reshape(B * H, S, hd).contiguous()
        gt, xt = g.expand(T, -1, -1, -1), xb.expand(T, -1, -1, -1)
        yard = {"mamba2_scan": lambda: torch.matmul(g, xb),
                "mamba2_scan_mt": lambda: torch.matmul(gt, xt),
                "mamba2_scan_mt_jvps": lambda: torch.einsum(
                    "bshd,tbshd->t", gy, ops.mamba2_scan_mt_tangents(*prim, *tang))}
        for name, (flops, nbytes) in costs.items():
            res = out[name]
            res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, torch.float32)
            res["ms"] = time_ms(runs[name][0])
            res["plain_ms"] = time_ms(runs[name][1], iters=3, warmup=1)
            res["library_ms"] = None
            res["yardstick_ms"] = time_ms(yard[name])
    for name, res in out.items():
        log(f"[kernels] {name} {shape} T={T}: " + json.dumps(res))
    return out


def mamba2_lanes_and_repeats(B, S, H, hd, N, gen):
    """A T=8 launch against eight T=1 launches, bit for bit, for the
    tangents and the contraction; two contraction launches on the same
    inputs give the same jvps."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = mamba2_inputs(B, S, H, hd, N, 8, gen)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    jv = ops.mamba2_scan_mt_jvps(*prim, *tang, gy)
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in tang)
        if not torch.equal(ops.mamba2_scan_mt_tangents(*prim, *one)[0], yd[t]):
            raise AssertionError(f"mamba2_scan_mt: tangent {t} of a T=8 launch is "
                                 f"not bitwise its T=1 launch")
        if not torch.equal(ops.mamba2_scan_mt_jvps(*prim, *one, gy)[0], jv[t]):
            raise AssertionError(f"mamba2_scan_mt_jvps: tangent {t} of a T=8 launch "
                                 f"is not bitwise its T=1 launch")
    if not torch.equal(ops.mamba2_scan_mt_jvps(*prim, *tang, gy), jv):
        raise AssertionError("mamba2_scan_mt_jvps: two launches on the same "
                             "inputs differ")
    log(f"[kernels] mamba2 B={B} S={S} H={H} hd={hd} N={N}: T=8 lanes bitwise "
        f"equal to T=1 launches (tangents and jvps), jvps repeat bitwise")


def lora_multi_case(M, K, N, P, r, dtype, gen, timed):
    """The multi-adapter projection: idx covers every page (with repeats when
    M > P), then random pages."""
    import torch
    from repro_torch.kernels.lora_dual import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x = rn(M, K).to(dtype)
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, b = rn(P, K, r) / math.sqrt(K), rn(P, r, N)
    head = torch.arange(min(P, M), device="cuda")
    idx = torch.cat([head, torch.randint(0, P, (M - len(head),), generator=gen,
                                         device="cuda")]).to(torch.int32)
    out = ops.lora_dual_multi(x, idx, w, a, b, 0.5)
    ref = ops.lora_dual_multi_ref(x.float(), idx, w.float(), a, b, 0.5)
    torch.cuda.synchronize()
    name = f"lora_dual_multi M={M} K={K} N={N} P={P} r={r} {dtype}"
    res = {"max_abs_err": close(name, out, ref, dtype)}
    if timed:
        es = x.element_size()
        used = int(idx.unique().numel())        # pages this batch reads
        flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
        nbytes = es * (M * K + K * N + M * N) + 4 * M + 4 * used * (K * r + r * N)
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(lambda: ops.lora_dual_multi(x, idx, w, a, b, 0.5))
        res["plain_ms"] = time_ms(lambda: ops.lora_dual_multi_ref(x, idx, w, a, b, 0.5))
        # no one PyTorch call computes this function; its frozen-W GEMM
        # x @ W alone is timed as a yardstick
        res["library_ms"] = None
        res["yardstick_ms"] = time_ms(lambda: torch.matmul(x, w))
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


def phase_kernels():
    """Every case; returns the timed main-path case of each kernel
    (roberta-large shapes in bf16, the full-size dtype, T=8; for the
    multi-adapter projection llama2-7b's engine decode, M=4, in bf16)."""
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
    # the mamba2 recurrence (fp32 only): zamba2's shapes (one client estimate,
    # B=8, S=32, H=64, hd=N=64), a ragged shape (odd S; hd, N and B*H*hd not
    # multiples of 32 or of a block's 16 rows) and N > 64; T in {1, 8, 64}
    for (B, S, H, hd, N) in ((8, 32, 64, 64, 64), (3, 37, 5, 24, 20),
                             (2, 19, 3, 40, 100)):
        for T in (1, 8, 64):
            timed = (B, T) == (8, 8)
            res = mamba2_cases(B, S, H, hd, N, T, gen, timed)
            note("mamba2_scan_mt_jvps", torch.float32, res["mamba2_scan_mt_jvps"])
            if timed:
                main.update(res)
    mamba2_lanes_and_repeats(8, 32, 64, 64, 64, gen)
    mamba2_lanes_and_repeats(3, 37, 5, 24, 20, gen)
    # the multi-adapter projection: llama2-7b's engine decode (M = max_batch
    # 4, K = N = 4096, P = 4 pages, r = 1), a prefill-sized M with random
    # pages, and a ragged case whose rows hit every page with repeats
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for M, K, N, P, r in ((4, 4096, 4096, 4, 1), (256, 4096, 4096, 4, 1),
                              (5, 1000, 333, 3, 4)):
            res = lora_multi_case(M, K, N, P, r, dtype, gen, timed=True)
            if bf and M == 4:
                main["lora_dual_multi"] = res
    log(f"[kernels] contraction epilogues, largest err / sum|terms| (limit "
        f"{JVPS_RTOL}): " + json.dumps(worst))
    return main


# ---------------------------------------------------------------------------
# phase 4: one reduced round, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

PARITY_RTOL = 1e-5     # card vs CPU, fp32 throughout: loss, jvps, server step
# card vs CPU end to end, the new PEFT, per config (see parity_round): about
# twice the largest reading on the H100 (PERF.md, Findings: roberta 5.0e-6,
# zamba2 1.38e-5)
PEFT_RTOL = {"roberta-large-lora": 1e-5, "zamba2-1.2b": 3e-5}


def parity_round(fused, arch="roberta-large-lora", **overrides):
    """One reduced SPRY round, kernels on the card against plain versions on
    the CPU; ``overrides`` replace fields of the reduced config (zamba2 with
    ``n_layers=3, hybrid_attn_every=2`` ends in a mamba2 site). Returns the
    readings, checks nothing.

    The new PEFT is read in two parts: the CPU round replayed with the
    card's jvps against the card's PEFT (the aggregation and the server
    step), and the two rounds end to end. A zero-initialised LoRA B leaf
    holds only the first FedYogi step, which is linear in the gradient below
    |delta| ~ 1e-2 and turns a jvp difference of a few 1e-6 of max|jvp| into
    ~1e-5 of that leaf (PERF.md, Findings)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import init_state, make_round_step, stacked_perturbations
    from repro_torch.models import get_model
    from repro_torch.peft import init_peft
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

    cfg = dataclasses.replace(reduce_config(get_config(arch)), n_classes=2,
                              **overrides)
    K, M = 4, 2
    sc = SpryConfig(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
                    server_lr=1e-2, seed=0, fused_contraction=fused)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, sc)
    for group, t in (("layers", "wq"), ("layers", "in_proj"), ("shared", "wq")):
        if t in peft.get(group, {}):      # B = 0 at init: make the LoRA path live
            peft[group][t]["B"] = torch.randn(peft[group][t]["B"].shape,
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
    def peft_rel(got, want):
        """(largest relative error of a leaf, that leaf's path)."""
        return max((float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30)),
                    "/".join(path))
                   for g, (path, c) in zip(tree_leaves(got.peft),
                                           tree_paths(want.peft)))
    p_err, p_leaf = peft_rel(gpu_state, cpu_state)
    # the CPU round again, each client's estimate replaced by the card's jvps
    # combined with the same perturbations
    from repro_torch.core import spry as spry_mod
    from repro_torch.core.forward_grad import _combine
    card_jvps = iter(gpu_met["jvps"].cpu().reshape(-1, K))

    def replay(loss_fn, p, key, k_perturbations=1, mask_tree=None,
               perturbations=None, **_):
        jv = next(card_jvps)
        vs = stacked_perturbations(key, tree_map(lambda x: x.float(), p),
                                   list(range(K)), mask_tree, perturbations)
        return torch.zeros(()), _combine(jv, vs, K), jv
    real_fg, spry_mod.forward_gradient = spry_mod.forward_gradient, replay
    try:
        replayed, _ = step(init_state(base, peft), batch, perts)
    finally:
        spry_mod.forward_gradient = real_fg
    p_same = peft_rel(gpu_state, replayed)[0]
    from repro_torch.models import registry
    kind = registry.get_model(cfg).split_site(cfg)[0]
    return {"final_site": kind,
            "loss_gpu": float(gpu_met["loss"]), "loss_cpu": float(cpu_met["loss"]),
            "jvps_max_abs": float(cpu_met["jvps"].abs().max()),
            "jvps_rel_err": jv_err, "peft_rel_err_same_jvps": p_same,
            "peft_rel_err": p_err, "peft_worst_leaf": p_leaf}


def phase_parity(fused, arch="roberta-large-lora", **overrides):
    """``parity_round``, held to its limits: loss, jvps and the replayed PEFT
    within PARITY_RTOL, the end-to-end PEFT within the config's PEFT_RTOL."""
    res = parity_round(fused, arch, **overrides)
    route = "fused" if fused else "standard"
    peft_rtol = PEFT_RTOL[arch]
    log(f"[parity] reduced {arch} {overrides or ''} (final site {res['final_site']}), "
        f"1 spry round K=4, {route} route, card (kernels) vs cpu (limits "
        f"{PARITY_RTOL}, end-to-end PEFT {peft_rtol}): " + json.dumps(res))
    if not (res["jvps_rel_err"] <= PARITY_RTOL
            and res["peft_rel_err_same_jvps"] <= PARITY_RTOL
            and res["peft_rel_err"] <= peft_rtol
            and abs(res["loss_gpu"] - res["loss_cpu"]) <= PARITY_RTOL * abs(res["loss_cpu"])):
        raise AssertionError(f"parity ({arch}, {route}): card round disagrees with "
                             f"cpu round {res}")


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

KERNELS = ("lora_dual_mt", "swa_attention", "swa_attention_mt",
           "swa_attention_mt_jvps", "lora_dual_mt_jvps", "mamba2_scan",
           "mamba2_scan_mt", "mamba2_scan_mt_jvps", "lora_dual_multi")


def round_launches(cfg, kind, estimates):
    """The launches a round of ``estimates`` estimates must make on ``cfg``:
    per estimate, one primal and one multi-tangent kernel per mixer site and
    one multi-tangent LoRA kernel per adapted projection on the standard
    route. The fused route replaces the final site's tangent kernel by ONE
    contraction epilogue; at a mamba2 site the final layer's out_proj sits in
    the reversed post-head and launches nothing. Reverse mode and the
    zero-order clients launch no kernel."""
    want = dict.fromkeys(KERNELS, 0)
    if kind not in ("standard", "fused"):
        return want
    L = cfg.n_layers
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        sites = L // every                 # shared attention applications
        per = {"lora_dual_mt": 2 * L + 2 * sites,   # in_proj, out_proj; wq, wv
               "swa_attention": sites, "swa_attention_mt": sites,
               "mamba2_scan": L, "mamba2_scan_mt": L}
        final = "swa" if (L - 1) % every == every - 1 else "mamba2"
    else:
        per = {"lora_dual_mt": 2 * L,      # wq, wv per layer
               "swa_attention": L, "swa_attention_mt": L}
        final = "swa"
    if kind == "fused":
        if final == "swa":
            per["swa_attention_mt"] -= 1
            per["swa_attention_mt_jvps"] = 1
        else:
            per["mamba2_scan_mt"] -= 1
            per["mamba2_scan_mt_jvps"] = 1
            per["lora_dual_mt"] -= 1
    want.update({k: n * estimates for k, n in per.items()})
    return want


def phase_train(phases, totals):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run_training

    results = []
    for arch, method, K, rounds, clients, fused in phases:
        cfg = get_config(arch)
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
            want = round_launches(cfg, route, clients)   # one estimate a client
            if rl != want:
                raise AssertionError(f"train {arch} {method} K={K} {kind}: round "
                                     f"launches {rl} != {want}")
        for k, n in counts.items():
            totals[k] += n
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# phase 7: serving, reduced card-vs-CPU parity and full-size llama2-7b
# ---------------------------------------------------------------------------

SERVE_RTOL = 1e-5     # card vs CPU engine, fp32: every decode step's logits


def serve_launches(cfg, decode_steps):
    """The launches a serving run must make: one multi-adapter LoRA kernel
    per adapted projection (wq, wv) a layer in each batched engine decode
    step. The B=1 admission prefill (a single-adapter page) and the greedy
    loop launch none."""
    from repro_torch.configs import SpryConfig
    want = dict.fromkeys(KERNELS, 0)
    want["lora_dual_multi"] = len(SpryConfig().lora_targets) * cfg.n_layers * decode_steps
    return want


def recording_engine(step_log, all_steps):
    """A ``ServingEngine`` whose batched decode steps are timed (synchronised)
    into ``log``: the step's seconds, its active rows and the logits (fp32,
    on the host) of each active row at every step (``all_steps``) or at its
    request's first decode step only, into ``step_log``. ``run`` keeps its
    requests and records its wall time; the peak device memory restarts once the engine is built
    (weights, caches and pages resident, model init excluded)."""
    import numpy as np
    import torch
    from repro_torch.launch.serving import ServingEngine

    class Recording(ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            inner = self._decode

            def decode(base, peft, cache, tok, pos):
                if tok.shape[0] != self.max_batch:      # a B=1 admission loop
                    return inner(base, peft, cache, tok, pos)
                keep = self._active & (True if all_steps else self._pos == self._plen)
                rids = list(self._rid)
                sync = torch.cuda.synchronize if tok.is_cuda else (lambda: None)
                sync()
                t0 = time.perf_counter()
                logits, cache = inner(base, peft, cache, tok, pos)
                sync()
                step_log.append({"s": time.perf_counter() - t0,
                            "n_active": int(self._active.sum()),
                            "rows": {rids[b]: logits[b].float().cpu()
                                     for b in np.nonzero(keep)[0]}})
                return logits, cache
            self._decode = decode

        def run(self, requests=None):
            self.requests = list(requests or ())
            t0 = time.perf_counter()
            out = super().run(requests)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.run_s = time.perf_counter() - t0
            return out
    return Recording


def phase_serve_parity():
    """One engine on the card (the multi-adapter kernel) and the same engine
    on the CPU (its plain version), reduced llama2 in fp32, the same
    weights, adapters and requests: 5 requests over 3 adapters, max_batch 2,
    capacity 2, so rows are admitted mid-flight and a page is evicted. Every
    decode step's logits within SERVE_RTOL, the same ids."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serving import Request
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_map

    cfg = reduce_config(get_config("llama2-7b"))
    gen = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_base(cfg, gen)
    cpu_store = SyntheticAdapterStore(cfg, seed=0)

    class CardStore:            # the CPU store's adapters, moved to the card
        def template(self):
            return self.load(0)

        def load(self, aid):
            return tree_map(lambda t: t.cuda(), cpu_store.load(aid))

    rng = np.random.default_rng(0)
    plen, news = (8, 12, 8, 5, 10), (6, 3, 7, 4, 5)
    reqs = [Request(f"r{i}", i % 3, rng.integers(0, cfg.vocab, plen[i]).astype(np.int32),
                    news[i]) for i in range(5)]
    runs = {}
    for dev, store, b in (("cpu", cpu_store, base),
                          ("cuda", CardStore(), tree_map(lambda t: t.cuda(), base))):
        steps = []
        cache = AdapterCache(store, capacity=2)
        eng = recording_engine(steps, all_steps=True)(cfg, b, cache, max_batch=2,
                                                      cache_len=20)
        reset_launch_counts()
        out = eng.run(reqs)
        runs[dev] = (out, steps, cache.stats(), launch_counts())
    (out_c, log_c, stats_c, _), (out_g, log_g, stats_g, counts) = runs["cpu"], runs["cuda"]
    errs, margin = [], float("inf")
    for sc, sg in zip(log_c, log_g):
        assert sc["rows"].keys() == sg["rows"].keys()
        for rid, want in sc["rows"].items():
            errs.append(float((sg["rows"][rid] - want).abs().max() / want.abs().max()))
            top = torch.topk(want, 2).values
            margin = min(margin, float(top[0] - top[1]))
    res = {"requests": len(reqs), "decode_steps": len(log_g),
           "logits_rel_err_max": max(errs), "ids_equal": out_g == out_c,
           "min_top2_margin": margin, "adapter_cache": stats_g,
           "lora_dual_multi_launches": counts["lora_dual_multi"]}
    log(f"[serve] reduced llama2 fp32 engine, card (kernel) vs cpu (plain), limit "
        f"{SERVE_RTOL}: " + json.dumps(res))
    if not (len(log_c) == len(log_g) and max(errs) <= SERVE_RTOL and out_g == out_c
            and stats_g == stats_c and stats_g["evictions"] > 0
            and counts == serve_launches(cfg, len(log_g))):
        raise AssertionError(f"serve parity: card engine disagrees with cpu {res}")


# full-depth bf16 logits, engine vs greedy: about twice the largest reading on
# the H100 (PERF.md, Findings: 0.078 with the kernel, of logits with std 1.0
# and max 4.5). The kernel rounds x@W + s*u@B once where the plain primal
# rounds twice; that one-ulp difference at 64 projections grows through 32
# bf16 layers. The engine with the plain version instead reproduces greedy
# to 0.0-0.031 (batching alone), and the kernel is held to its plain version
# on the path's own inputs at the per-call bf16 tolerance.
SERVE_BF16_ATOL = 0.16


def _run_engine_recorded(cfg, P, steps, plain=False):
    """``serve.run_engine`` (8 requests on 6 adapters, max_batch 4, capacity
    4) with each request's first decode-step logits recorded; ``plain`` swaps
    the multi-adapter kernel for its plain version. Returns (outputs,
    engine, step log, launch counts, peak GiB, the first kernel call's
    inputs). The peak is the serving run's (see ``recording_engine``)."""
    import torch
    from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
    from repro_torch.kernels.lora_dual import ops
    from repro_torch.launch import serve, serving

    step_log, first_call = [], []

    def capture(*args):               # the path's own inputs, first launch only
        if not first_call:
            first_call.extend(a.clone() if hasattr(a, "clone") else a for a in args)
        return ops.lora_dual_multi(*args)
    orig = serving.ServingEngine, dispatch.lora_dual_multi
    serving.ServingEngine = recording_engine(step_log, all_steps=False)
    dispatch.lora_dual_multi = ops.lora_dual_multi_ref if plain else capture
    reset_launch_counts()
    try:
        outputs, engine = serve.run_engine(cfg, 8, P, steps, max_batch=4,
                                           cache_capacity=4, n_adapters=6,
                                           device="cuda")
    finally:
        serving.ServingEngine, dispatch.lora_dual_multi = orig
    torch.cuda.synchronize()
    return (outputs, engine, step_log, launch_counts(),
            torch.cuda.max_memory_allocated() / 2 ** 30, first_call)


def phase_serve(totals, smi):
    """llama2-7b at full width and depth in bf16 through the serve entry
    points. ``run_engine`` (8 requests on 6 adapters, max_batch 4, capacity
    4, P=16, 32 new tokens) must make exactly ``serve_launches``; the first
    launch's own inputs are held against the plain version at the bf16
    tolerance. The same engine with the plain version launches nothing. Each
    request's first decode-step logits, from both engines, are held against
    its own B=1 greedy run (the plain single-adapter primal) within
    SERVE_BF16_ATOL; the id sequences equal to greedy's are counted.
    ``greedy_generate`` (B=4, P=16, 32 steps) must launch nothing. Prints
    end-to-end and steady-state decode tokens/s, decode steps, the adapter
    cache's stats, peak device memory, and a profile of batched decode
    steps (device time by kernel, host-bound share)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.lora_dual import ops
    from repro_torch.launch import serve

    cfg = get_config("llama2-7b")
    P, steps = 16, 32
    outputs, engine, log_steps, counts, engine_peak, call = _run_engine_recorded(
        cfg, P, steps)
    want = serve_launches(cfg, engine.steps)
    n_tok = sum(len(v) for v in outputs.values())
    in_situ = close("lora_dual_multi on the engine's first launch", ops.lora_dual_multi(*call),
                    ops.lora_dual_multi_ref(call[0].float(), call[1], call[2].float(),
                                            *call[3:]), torch.bfloat16)
    res = {"requests": len(outputs), "decode_steps": engine.steps,
           "generated_tokens": n_tok, "e2e_s": engine.run_s,
           "e2e_tok_per_s": n_tok / engine.run_s,
           "steady_decode_tok_per_s": sum(x["n_active"] for x in log_steps)
           / sum(x["s"] for x in log_steps),
           "mean_decode_step_ms": 1e3 * sum(x["s"] for x in log_steps) / len(log_steps),
           "adapter_cache": engine.adapters.stats(), "peak_GiB": engine_peak,
           "in_situ_kernel_max_abs_err": in_situ, "launches": counts, "card": smi}
    log("[serve] llama2-7b engine: " + json.dumps(res))
    if counts != want or len(log_steps) != engine.steps:
        raise AssertionError(f"serve engine: launches {counts} != {want}")
    if engine.adapters.stats()["evictions"] < 1:
        raise AssertionError("serve engine: no adapter page was evicted")
    for k, n in counts.items():
        totals[k] += n
    base, store, model = engine.base, engine.adapters.store, engine.model
    requests = engine.requests
    fns = serve.build_serve_fns(cfg, model)
    log_serve_profile(cfg, engine, fns, P)
    del engine, call
    gc.collect()                  # the engines' decode closures form cycles

    p_out, p_engine, p_log, p_counts, _, _ = _run_engine_recorded(cfg, P, steps,
                                                                 plain=True)
    p_ms = 1e3 * sum(x["s"] for x in p_log) / len(p_log)
    del p_engine
    gc.collect()
    if any(p_counts.values()):
        raise AssertionError(f"serve engine, plain version: launched {p_counts}")

    # greedy, B=4, on the engine's base with adapter 0's tree
    peft = store.load(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (4, P), generator=gen, device="cuda",
                           dtype=torch.int32)
    reset_launch_counts()
    serve.greedy_generate(cfg, base, peft, prompt, 1, cache_len=P + steps, fns=fns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = serve.greedy_generate(cfg, base, peft, prompt, steps, cache_len=P + steps,
                                fns=fns)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    greedy_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cache = model.init_cache(cfg, 4, P + steps, device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    fns["decode"](base, peft, cache, tok, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        fns["decode"](base, peft, cache, tok, 1 + s)
    torch.cuda.synchronize()
    decode_tps = 4 * steps / (time.perf_counter() - t0)

    # each engine request against its own greedy run (B=1, its adapter)
    first = {"kernel": {x: r for s in log_steps for x, r in s["rows"].items()},
             "plain": {x: r for s in p_log for x, r in s["rows"].items()}}
    errs = {"kernel": [], "plain": []}
    same = {"kernel": 0, "plain": 0}
    max_logit = 0.0
    for req in requests:
        rid = req.request_id
        prompt1 = torch.as_tensor(req.prompt, device="cuda")[None]
        peft1 = store.load(req.adapter_id)
        cache1 = model.init_cache(cfg, 1, P + steps, device="cuda")
        logits, cache1 = fns["prefill"](base, peft1, cache1, prompt1)
        tok1 = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        g = fns["decode"](base, peft1, cache1, tok1, P)[0][0].float().cpu()
        max_logit = max(max_logit, float(g.abs().max()))
        g_ids = serve.greedy_generate(cfg, base, peft1, prompt1, steps,
                                      cache_len=P + steps, fns=fns)[0].tolist()
        for route, out in (("kernel", outputs), ("plain", p_out)):
            errs[route].append(float((first[route][rid] - g).abs().max()))
            same[route] += int(g_ids == out[rid])
    torch.cuda.synchronize()
    g_counts = launch_counts()
    res = {"batch": 4, "prompt_len": P, "steps": steps, "e2e_s": e2e,
           "e2e_tok_per_s": 4 * steps / e2e, "steady_decode_tok_per_s": decode_tps,
           "peak_GiB": greedy_peak, "launches": g_counts,
           "sample_ids": ids[0, :16].tolist(), "card": smi}
    log("[serve] llama2-7b greedy: " + json.dumps(res))
    res = {"first_step_max_abs_err_vs_greedy": {k: max(v) for k, v in errs.items()},
           "per_request": errs, "max_abs_logit": max_logit,
           "ids_equal_greedy": {k: f"{v}/8" for k, v in same.items()},
           "plain_engine_mean_decode_step_ms": p_ms, "limit": SERVE_BF16_ATOL}
    log("[serve] llama2-7b engine (kernel, plain version) vs per-request greedy: "
        + json.dumps(res))
    if any(g_counts.values()):
        raise AssertionError(f"serve greedy launched kernels: {g_counts}")
    if not (math.isfinite(e2e) and math.isfinite(decode_tps)
            and max(errs["kernel"] + errs["plain"]) <= SERVE_BF16_ATOL):
        raise AssertionError(f"serve: engine vs greedy {res}")


def log_serve_profile(cfg, engine, fns, P, n=3):
    """``n`` batched decode steps of the drained engine (4 rows on 4 pages)
    under ``torch.profiler``: device time by kernel and the share of the
    step's wall time the device is busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    peft = engine.adapters.multi_peft(list(range(engine.max_batch)))
    tok = torch.zeros((engine.max_batch, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((engine.max_batch,), P, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fns["decode"](engine.base, peft, engine.cache, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fns["decode"](engine.base, peft, engine.cache, tok, pos)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fns["decode"](engine.base, peft, engine.cache, tok, pos)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU:
            rows.append((t / 1e3 / n, e.count // n, e.key[:80]))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    log(f"[serve] llama2-7b batched decode step (B={engine.max_batch}): wall "
        f"{1e3 * wall:.3f} ms unprofiled, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / (1e3 * wall):.1f}% of the wall)")
    for ms, count, key in rows[:10]:
        log(f"[serve]   {ms:8.3f} ms {count:5d}x  {key}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test of repro_torch")
    ap.add_argument("--only", choices=("kernels", "parity", "train", "serve"),
                    default=None,
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
        for fused in (False, True):
            phase_parity(fused)
            phase_parity(fused, "zamba2-1.2b", n_layers=3, hybrid_attn_every=2)
            phase_parity(fused, "zamba2-1.2b")      # final site attention
    from repro_torch.kernels import launch_counts
    totals = {k: 0 for k in launch_counts()}
    if args.only in (None, "train"):
        phase_site(totals)
        rb, ll, zb = "roberta-large-lora", "llama2-7b", "zamba2-1.2b"
        results = phase_train(
            [(rb, "spry", 1, 2, 4, False), (rb, "spry", 8, 2, 4, False),
             (rb, "spry_periter", 8, 2, 4, False),
             (rb, "spry", 8, 2, 4, True), (rb, "spry_periter", 8, 2, 4, True),
             (rb, "fedfgd", 8, 2, 4, False)]
            + [(rb, m, 1, 1, 4, False) for m in ("fedavg", "fedyogi", "fedsgd",
                                                 "fedavgsplit", "fedmezo", "baffle",
                                                 "fwdllm")]
            + [(ll, "spry", 4, 1, 2, False), (ll, "spry", 4, 1, 2, True),
               (ll, "fedavg", 1, 1, 2, False)]
            + [(zb, "spry", 8, 2, 4, False), (zb, "spry", 8, 1, 4, True),
               (zb, "spry_periter", 8, 1, 4, True), (zb, "fedavg", 1, 1, 4, False)],
            totals)
        for arch, what in ((ll, "2 clients"), (zb, "4 clients")):
            peak = {f"{r['method']}_{r['route']}": r["round_peak_GiB"]
                    for r in results if r["arch"] == arch}
            log(f"[train] {arch} peak device memory GiB of a round ({what}, batch "
                f"8 x 32 tokens): " + json.dumps(peak))
    if args.only in (None, "serve"):
        phase_serve_parity()
        phase_serve(totals, smi)
    if args.only is None:
        missing = [k for k, n in totals.items() if n == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
    log(f"[done] {time.time() - t0:.1f}s")
    kernels = []
    for name in KERNELS:
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
