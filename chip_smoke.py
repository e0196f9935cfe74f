#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``), one H100.

    python3 chip_smoke.py                 # every phase, as a check
    python3 chip_smoke.py --only kernels  # one phase while iterating

Phases, in order (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch's name
  2. build    nvcc builds every CUDA kernel of the path for sm_90a, in
              parallel; prints each kernel's registers, shared memory and
              spills (-Xptxas -v)
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (roberta-large, llama2-7b) and one long
              shape, T in {1, 8}, with and without an input tangent, window in
              {None, 256}, KV in {H, H/4}, fp32 (rtol 1e-4, atol 1e-5 x
              max|plain|: sums run in another order) and bf16 (the kernel's
              bf16 output against the plain version run in fp32 on the same
              bf16-valued inputs, rtol = atol = 2e-2); times the
              kernel, the plain version and either one PyTorch call that
              computes the same function (library_ms) or, where none
              does, the kernel's largest GEMM as a yardstick
              (yardstick_ms) (CUDA events), and computes each case's bound
              from its shapes
  4. parity   one reduced-roberta SPRY round on the card (kernels) against
              the same round on the CPU (plain versions) with the same
              weights, batch and perturbations
  5. train    ``repro_torch.launch.train.run_training`` at full published
              width and depth: roberta-large-lora (spry K=1, spry K=8,
              spry_periter K=8; 2 rounds, 4 clients) and llama2-7b (spry K=4,
              1 round, 2 clients); every launch counter is zeroed just before
              and read just after each run: each kernel must have launched,
              and on the batched routes the multi-tangent launches of a round
              must equal estimates x sites (one launch per site for all K)
The line before the last is the ``kernels`` JSON; the last line is
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
}
SOURCES = {
    "lora_dual_mt": "src/repro_torch/csrc/lora_dual_mt.cu",
    "swa_attention": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt": "src/repro_torch/csrc/swa_attention.cu",
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
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for K in (1024, 4096):              # roberta-large, llama2-7b widths
            for T in (1, 8):
                for has_xd in (True, False):
                    res = lora_case(8 * 32, K, K, 1, T, has_xd, dtype, gen,
                                    timed=(bf and T == 8))
                    if bf and K == 1024 and T == 8 and has_xd:
                        main["lora_dual_mt"] = res
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
    return main


# ---------------------------------------------------------------------------
# phase 4: one reduced round, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def phase_parity():
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
                    server_lr=1e-2, seed=0)
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
    log("[parity] reduced roberta, 1 spry round K=4, card vs cpu: " + json.dumps(res))
    if not (jv_err <= 1e-4 and p_err <= 1e-4 and
            abs(res["loss_gpu"] - res["loss_cpu"]) <= 1e-5 * abs(res["loss_cpu"])):
        raise AssertionError(f"parity: card round disagrees with cpu round {res}")


# ---------------------------------------------------------------------------
# phase 5: full-size training through the entry point
# ---------------------------------------------------------------------------

def phase_train(phases):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run_training

    totals = {k: 0 for k in launch_counts()}
    for arch, method, K, rounds, clients in phases:
        L = get_config(arch).n_layers
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        hist = run_training(arch=arch, task="sst2", method=method, rounds=rounds,
                            clients_per_round=clients, batch_size=8,
                            k_perturbations=K, eval_every=1, reduced=False,
                            device="cuda", log=lambda s: log("  " + s))
        torch.cuda.synchronize()
        counts = launch_counts()
        res = {"arch": arch, "method": method, "K": K, "clients": clients,
               "loss": [h["loss"] for h in hist], "test_acc": [h["acc"] for h in hist],
               "round_s": [h["round_s"] for h in hist],
               "personalized_acc": hist[-1]["personalized_acc"],
               "max_memory_allocated_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": counts, "round_launches": [h["launches"] for h in hist]}
        log(f"[train] {arch} {method} K={K}: " + json.dumps(res))
        if not all(math.isfinite(x) for x in res["loss"]):
            raise AssertionError(f"train {arch} {method}: loss not finite")
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"train {arch} {method}: kernels never launched {missing}")
        estimates = clients            # one estimate a client (local_iters=1)
        for rl in res["round_launches"]:
            want = {"lora_dual_mt": estimates * 2 * L,          # wq, wv per layer
                    "swa_attention": estimates * L,
                    "swa_attention_mt": estimates * L}
            if rl != want:
                raise AssertionError(f"train {arch} {method} K={K}: round launches "
                                     f"{rl} != one per site and estimate {want}")
        for k, n in counts.items():
            totals[k] += n
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test of repro_torch")
    ap.add_argument("--only", choices=("kernels", "parity", "train"), default=None)
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
        phase_parity()
    totals = {}
    if args.only in (None, "train"):
        totals = phase_train([
            ("roberta-large-lora", "spry", 1, 2, 4),
            ("roberta-large-lora", "spry", 8, 2, 4),
            ("roberta-large-lora", "spry_periter", 8, 2, 4),
            ("llama2-7b", "spry", 4, 1, 2),
        ])
    log(f"[done] {time.time() - t0:.1f}s")
    kernels = []
    for name in ("lora_dual_mt", "swa_attention", "swa_attention_mt"):
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
