#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``), one H100.

    python3 chip_smoke.py                 # every phase, as a check
    python3 chip_smoke.py --only kernels  # one phase while iterating
                                          # (kernels|parity|train|serve|runtime|dense|
                                          #  families|peft|analysis)

Phases, in order (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch's name
  2. build    nvcc builds every CUDA source of the path for sm_90a, in
              parallel; prints each kernel's registers, shared memory and
              spills (-Xptxas -v), and the count of tensor-core instructions
              in the SASS (cuobjdump -sass) of the seven tensor-core kernels:
              HGMMA in ``lora_mt_tc_kernel`` and ``lora_jvps_tc_kernel``,
              HMMA in ``swa_tc_kernel``, ``swa_tc_mt_kernel`` and
              ``swa_tc_jvps_kernel``, DMMA (fp64) in ``mamba2_ssd_kernel``
              and ``wkv6_chunk_kernel`` (their tangent-store and
              contraction instantiations); fails if an instantiation has
              none, and unless the ``swa_attention`` tensor-core
              instantiations that serve gemma3-12b (hd 256) and
              h2o-danube-3-4b (hd 120) have no stack frame and no local
              memory (cuobjdump -res-usage of the built library: no spill)
  3. kernels  each of the twelve kernels against its plain PyTorch version on
              the card at the main path's shapes (roberta-large, llama2-7b,
              zamba2, rwkv6-1.6b) and one long shape. ``lora_dual_mt`` and
              the ``swa_attention`` primal also at their routes' edges (T in
              {1, 8, 64}, rank 16, M=200 with T=3, K or N off the 8-element
              rows; S in {1, 17, 32, 2048} with hd in {64, 128}, hd 48, 40
              (padded to 48 on the tensor cores) and 36 (simt)); rows 2-4
              at the dense configs' widths (DENSE_SWA_SHAPES: gemma3-12b's
              H=16, KV=8, hd=256 at S=32 and at S=2048 with window 1024,
              h2o-danube's H=32, KV=8, hd=120 at S=32 and at S=2048 with
              window 256; T in {0, 1, 8}; bf16 on tc, fp32 at S=32), their
              contraction's lanes and repeats at those widths, and row 6 at
              command-r-plus-104b's decode (K=12288, N 12288 and 1024,
              stream, cold); every case of rows 1-6 held to the route its wrapper
              must take (the per-route launch counters), the bf16
              tangents on the tensor-core route also against the tiled plain
              walk in their own roundings (``close_tiled``). The
              multi-adapter projection at llama2-7b's engine decode (M=4,
              K=N=4096, P=4, r=1), a prefill-sized M=256 with random pages, a
              ragged case (M=5, K=1000, N=333, P=3, r=4, every page hit, with
              repeats) and the stream route's edges (M=1; M=16, r=16; K=1000,
              N=136), fp32 and bf16 at the tolerances below, two launches on
              the same inputs bitwise equal, timed warm and, where W is a
              quarter of the L2 or more, cold (``cold_ms``,
              ``plain_cold_ms``, ``yardstick_cold_ms``: each call reads the
              next of enough copies of W to pass 120 MB); cold also at the
              other engine decode shapes (M=4, P=4, r=1, bf16; K x N =
              2048 x 2048, 2048 x 8192, 4096 x 2048). LoRA and
              attention: T in {1, 8},
              with and without an input tangent (and odd M/N/K for the LoRA
              contraction), window in {None, 256}, KV in {H, H/4}; fp32
              (rtol 1e-4, atol 1e-5 x max|plain|: sums run in another order)
              and bf16 (the kernel's bf16 output against the plain version
              run in fp32 on the same bf16-valued inputs, rtol = atol =
              2e-2). The mamba2 recurrence (fp32 only, as the reference's
              kernels): zamba2's shapes (B=8, S=32, H=64, hd=N=64), S=33
              (one token past a 32-token chunk), a ragged shape, N=100 and
              three chunks (S=70, hd=40), T in {1, 8, 64} (timed at
              zamba2's shapes), and zamba2's widths at S=1024 (B=1, T in
              {1, 8}); the contraction on the route ``mamba2_jvps_path``
              gives (chunk for S <= 32); a T=8 launch must equal eight T=1
              launches bit for bit (tangents and contraction, at one chunk
              on either contraction route and across chunks) and two
              contraction launches must agree bit for bit. Rows 10 and 11
              also print ``eager_ms``, as rows 1 and 2 do. The wkv6
              recurrence (fp32 only, as the reference's kernels): rwkv6-1.6b's
              shapes (B=8, S=32, H=32, hd=64), two ragged shapes (S=29 and
              S=37, B*H=15, hd=40) and S=1024, T in {1, 8, 64}, with and
              without a tangent of u, each tangent and contraction launch
              on the route ``wkv6_mt_path`` / ``wkv6_jvps_path`` gives
              (chunk for S <= 32; the tangents held also against the plain
              chunked form ``wkv6_chunked_ref`` at T <= 8:
              ``max_abs_err_chunked``), the same bitwise lane and repeat
              checks on both routes; rows 7 and 8 print ``eager_ms``. On
              the chunk route the mamba2 and wkv6 contractions are also
              held against the fp64 contraction of the tangent pass's
              output (``fp64_contraction``: the jvps within 1e-12 x
              sum|terms| plus half an fp32 ulp, ``err_over_terms_fp64``, and
              a repeat launch bitwise equal). The four
              contraction epilogues return sums of n products, held against
              1e-6 x sum|terms| in every dtype (the kernel reads bf16 exactly
              into the same fp32 sums as fp32; a typical contraction is about
              sum|terms| / sqrt(n), so a wrong or dropped term fails), and
              print err / sum|terms| as ``err_over_terms``; the LoRA one
              also at M=200, K=N=1032, rank 16 (off the tensor-core tiles)
              and with 64 tangents, and the bf16 LoRA and attention
              contractions (route tc) lane by lane: a T=8 launch equals
              eight T=1 launches bit for bit, and two launches agree. Times the
              kernel, the plain version and either one PyTorch call that
              computes the same function (library_ms) or, where none does,
              a yardstick (yardstick_ms: the kernel's largest GEMM, for the
              recurrence the batched GEMM of its quadratic form; for the
              contraction epilogues, the multi-tangent kernel followed by
              the contraction), and computes each case's bound from its
              shapes. Times are medians of 3 CUDA-event windows, each of at
              least 200 calls of anything under 0.1 ms (``time_ms``); a
              kernel, library call or yardstick is replayed from a CUDA
              graph (its device time, not the host's launch rate), a plain
              version runs eagerly
  4. parity   one reduced SPRY round on the card (kernels) against the same
              round on the CPU (plain versions) with the same weights, batch
              and perturbations, on the standard and on the fused-contraction
              route: roberta, zamba2 with n_layers=3, hybrid_attn_every=2
              (final site mamba2), reduced zamba2 (final site attention) and
              reduced rwkv6 (final site wkv6); loss and jvps within 1e-5
              relative; the new PEFT within 1e-5 of the CPU round replayed
              with the card's jvps (aggregation and server step) and end to
              end within PEFT_RTOL, set per config from its readings (1e-5
              roberta, 3e-5 zamba2, 1e-4 rwkv6); rwkv6's jvps within
              JVPS_RTOL_BY_ARCH (3.5e-5): its plain versions on the card miss
              1e-5 as well (scripts/parity_plain_on_card.py)
  5. site     the single-projection LoRA estimator (a ``SplitLoss`` of kind
              'lora', through ``forward_gradient``) at roberta-large and
              llama2-7b widths, K=8, with and without an input tangent:
              exactly one LoRA contraction epilogue an estimate
  6. train    ``repro_torch.launch.train.run_training`` at full published
              width and depth: roberta-large-lora on sst2, 4 clients (spry K=1,
              1 round; spry K=8, spry_periter K=8 on the standard route; spry
              K=8 and spry_periter K=8 on the fused route; fedfgd K=8; 2
              rounds each;
              fedavg, fedyogi, fedsgd, fedavgsplit, fedmezo, baffle, fwdllm,
              1 round each), llama2-7b, 2 clients (spry K=4 on both routes
              and fedavg, 1 round each) and zamba2-1.2b, 4 clients (spry K=8
              on the standard route, 2 rounds; spry K=8 and spry_periter K=8
              on the fused route and fedavg, 1 round each) and rwkv6-1.6b, 4
              clients (the same four runs as zamba2). Every launch
              counter is zeroed just before and read just after each run; a
              round must make exactly the launches ``round_launches`` derives
              from the config (per estimate one primal and one multi-tangent
              kernel per mixer site and one LoRA kernel per adapted
              projection on the standard route; on the fused route the final
              site's tangent kernel replaced by ONE contraction epilogue), and
              no kernel at all on the backprop and zero-order rounds; every
              ``lora_dual_mt`` and ``swa_attention`` (primal and tangent)
              launch and every contraction epilogue of rows 4 and 5 in
              phases 5 and 6 (bf16 at full width) must take a tensor-core
              route (tc, or store where no input tangent exists), none
              simt, and every ``wkv6_scan_mt``, ``wkv6_scan_mt_jvps`` and
              ``mamba2_scan_mt_jvps`` launch the chunk route (S=32), none
              rec. Prints
              each run's loss, test accuracy, seconds per round and peak
              device memory of a round (weights included, model init
              excluded), and SPRY's and FedAvg's round peaks side by side for
              llama2-7b, zamba2 and rwkv6-1.6b.
  7. serve    reduced llama2, reduced rwkv6 and zamba2 with n_layers=3,
              hybrid_attn_every=2 (fp32) through the ``ServingEngine`` on
              the card and on the CPU, the same weights, adapters and
              requests (5 requests over 3 adapters, max_batch 2, capacity 2:
              admissions mid-flight and an eviction): every decode step's
              logits within SERVE_RTOL, equal ids and cache stats, exactly
              ``serve_launches``, the smallest top-2 logit margin printed.
              The reduced llama2 engine on the card with telemetry and
              without (``serve_telemetry``): equal ids, the same
              ``lora_dual_multi`` launches by route, one ``request`` event
              a request with the reference's fields, the
              ``adapter_cache.*`` counters equal to the cache's stats.
              Then llama2-7b, rwkv6-1.6b and zamba2-1.2b at full width and
              depth in bf16 through ``launch/serve.py``: ``run_engine`` (8
              requests on 6 adapters, max_batch 4, capacity 4, P=16, 32 new
              tokens) must make exactly ``serve_launches`` (one
              multi-adapter launch per adapted projection a decode step: 64,
              48 and 88, every one on the stream route), every launch of
              its first decode step held against the plain version on its
              own inputs at the bf16 tolerance, each request's first
              decode-step logits held against its own B=1 greedy run
              (the plain single-adapter primal) within the arch's
              SERVE_BF16_ATOL, the count of id sequences equal to greedy's
              printed; the same engine with the plain version and
              ``greedy_generate`` (B=4, P=16, 32 steps) must launch nothing;
              in fp32 at full width and depth one batched decode step (four
              adapters; kernel and plain version, and the plain version on
              the host CPU) held against the B=1 greedy steps on its
              device within the arch's SERVE_FP32_ATOL.
              Prints end-to-end and steady-state decode tokens/s, decode
              steps, the adapter cache's stats, peak device memory and a
              profiled decode step (device busy share).
  8. runtime the federation runtime (``repro_torch.fl.runtime``,
              ``repro_torch.checkpoint``) at full published width and depth
              ((b) at 12 of roberta-large's 24 layers: the script's clock),
              bf16: (a) roberta-large-lora, 4 clients, K=8, standard route:
              ``FederationEngine.run_ideal`` with no wire and with an fp32
              wire bitwise equal to the in-process round step (new PEFT,
              server state, metrics), both comm modes, each making exactly
              ``round_launches`` on tensor-core routes; the bf16 wire's
              largest relative PEFT difference printed. (b)
              ``run_training(runtime=True)`` with everything on (8 clients a
              round from 64 over-selected 1.5x, a deadline, dropout 0.25,
              the streaming executor, wire simulation, the mild fault
              preset, quorum 0.5): 3 rounds straight against 2 rounds, a
              checkpoint every round, killed and resumed to 3, the final
              state's content hash and the history equal, for spry,
              spry_periter and the async engine (buffer 4, concurrency 8,
              max staleness 2); each synchronous round exactly
              ``round_launches`` for its cohort; prints s/round, bytes up
              and down beside Table 2's count, the wire health, survivors
              and round peaks. The straight runs record telemetry and the
              others not, so the equalities hold it neutral; its JSONL,
              Chrome trace and Prometheus file are checked
              (``check_telemetry``: event kinds, a ``wire_health`` event a
              round with health, ``fl.rounds``, the byte counters against
              the history, 3 round spans, the ``post_round_1`` memory
              event's peak equal to the first round's). (c) llama2-7b, spry K=4, the streaming
              executor: the cohort-16 round's peak within 4 |peft| (~8
              MiB) of the cohort-4 round's. (d) one reduced fp32 chaos round on the card
              and on the CPU: equal wire health, survivors and dropped
              frames, the new PEFT within 1e-5
  9. dense    the other dense configs at full published width, bf16
              (``--only dense``): ``run_training`` on sst2, 2 clients, one
              round (gemma3-12b spry K=4 on both routes and fedavg,
              gemma3-27b spry K=4, h2o-danube-3-4b spry K=4 on both routes,
              command-r-plus-104b spry K=4 at 8 of its 64 layers, printed
              as ``reduced``), each round exactly ``round_launches``, every
              launch of rows 1-5 on a tensor-core route, s/round and round
              peaks printed; one gemma3-12b ``forward_gradient`` at full
              width and depth, B=1, S=2048, K=4 (40 local layers' 1024-key
              band on the tensor-core walk, 8 global layers), again through
              the plain versions on the card and with fp32 weights: each
              route's loss and jvps within DENSE_LONG_FP32_RTOL of the fp32
              estimate's and the kernels' jvps no further from it than
              DENSE_LONG_PLAIN_MULT times the plain versions' (kernels vs
              plain printed beside DENSE_LONG_RTOL); serving of the four (command-r
              at 8 layers) through ``run_engine`` (4 requests on 4 adapters,
              P=16, 32 new tokens; exactly ``serve_launches``, all
              ``stream``, the first step's calls against the plain
              version), the same engine with the plain version, and
              ``greedy_generate`` (B=4, no launch), each
              request's first decode-step logits from both engines against
              its own B=1 greedy step within SERVE_BF16_ATOL[arch], and
              ``serve_fp32_witness`` on the card (DENSE_WITNESS_LAYERS'
              depth) within SERVE_FP32_ATOL[arch]; in fp32 at full width a
              decode step against the teacher-forced forward
              (DENSE_FP32_DECODE_RTOL): gemma3-12b at 6 layers (layer 5
              global) past its window with a 1100-token prompt, h2o-danube
              at 3 layers wrapping its 4096-slot ring with 4104 tokens. Each
              model is freed before the next; the phase ends with the
              device memory allocated at its start
 10. families the moe, vlm and encoder-decoder configs at full published
              width, bf16 (``--only families``; depth cut to one card,
              printed as ``reduced``: qwen3-moe-235b-a22b 8 of 94 layers,
              llama4-maverick-400b-a17b 2 of 48, internvl2-76b 24 of 80;
              whisper-tiny whole): ``run_training`` on sst2, 2 clients,
              one round, text-only (qwen3 spry K=4 on both routes and
              fedavg, internvl2 spry K=4 on both routes, llama4 spry K=4),
              each round exactly ``round_launches``, rows 1-4 on a
              tensor-core route; ``forward_gradient`` of the split LM loss,
              K=4, both routes, B=2 x 32 tokens with a frontend batch
              (internvl2 256 patch embeddings, llama4 128, whisper 1500
              frames), exactly one estimate's ``round_launches``, the
              kernels against their plain versions on the card within
              FAMILY_EST_PLAIN_RTOL and, where fp32 weights fit (internvl2
              at 12 layers, whisper whole), each bf16 run against the fp32
              estimate within FAMILY_EST_FP32_RTOL; ``dense_serve`` of the
              four (whisper's requests with their own frames; first step
              vs per-request greedy within SERVE_BF16_ATOL, every
              ``lora_dual_multi`` launch on ``stream``; the fp32 witness at
              FAMILY_FP32_LAYERS' depth, llama4 instead its reduced fp32
              engine card vs CPU); fp32 decode vs teacher forcing for
              qwen3 (4 layers, a 4-token prompt) and whisper; the phase
              ends with the device memory allocated at its start. Phase 3
              also holds rows 1-4 and 6 at these configs' widths
              (FAMILY_SHAPES)
 11. peft     the ia3, bitfit and classifier_only trees (``--only peft``)
              on roberta-large-lora at full published width and depth, bf16,
              4 clients, K=4: ``init_peft`` and ``count_trainable`` (126980 /
              53252 / 4100 trainable, 48 / 48 / 0 units); for each, two SPRY
              rounds through ``core.spry.make_round_step`` on the standard and
              on the fused route, each exactly ``round_launches`` for the
              kind (no ``lora_dual_mt`` launch; no tangent kernel under
              classifier_only; one row-4 epilogue an estimate where the
              fused site has a tangent), every launch on a tensor-core route;
              the first round again with the plain versions on the card,
              within PEFT_PLAIN_RTOL of the kernels; one ``spry_periter``
              round with each client's estimate equal to the server's
              rebuild bit for bit; each run's loss, s/round and round peak;
              reduced llama2 (fp32) with a bitfit and an ia3 tree: the fused
              prefill equals the token-by-token decode loop (PEFT_PREFILL_RTOL)
 12. analysis ``python -m repro_torch.analysis.lint`` on the card over every
              family (reduced configs; ``--only analysis``): the six rules
              over what the entry points ran, every error finding fails the
              phase; under ``torch.profiler`` with one call of each of the
              twelve kernels at the main path's shapes, the shared-memory and
              register table of every instantiation of the seven built
              libraries (``cuobjdump -res-usage`` joined with each launch's
              block and shared memory), printed, each row within the H100's
              budget and every row 1-12 launched
Every kernel must have launched over phases 5 to 11 (the main path). The
line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
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
    "wkv6_scan": "src/repro/kernels/wkv6_scan/kernel.py:50",
    "wkv6_scan_mt": "src/repro/kernels/wkv6_scan/kernel.py:223",
    "wkv6_scan_mt_jvps": "src/repro/kernels/wkv6_scan/kernel.py:181",
}
SOURCES = {
    "lora_dual_mt": "src/repro_torch/csrc/lora_dual_mt.cu",
    "swa_attention": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt": "src/repro_torch/csrc/swa_attention.cu",
    "swa_attention_mt_jvps": "src/repro_torch/csrc/swa_attention.cu",
    "lora_dual_mt_jvps": "src/repro_torch/csrc/lora_dual_mt.cu",
    "mamba2_scan": "src/repro_torch/csrc/mamba2_scan.cu",
    "mamba2_scan_mt": "src/repro_torch/csrc/mamba2_ssd.cu",
    "mamba2_scan_mt_jvps": "src/repro_torch/csrc/mamba2_ssd.cu",
    "lora_dual_multi": "src/repro_torch/csrc/lora_dual_multi.cu",
    "wkv6_scan": "src/repro_torch/csrc/wkv6_scan.cu",
    "wkv6_scan_mt": "src/repro_torch/csrc/wkv6_chunk.cu",
    "wkv6_scan_mt_jvps": "src/repro_torch/csrc/wkv6_chunk.cu",
}


def log(msg):
    print(msg, flush=True)


_SIDE_STREAM = None


def time_ms(fn, graph=True, windows=3):
    """The median over ``windows`` CUDA-event windows of the ms a call of
    ``fn`` takes. With ``graph`` (every kernel, plain version, library call
    and yardstick) n calls are captured once into a CUDA graph and each
    window replays it, so a call is timed at the device's rate, not at the
    rate the host launches it, and a kernel and its plain version are timed
    alike; without (``eager_ms`` of rows 1, 2, 7, 8, 10 and 11: what a call costs on the
    main path, host work included) the calls run eagerly. A window holds at
    least 200 calls of anything under 0.1 ms, and about 0.1 s of calls (at
    least 3) of anything slower. Three warm-up calls, timed on the host,
    set the count."""
    import torch
    global _SIDE_STREAM
    if _SIDE_STREAM is None:    # one for phase 3: each new stream gets its own cuBLAS workspace
        _SIDE_STREAM = torch.cuda.Stream()
    side = _SIDE_STREAM
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):   # graph capture wants its warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    est = (time.perf_counter() - t0) / 3
    calls = (max(200, int(0.1 / est)) if est < 1e-4
             else max(3, min(200, int(0.1 / est))))
    if graph:
        n = min(calls, 100)
        reps = -(-calls // n)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()

        def run():
            for _ in range(reps):
                g.replay()
        calls = n * reps
    else:
        def run():
            for _ in range(calls):
                fn()
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(windows):
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / calls)
    return sorted(ms)[windows // 2]


def timed_once(fn):
    """(fn's result, the ms of that one call on CUDA events): for a plain
    version slow enough to time in one call, whose result is also the
    reference a kernel is held against."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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

# the tensor-core tangent kernel against the plain tiled walk in its own
# roundings (``ops.swa_attention_mt_tiled_ref``: the same 64-key tiles, p
# rounded to bf16): one bf16 ulp of each value (rtol 2**-7) and 1e-3 of the
# largest, for a rounding of p that falls the other way
TILED_RTOL, TILED_ATOL = 2 ** -7, 1e-3


def close_tiled(name, got, want):
    import torch
    got, want = got.float(), want.float()
    atol = TILED_ATOL * float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=TILED_RTOL, atol=atol):
        raise AssertionError(f"{name}: kernel vs tiled plain max |err| {err:.3e} beyond "
                             f"rtol {TILED_RTOL} atol {atol:.3e}")
    return err


def took_path(name, counter, want, call):
    """``call()``, which must launch exactly once, by route ``want`` of the
    per-route ``counter`` (``ops.launches_by_path[kernel]``)."""
    before = dict(counter)
    out = call()
    moved = {p: n - before[p] for p, n in counter.items() if n != before[p]}
    if moved != {want: 1}:
        raise AssertionError(f"{name}: launched {moved}, not one call by route {want}")
    return out


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
    name = f"lora_dual_mt M={M} K={K} N={N} r={r} T={T} xd={has_xd} {dtype}"
    out = took_path(name, ops.launches_by_path["lora_dual_mt"],
                    ops.lora_mt_path(dtype, K, N, has_xd),
                    lambda: ops.lora_dual_mt_tangents(*args))
    ref = ops.lora_dual_mt_tangents_ref(*_f32(args))
    torch.cuda.synchronize()
    res = {"path": ops.lora_mt_path(dtype, K, N, has_xd),
           "max_abs_err": close(name, out, ref, dtype)}
    if timed:
        es = x.element_size()
        flops = (2 * T * M * K * N * has_xd + 2 * M * K * r * (1 + T * (1 + has_xd))
                 + 4 * T * M * r * N)
        nbytes = (es * (M * K * (1 + T * has_xd) + has_xd * K * N + T * M * N)
                  + 4 * (K * r + r * N) * (1 + T))
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dtype)
        res["ms"] = time_ms(lambda: ops.lora_dual_mt_tangents(*args))
        res["plain_ms"] = time_ms(lambda: ops.lora_dual_mt_tangents_ref(*args))
        # eager per call, host work included (the main path launches eagerly)
        res["eager_ms"] = time_ms(lambda: ops.lora_dual_mt_tangents(*args), graph=False)
        res["plain_eager_ms"] = time_ms(lambda: ops.lora_dual_mt_tangents_ref(*args),
                                        graph=False)
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


# the scan epilogues' chunk route against the fp64 contraction of the
# tangent pass's stored output: both sum exact fp64 products of the same
# fp32 tangents and gy, in two orders; the jvps then round once to fp32
FP64_RTOL = 1e-12


def fp64_contraction(name, again, jv, yd, gy):
    """The jvps ``jv`` against ``einsum(gy, yd)`` in fp64, ``yd`` the
    tangent pass's output on the same inputs: |jv - einsum| <= FP64_RTOL x
    sum|terms| plus half an fp32 ulp of jv (its one rounding), and a second
    launch, ``again()``, equals jv bit for bit. Returns the max |err| and
    err / sum|terms|."""
    import torch
    y64, g64 = yd.double(), gy.double()
    want = torch.einsum("bshd,tbshd->t", g64, y64)
    mag = (g64[None] * y64).abs().sum(dim=(1, 2, 3, 4))
    a = jv.abs()
    half_ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double() / 2
    err = (jv.double() - want).abs()
    if not bool((err <= FP64_RTOL * mag + half_ulp).all()):
        raise AssertionError(f"{name}: jvps vs the fp64 contraction of the tangents "
                             f"|err| {err.tolist()} beyond {FP64_RTOL} x sum|terms| "
                             f"{mag.tolist()} + half an fp32 ulp {half_ulp.tolist()}")
    if not torch.equal(again(), jv):
        raise AssertionError(f"{name}: a repeat launch's jvps differ from {jv.tolist()}")
    return {"max_abs_err_fp64": float(err.max()),
            "err_over_terms_fp64": float((err / mag).max())}


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
    name = f"lora_dual_mt_jvps M={M} K={K} N={N} r={r} T={T} xd={has_xd} {dtype}"
    path = ops.lora_jvps_path(dtype, K, N, has_xd)
    got = took_path(name, ops.launches_by_path["lora_dual_mt_jvps"], path,
                    lambda: ops.lora_dual_mt_jvps(*args))
    want = ops.lora_dual_mt_jvps_ref(*_f32(args))
    yd = ops.lora_dual_mt_tangents_ref(*_f32((x, xd, w, a, ad, b, bd, 1.0)))
    mag = (gy.float()[None] * yd.float()).abs().sum(dim=(1, 2))
    torch.cuda.synchronize()
    err, rel = close_jvps(name, got, want, mag)
    res = {"path": path, "max_abs_err": err, "err_over_terms": rel}
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
    name = (f"swa_attention_mt_jvps B={B} H={H} KV={KV} S={S} hd={hd} "
            f"window={window} T={T} {dtype}")
    path = ops.swa_path(dtype, hd)
    got = took_path(name, ops.launches_by_path["swa_attention_mt_jvps"], path,
                    lambda: ops.swa_attention_mt_jvps(*args))
    od = ops.swa_attention_mt_tangents_ref(*_f32(args[:6]), window)
    want = torch.einsum("bhsd,tbhsd->t", gy.float(), od)
    mag = (gy.float()[None] * od).abs().sum(dim=(1, 2, 3, 4))
    del od
    torch.cuda.synchronize()
    err, rel = close_jvps(name, got, want, mag)
    res = {"path": path, "max_abs_err": err, "err_over_terms": rel}
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


def lora_jvps_lanes_and_repeats(M, K, N, r, has_xd, gen):
    """The LoRA contraction on its tc route (bf16): each tangent of a T=8
    launch equals its own T=1 launch bit for bit, and two launches on the
    same inputs give the same jvps."""
    import torch
    from repro_torch.kernels.lora_dual import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    T = 8
    x = rn(M, K).bfloat16()
    xd = rn(T, M, K).bfloat16() if has_xd else None
    w = (rn(K, N) / math.sqrt(K)).bfloat16()
    a, ad = rn(K, r) / math.sqrt(K), rn(T, K, r) / math.sqrt(K)
    b, bd, gy = rn(r, N), rn(T, r, N), rn(M, N).bfloat16()
    name = f"lora_dual_mt_jvps M={M} K={K} N={N} r={r} xd={has_xd}"
    jv = took_path(name, ops.launches_by_path["lora_dual_mt_jvps"], "tc",
                   lambda: ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd))
    for t in range(T):
        one = ops.lora_dual_mt_jvps(x, w, a, ad[t:t + 1].contiguous(), b,
                                    bd[t:t + 1].contiguous(), gy, 0.5,
                                    xdots=None if xd is None else xd[t:t + 1].contiguous())
        if not torch.equal(one[0], jv[t]):
            raise AssertionError(f"{name}: tangent {t} of a T=8 launch differs from a "
                                 f"T=1 launch")
    if not torch.equal(ops.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 0.5, xdots=xd), jv):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"[kernels] {name} (tc): T=8 lanes bitwise equal to T=1 launches, repeat bitwise")


def swa_jvps_lanes_and_repeats(B, H, KV, S, hd, window, gen):
    """The attention contraction on its tc route (bf16): each tangent of a
    T=8 launch, in any slot of any tangent group, equals its own T=1 launch
    bit for bit, and two launches on the same inputs give the same jvps."""
    import torch
    from repro_torch.kernels.swa_attention import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()  # noqa: E731
    T = 8
    q, k, v, gy = rn(B, H, S, hd), rn(B, KV, S, hd), rn(B, KV, S, hd), rn(B, H, S, hd)
    qd, kd, vd = rn(T, B, H, S, hd), rn(T, B, KV, S, hd), rn(T, B, KV, S, hd)
    name = f"swa_attention_mt_jvps B={B} H={H} KV={KV} S={S} hd={hd} window={window}"
    jv = took_path(name, ops.launches_by_path["swa_attention_mt_jvps"], "tc",
                   lambda: ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window))
    for t in range(T):
        one = tuple(a[t:t + 1].contiguous() for a in (qd, kd, vd))
        if not torch.equal(ops.swa_attention_mt_jvps(q, k, v, *one, gy, window)[0], jv[t]):
            raise AssertionError(f"{name}: tangent {t} of a T=8 launch differs from a "
                                 f"T=1 launch")
    if not torch.equal(ops.swa_attention_mt_jvps(q, k, v, qd, kd, vd, gy, window), jv):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"[kernels] {name} (tc): T=8 lanes bitwise equal to T=1 launches, repeat bitwise")


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
    name = f"{kname} B={B} H={H} KV={KV} S={S} hd={hd} window={window} T={T} {dtype}"
    res = {"path": ops.swa_path(dtype, hd)}
    out = took_path(name, ops.launches_by_path[kname], res["path"], run)
    ref = ref_fn(*_f32(args))
    torch.cuda.synchronize()
    res["max_abs_err"] = close(name, out, ref, dtype)
    if T and res["path"] == "tc":
        res["max_abs_err_tiled"] = close_tiled(
            name, out, ops.swa_attention_mt_tiled_ref(*args))
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
        if not T:   # row 2: eager per call, host work included
            res["eager_ms"] = time_ms(run, graph=False)
            res["plain_eager_ms"] = time_ms(plain, graph=False)
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


# the dense configs' attention shapes: gemma3-12b (H=16, KV=8, hd=256) at
# a client batch and at the long band (S=2048, window 1024: the local
# layers' window), h2o-danube-3-4b (H=32, KV=8, hd=120) at a client batch
# and at S=2048 with a 256-key band
DENSE_SWA_SHAPES = ((8, 16, 8, 32, 256, None), (1, 16, 8, 2048, 256, 1024),
                    (8, 32, 8, 32, 120, None), (1, 32, 8, 2048, 120, 256))


def dense_width_cases(dtype, gen, extra, note):
    """Rows 2-4 at DENSE_SWA_SHAPES, T in {0 (the primal), 1, 8}: bf16 on the
    tensor-core route (``close``, ``close_tiled``, the contraction's
    ``close_jvps``), timed at T in {0, 8} against the bound and (row 2)
    ``scaled_dot_product_attention``; fp32 (simt) at the S=32 shapes."""
    import torch
    bf = dtype == torch.bfloat16
    for B, H, KV, S, hd, window in DENSE_SWA_SHAPES:
        if not bf and S > 32:
            continue
        tag = f"B={B} H={H} KV={KV} S={S} hd={hd} window={window}"
        for T in (0, 1, 8):
            timed = bf and T != 1
            res = swa_case(B, H, KV, S, hd, window, T, dtype, gen, timed)
            if timed:
                extra[f"{'swa_attention_mt' if T else 'swa_attention'} {tag} T={T}"] = res
            if T:
                res = note("swa_attention_mt_jvps", dtype, swa_jvps_case(
                    B, H, KV, S, hd, window, T, dtype, gen, timed))
                if timed:
                    extra[f"swa_attention_mt_jvps {tag} T={T}"] = res


# the moe, vlm and encoder-decoder configs' kernel shapes (phase 10):
# (arch, (wq K, N), (wv K, N), attention (B, H, KV, S, hd)): qwen3-moe's
# G=16 at a client batch; llama4-maverick's and internvl2's attention over
# 128 and 256 patch embeddings + 32 text tokens (the estimates' batch of 2);
# whisper-tiny's decoder at a client batch
FAMILY_SHAPES = (("qwen3-moe-235b-a22b", (4096, 8192), (4096, 512), (8, 64, 4, 32, 128)),
                 ("llama4-maverick-400b-a17b", (5120, 5120), (5120, 1024),
                  (2, 40, 8, 160, 128)),
                 ("internvl2-76b", (8192, 8192), (8192, 1024), (2, 64, 8, 288, 128)),
                 ("whisper-tiny", (384, 384), (384, 384), (8, 6, 6, 32, 64)))


def family_width_cases(gen, extra, note):
    """Rows 1, 2, 3, 4 and 6 at FAMILY_SHAPES in bf16: the LoRA tangents
    (M = 256, a client's 8 x 32 tokens; T=4, the phase's K, timed, and T=1)
    of wq and wv, whisper's encoder wq at M = 3000 (two requests' 1500
    frames); the attention primal and tangents (T in {0, 1, 4}, timed at 0
    and 4) and their contraction (T=4, timed); the multi-adapter projection
    of wq and wv at the engine's decode (M=4, P=4, r=1, cold). Each on the
    route its wrapper must take, held as phase 3 holds every case."""
    import torch
    bf = torch.bfloat16
    for arch, wq, wv, (B, H, KV, S, hd) in FAMILY_SHAPES:
        for K, N in dict.fromkeys((wq, wv)):
            for T in (1, 4):
                res = lora_case(256, K, N, 1, T, True, bf, gen, timed=T == 4)
                if T == 4:
                    extra[f"lora_dual_mt {arch} M=256 K={K} N={N} T=4"] = res
            res = lora_multi_case(4, K, N, 4, 1, bf, gen, timed=True, cold=True)
            extra[f"lora_dual_multi {arch} M=4 K={K} N={N} P=4 r=1"] = res
        if arch == "whisper-tiny":
            extra[f"lora_dual_mt {arch} encoder M=3000 K=384 N=384 T=4"] = lora_case(
                3000, 384, 384, 1, 4, True, bf, gen, timed=True)
        tag = f"{arch} B={B} H={H} KV={KV} S={S} hd={hd}"
        for T in (0, 1, 4):
            res = swa_case(B, H, KV, S, hd, None, T, bf, gen, timed=T != 1)
            if T != 1:
                extra[f"{'swa_attention_mt' if T else 'swa_attention'} {tag} T={T}"] = res
        extra[f"swa_attention_mt_jvps {tag} T=4"] = note(
            "swa_attention_mt_jvps", bf, swa_jvps_case(B, H, KV, S, hd, None, 4, bf, gen,
                                                       True))


def mamba2_inputs(B, S, H, hd, N, T, gen):
    """Recurrence operands at the model's scales: decay in (0, 1)."""
    import torch
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    prim = (rn(B, S, H, hd) * 0.3, rn(B, S, N) * 0.3, rn(B, S, N) * 0.3,
            torch.sigmoid(rn(B, S, H)))
    tang = (rn(T, B, S, H, hd) * 0.3, rn(T, B, S, N) * 0.3, rn(T, B, S, N) * 0.3,
            rn(T, B, S, H) * 0.1)
    return prim, tang, rn(B, S, H, hd)


def mamba2_flops(B, S, H, hd, N, T):
    """fp32 operations of the primal, the tangent pass and the contraction:
    for each, the lesser of the recurrent form's count and the chunked
    (state-space-dual) form's, so a chunked kernel is never held to the
    recurrent form's work."""
    el = B * S * H * hd * N              # state elements walked a token
    contract = 2 * T * B * S * H * hd
    # recurrent: the state update h <- d h + x B^T 3 flops an element, the
    # readout y = h C 2 (the primal only); a tangent's update 7, its two
    # readouts 4
    rec_p, rec_t = 5 * el, 3 * el + 11 * T * el
    # chunked, per chunk of q <= 32 tokens and its lower triangles of
    # p = q (q + 1) / 2 entries: G = C B^T 2 N p a batch row; L o G 2 p a
    # head (L by running products) and y = (L o G) x 2 hd p. After the
    # first chunk the readout Lc C h^T, 2 q N hd + 2 q hd a head; before
    # the last the update h <- Lc h + x^T diag(L) B, 2 q hd N + 2 hd N. A
    # tangent: Gd = Cd B^T + C Bd^T 4 N p a batch row; Ld and
    # Ld o G + L o Gd 6 p, yd 4 hd p a head; its readout and its update
    # three products each (hd, h Cd, h Lcd; xd, Ld, Bd), 2 q hd N apiece
    ch_p = ch_state = ch_t = 0
    for s0 in range(0, S, 32):
        q = min(32, S - s0)
        p = q * (q + 1) // 2
        readout, update = s0 > 0, s0 + q < S
        state = (2 * N * p * B + 2 * p * B * H
                 + update * (2 * q * hd * N + 2 * hd * N) * B * H)
        ch_state += state
        ch_p += state + (2 * hd * p + readout * (2 * q * N * hd + 2 * q * hd)) * B * H
        head = 6 * p + 4 * hd * p + (readout + update) * 6 * q * hd * N
        ch_t += 4 * N * p * B + head * B * H
    return {"mamba2_scan": min(rec_p, ch_p),
            "mamba2_scan_mt": min(rec_t, ch_state + T * ch_t),
            "mamba2_scan_mt_jvps": min(rec_t, ch_state + T * ch_t) + contract}


def mamba2_cases(B, S, H, hd, N, T, gen, timed, plain_once=False):
    """The three mamba2 kernels on one problem (fp32, their only dtype):
    primal and tangents against the plain versions (``close``), the
    contraction on the route ``mamba2_jvps_path`` gives against JVPS_RTOL x
    sum|terms| and, on route chunk, against the fp64 contraction of the
    tangents (``fp64_contraction``). ``plain_once``: the plain
    versions' times are the one call of each that gives the reference (a
    walk of one launch a token and op) instead of graph replays. Returns
    {kernel: result}."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops
    prim, tang, gy = mamba2_inputs(B, S, H, hd, N, T, gen)
    shape = f"B={B} S={S} H={H} hd={hd} N={N}"
    out = {}
    y = ops.mamba2_scan(*prim)
    plain_ms = {}
    if plain_once:
        y_ref, plain_ms["mamba2_scan"] = timed_once(lambda: ops.mamba2_scan_ref(*prim)[0])
        (_, yd_ref), plain_ms["mamba2_scan_mt"] = timed_once(
            lambda: ops.mamba2_scan_mt_ref(*prim, *tang))
    else:
        y_ref, yd_ref = ops.mamba2_scan_mt_ref(*prim, *tang)
    yd = ops.mamba2_scan_mt_tangents(*prim, *tang)
    route = ops.mamba2_jvps_path(S)
    jv = took_path(f"mamba2_scan_mt_jvps {shape} T={T}",
                   ops.launches_by_path["mamba2_scan_mt_jvps"], route,
                   lambda: ops.mamba2_scan_mt_jvps(*prim, *tang, gy))
    jv_ref = torch.einsum("bshd,tbshd->t", gy, yd_ref)
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    torch.cuda.synchronize()
    out["mamba2_scan"] = {"max_abs_err": close(f"mamba2_scan {shape}", y, y_ref,
                                               torch.float32)}
    out["mamba2_scan_mt"] = {"max_abs_err": close(
        f"mamba2_scan_mt {shape} T={T}", yd, yd_ref, torch.float32)}
    err, rel = close_jvps(f"mamba2_scan_mt_jvps {shape} T={T}", jv, jv_ref, mag)
    out["mamba2_scan_mt_jvps"] = {"max_abs_err": err, "err_over_terms": rel, "path": route}
    del yd_ref
    if route == "chunk":     # the tangents contracted are row 11's, in fp64
        out["mamba2_scan_mt_jvps"].update(fp64_contraction(
            f"mamba2_scan_mt_jvps {shape} T={T}",
            lambda: ops.mamba2_scan_mt_jvps(*prim, *tang, gy), jv, yd, gy))
    del yd
    if timed:
        # bound = max(bytes / 3.35 TB/s, flops / 67 TFLOP/s): each input read
        # once, each output written once; flops from ``mamba2_flops``
        prim_bytes = 4 * (2 * B * S * H * hd + 2 * B * S * N + B * S * H)
        tang_bytes = 4 * T * (2 * B * S * H * hd + 2 * B * S * N + B * S * H)
        flops = mamba2_flops(B, S, H, hd, N, T)
        costs = {"mamba2_scan": (flops["mamba2_scan"], prim_bytes),
                 "mamba2_scan_mt": (flops["mamba2_scan_mt"],
                                    prim_bytes - 4 * B * S * H * hd + tang_bytes),
                 "mamba2_scan_mt_jvps": (flops["mamba2_scan_mt_jvps"],
                                         prim_bytes + tang_bytes
                                         - 4 * T * B * S * H * hd + 4 * T)}
        runs = {"mamba2_scan": (lambda: ops.mamba2_scan(*prim),
                                lambda: ops.mamba2_scan_ref(*prim)),
                "mamba2_scan_mt": (lambda: ops.mamba2_scan_mt_tangents(*prim, *tang),
                                   lambda: ops.mamba2_scan_mt_ref(*prim, *tang)),
                "mamba2_scan_mt_jvps": (
                    lambda: ops.mamba2_scan_mt_jvps(*prim, *tang, gy),
                    lambda: ops.mamba2_scan_mt_jvps_ref(*prim, *tang, gy))}
        if plain_once:
            plain_ms["mamba2_scan_mt_jvps"] = timed_once(runs["mamba2_scan_mt_jvps"][1])[1]
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
            res["plain_ms"] = plain_ms.get(name) or time_ms(runs[name][1])
            res["library_ms"] = None
            res["yardstick_ms"] = time_ms(yard[name])
            if name != "mamba2_scan_mt_jvps":   # rows 10 and 11 called eagerly
                res["eager_ms"] = time_ms(runs[name][0], graph=False)
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


def wkv6_flops(B, S, H, hd, T, has_ud=False):
    """fp32 operations of the primal, the tangent pass and the contraction:
    for each, the lesser of the recurrent form's count and the chunked
    form's (``ops.wkv6_chunked_ref``), so a chunked kernel is never held to
    the recurrence's work."""
    n = B * S * H * hd                   # elements of one (B,S,H,hd) stream
    el = n * hd                          # state elements walked
    contract = 2 * T * n
    # recurrent, per state element and token: the decay update S <- w S +
    # k v^T 3, the readout r^T S 2 (the tangent modes emit no y); per tangent
    # the update Sd <- wd S + w Sd + kd v^T + k vd^T 7 and the readouts rd^T S
    # and r^T Sd 2 each. The bonus term (r . (u k)) v_j costs O(hd) a token
    # and head, per element of n: the scalar a = r . (u k) 3 and y += a v 2;
    # in the tangent modes a, the products r u (and r k with a tangent of u)
    # 1 each, then per tangent ad = rd . (u k) + (r u) . kd (+ (r k) . ud)
    # 4 (+2) and yd += ad v + a vd 4.
    rec_p = 5 * el + 5 * n
    rec_t = 3 * el + (4 + has_ud) * n + T * (11 * el + (8 + 2 * has_ud) * n)
    # chunked, per chunk of q <= 32 tokens, head and channel, over its p =
    # q (q - 1) / 2 pairs s' < s: L by running products 1 a pair, A's terms
    # r (k L) and their sum 3; the diagonal u (r k) and its sum 3 a token; y
    # = A v 2 (p + q) a value column. A tangent: Ld 2 a pair, Ad's terms r (k
    # Ld + kd L) + rd (k L) and their sum 8; its diagonal 5 (+2 with a
    # tangent of u) a token; yd = Ad v + A vd 4 (p + q) a column. After the
    # first chunk the readout of the carried state: Lc 1 and r Lc 1 a token
    # and channel and (r Lc)^T S 2 hd; a tangent's Lcd 2, rd Lc + r Lcd 3 and
    # two such products 4 hd. Before the last the state's update: S <- Lq S
    # + (k Lend)^T v, 2 hd^2 + q hd + 2 q hd^2 a head; a tangent's Sd <- Lqd
    # S + Lq Sd + (kd Lend + k Lendd)^T v + (k Lend)^T vd, 3 hd^2 + 3 q hd +
    # 4 q hd^2.
    ch_p = ch_state = ch_t = 0
    for s0 in range(0, S, 32):
        q = min(32, S - s0)
        p = q * (q - 1) // 2
        readout, update = s0 > 0, s0 + q < S
        state = ((4 * p + 3 * q) * hd + readout * (2 * q * hd + 2 * q * hd * hd)
                 + update * (2 * hd * hd + q * hd + 2 * q * hd * hd))
        ch_state += state
        ch_p += state + 2 * (p + q) * hd
        ch_t += ((10 * p + (5 + 2 * has_ud) * q) * hd + 4 * (p + q) * hd
                 + readout * (5 * q * hd + 4 * q * hd * hd)
                 + update * (3 * hd * hd + 3 * q * hd + 4 * q * hd * hd))
    ch_p, ch_state, ch_t = (x * B * H for x in (ch_p, ch_state, ch_t))
    tang = min(rec_t, ch_state + T * ch_t)
    return {"wkv6_scan": min(rec_p, ch_p), "wkv6_scan_mt": tang,
            "wkv6_scan_mt_jvps": tang + contract}


def wkv6_inputs(B, S, H, hd, T, has_ud, gen):
    """Recurrence operands at the model's scales: r, k, v ~ N(0, 0.25), the
    decay w = exp(-exp(0.5 + 0.5 z)) in (0, 1) as rwkv6's w0 = 0.5 gives."""
    import torch
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    prim = (rn(B, S, H, hd) * 0.5, rn(B, S, H, hd) * 0.5, rn(B, S, H, hd) * 0.5,
            torch.exp(-torch.exp(0.5 + 0.5 * rn(B, S, H, hd))), rn(H, hd) * 0.3)
    tang = (rn(T, B, S, H, hd) * 0.3, rn(T, B, S, H, hd) * 0.3,
            rn(T, B, S, H, hd) * 0.3, rn(T, B, S, H, hd) * 0.05)
    uds = rn(T, H, hd) * 0.3 if has_ud else None
    return prim, tang, uds, rn(B, S, H, hd)


def wkv6_cases(B, S, H, hd, T, has_ud, gen):
    """The three wkv6 kernels on one problem (fp32, their only dtype):
    primal and tangents against the plain versions (``close``), the
    contraction against JVPS_RTOL x sum|terms| and, on route chunk, against
    the fp64 contraction of the tangents (``fp64_contraction``); the
    tangents and the contraction each on the route its rule gives
    (``wkv6_mt_path``, ``wkv6_jvps_path``); every case timed with its
    bound, plain time (the one call of each plain version that gives the
    reference: a walk of one launch a token and op, up to a second at
    S=1024) and yardstick. Returns {kernel: result}."""
    import torch
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = wkv6_inputs(B, S, H, hd, T, has_ud, gen)
    shape = f"B={B} S={S} H={H} hd={hd} T={T} ud={has_ud}"
    out = {}
    route = ops.wkv6_mt_path(S)
    y = ops.wkv6_scan(*prim)
    yd = took_path(f"wkv6_scan_mt {shape}", ops.launches_by_path["wkv6_scan_mt"],
                   route, lambda: ops.wkv6_scan_mt_tangents(*prim, *tang, uds))
    jroute = ops.wkv6_jvps_path(S)
    jv = took_path(f"wkv6_scan_mt_jvps {shape}", ops.launches_by_path["wkv6_scan_mt_jvps"],
                   jroute, lambda: ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds))
    plain_ms = {}
    (y_ref, _), plain_ms["wkv6_scan"] = timed_once(lambda: ops.wkv6_scan_ref(*prim))
    (_, yd_ref), plain_ms["wkv6_scan_mt"] = timed_once(
        lambda: ops.wkv6_scan_mt_ref(*prim, *tang, uds))
    jv_ref, plain_ms["wkv6_scan_mt_jvps"] = timed_once(
        lambda: ops.wkv6_scan_mt_jvps_ref(*prim, *tang, gy, uds))
    mag = (gy[None] * yd_ref).abs().sum(dim=(1, 2, 3, 4))
    torch.cuda.synchronize()
    out["wkv6_scan"] = {"max_abs_err": close(f"wkv6_scan {shape}", y, y_ref,
                                             torch.float32)}
    out["wkv6_scan_mt"] = {"max_abs_err": close(f"wkv6_scan_mt {shape}", yd, yd_ref,
                                                torch.float32), "path": route}
    err, rel = close_jvps(f"wkv6_scan_mt_jvps {shape}", jv, jv_ref, mag)
    out["wkv6_scan_mt_jvps"] = {"max_abs_err": err, "err_over_terms": rel, "path": jroute}
    del yd_ref
    if jroute == "chunk":    # the tangents contracted are row 8's, in fp64
        out["wkv6_scan_mt_jvps"].update(fp64_contraction(
            f"wkv6_scan_mt_jvps {shape}",
            lambda: ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds), jv, yd, gy))
    if route == "chunk" and T <= 8:     # the kernel's own algorithm, in plain torch
        out["wkv6_scan_mt"]["max_abs_err_chunked"] = close(
            f"wkv6_scan_mt {shape} vs wkv6_chunked_ref", yd,
            ops.wkv6_chunked_ref(*prim, *tang, uds)[1], torch.float32)
    del yd
    n = B * S * H * hd                   # elements of one (B,S,H,hd) stream
    # bytes: each input read once, each output written once; flops from
    # ``wkv6_flops``
    ud_el = T * H * hd * has_ud
    flops = wkv6_flops(B, S, H, hd, T, has_ud)
    costs = {"wkv6_scan": (flops["wkv6_scan"], 4 * (5 * n + H * hd)),
             "wkv6_scan_mt": (flops["wkv6_scan_mt"],
                              4 * (4 * n + H * hd + 5 * T * n + ud_el)),
             "wkv6_scan_mt_jvps": (flops["wkv6_scan_mt_jvps"],
                                   4 * (5 * n + H * hd + 4 * T * n + ud_el + T))}
    runs = {"wkv6_scan": lambda: ops.wkv6_scan(*prim),
            "wkv6_scan_mt": lambda: ops.wkv6_scan_mt_tangents(*prim, *tang, uds),
            "wkv6_scan_mt_jvps": lambda: ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds)}
    # no one PyTorch call computes a linear recurrence; the yardstick is the
    # batched GEMM of its quadratic form, (S x S) decayed scores times v, per
    # head (and tangent); for the contraction, the multi-tangent kernel
    # followed by the contraction (the route it replaces)
    g = torch.randn((B * H, S, S), generator=gen, device="cuda")
    vb = prim[2].permute(0, 2, 1, 3).reshape(B * H, S, hd).contiguous()
    gt, vt = g.expand(T, -1, -1, -1), vb.expand(T, -1, -1, -1)
    yard = {"wkv6_scan": lambda: torch.matmul(g, vb),
            "wkv6_scan_mt": lambda: torch.matmul(gt, vt),
            "wkv6_scan_mt_jvps": lambda: torch.einsum(
                "bshd,tbshd->t", gy, ops.wkv6_scan_mt_tangents(*prim, *tang, uds))}
    for name, (flops, nbytes) in costs.items():
        res = out[name]
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, torch.float32)
        res["ms"] = time_ms(runs[name])
        res["plain_ms"] = plain_ms[name]
        res["library_ms"] = None
        res["yardstick_ms"] = time_ms(yard[name])
        if name != "wkv6_scan_mt_jvps":   # rows 7 and 8 called eagerly
            res["eager_ms"] = time_ms(runs[name], graph=False)
        log(f"[kernels] {name} {shape}: " + json.dumps(res))
    return out


def wkv6_lanes_and_repeats(B, S, H, hd, has_ud, gen):
    """A T=8 launch against eight T=1 launches, bit for bit, for the
    tangents and the contraction; two contraction launches on the same
    inputs give the same jvps."""
    import torch
    from repro_torch.kernels.wkv6_scan import ops
    prim, tang, uds, gy = wkv6_inputs(B, S, H, hd, 8, has_ud, gen)
    yd = ops.wkv6_scan_mt_tangents(*prim, *tang, uds)
    jv = ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds)
    for t in range(8):
        one = tuple(x[t:t + 1].contiguous() for x in tang)
        ud1 = None if uds is None else uds[t:t + 1].contiguous()
        if not torch.equal(ops.wkv6_scan_mt_tangents(*prim, *one, ud1)[0], yd[t]):
            raise AssertionError(f"wkv6_scan_mt: tangent {t} of a T=8 launch is "
                                 f"not bitwise its T=1 launch")
        if not torch.equal(ops.wkv6_scan_mt_jvps(*prim, *one, gy, ud1)[0], jv[t]):
            raise AssertionError(f"wkv6_scan_mt_jvps: tangent {t} of a T=8 launch "
                                 f"is not bitwise its T=1 launch")
    if not torch.equal(ops.wkv6_scan_mt_jvps(*prim, *tang, gy, uds), jv):
        raise AssertionError("wkv6_scan_mt_jvps: two launches on the same "
                             "inputs differ")
    log(f"[kernels] wkv6 B={B} S={S} H={H} hd={hd} ud={has_ud}: T=8 lanes bitwise "
        f"equal to T=1 launches (tangents and jvps), jvps repeat bitwise")


L2_ROTATE_BYTES = 120e6     # over twice the H100's 50 MB L2


def lora_multi_case(M, K, N, P, r, dtype, gen, timed, cold=False):
    """The multi-adapter projection: idx covers every page (with repeats when
    M > P), then random pages. On the route its rule gives; two launches on
    the same inputs are bitwise equal. Timed warm (one W, which the L2 may
    hold across graph replays) and, where W is a quarter of the L2 or more
    or ``cold`` asks, cold: each call reads the next of enough copies of W
    to pass L2_ROTATE_BYTES, as the engine's decode step finds each
    projection's W (llama2-7b: 64 of them among 12.5 GiB of weights)."""
    import itertools

    import torch
    from repro_torch.kernels.lora_dual import ops
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x = rn(M, K).to(dtype)
    w = (rn(K, N) / math.sqrt(K)).to(dtype)
    a, b = rn(P, K, r) / math.sqrt(K), rn(P, r, N)
    head = torch.arange(min(P, M), device="cuda")
    idx = torch.cat([head, torch.randint(0, P, (M - len(head),), generator=gen,
                                         device="cuda")]).to(torch.int32)
    name = f"lora_dual_multi M={M} K={K} N={N} P={P} r={r} {dtype}"
    path = ops.lora_multi_path(dtype, M, K, N)
    out = took_path(name, ops.launches_by_path["lora_dual_multi"], path,
                    lambda: ops.lora_dual_multi(x, idx, w, a, b, 0.5))
    again = ops.lora_dual_multi(x, idx, w, a, b, 0.5)
    ref = ops.lora_dual_multi_ref(x.float(), idx, w.float(), a, b, 0.5)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    res = {"path": path, "max_abs_err": close(name, out, ref, dtype), "repeat_bitwise": True}
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
        w_bytes = w.numel() * es
        if cold or 4 * w_bytes >= 50e6:
            ws = [w] + [w.clone() for _ in range(math.ceil(L2_ROTATE_BYTES / w_bytes) - 1)]
            cold_fns = {"cold_ms": lambda wi: ops.lora_dual_multi(x, idx, wi, a, b, 0.5),
                        "plain_cold_ms": lambda wi: ops.lora_dual_multi_ref(x, idx, wi, a, b,
                                                                            0.5),
                        "yardstick_cold_ms": lambda wi: torch.matmul(x, wi)}
            for key, fn in cold_fns.items():
                it = itertools.cycle(ws)
                res[key] = time_ms(lambda fn=fn, it=it: fn(next(it)))
            res["w_copies"] = len(ws)
            del ws
    log(f"[kernels] {name}: " + json.dumps(res))
    return res


def phase_kernels():
    """Every case; returns the timed main-path case of each kernel
    (roberta-large shapes in bf16, the full-size dtype, T=8; for the
    multi-adapter projection llama2-7b's engine decode, M=4, in bf16; for
    the recurrences zamba2's and rwkv6-1.6b's in fp32, T=8)."""
    import torch
    global _SIDE_STREAM
    gc.collect()
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main, worst, extra = {}, {}, {}

    def note(name, dtype, res):         # the largest err / sum|terms| seen
        key = f"{name} {dtype}"
        worst[key] = max(worst.get(key, 0.0), res["err_over_terms"])
        if "err_over_terms_fp64" in res:
            key += " vs fp64"
            worst[key] = max(worst.get(key, 0.0), res["err_over_terms_fp64"])
        return res

    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for K in (1024, 4096):              # roberta-large, llama2-7b widths
            for T in (1, 8):
                for has_xd in (True, False):
                    res = lora_case(8 * 32, K, K, 1, T, has_xd, dtype, gen,
                                    timed=(bf and (T == 8 or has_xd)))
                    if bf and K == 1024 and T == 8 and has_xd:
                        main["lora_dual_mt"] = res
                    if bf and (T == 8 or has_xd):
                        extra[f"lora_dual_mt K=N={K} T={T} xd={has_xd}"] = res
                    res = note("lora_dual_mt_jvps", dtype, lora_jvps_case(
                        8 * 32, K, K, 1, T, has_xd, dtype, gen, timed=(bf and T == 8)))
                    if bf and K == 1024 and T == 8 and has_xd:
                        main["lora_dual_mt_jvps"] = res
                    if bf and T == 8:
                        extra[f"lora_dual_mt_jvps K=N={K} T=8 xd={has_xd}"] = res
        for T in (1, 8):                    # odd M, N, K and rank
            for has_xd in (True, False):
                note("lora_dual_mt_jvps", dtype, lora_jvps_case(
                    37, 100, 72, 3, T, has_xd, dtype, gen, timed=False))
        note("lora_dual_mt_jvps", dtype, lora_jvps_case(   # rank, tangent limits
            70, 33, 65, 16, 64, True, dtype, gen, timed=False))
        for has_xd in (True, False):        # M, K and N off the tc tiles, rank 16
            note("lora_dual_mt_jvps", dtype, lora_jvps_case(
                200, 1032, 1032, 16, 3, has_xd, dtype, gen, timed=False))
        note("lora_dual_mt_jvps", dtype, lora_jvps_case(    # 64 tangents through the ring
            64, 1024, 1024, 1, 64, True, dtype, gen, timed=False))
        # the tangent kernel's routes at their edges: T = 64, rank 16, M = 200
        # with T = 3 (a 128-row tile straddles two tangents), rank 16 at
        # llama2-7b widths; K or N off the 8-element alignment (simt in bf16)
        for M, K, N, r, T in ((256, 1024, 1024, 1, 64), (256, 1024, 1024, 16, 64),
                              (200, 1024, 1024, 16, 3), (200, 1024, 1024, 1, 3),
                              (256, 4096, 4096, 16, 8), (37, 100, 72, 3, 3),
                              (64, 1024, 1020, 2, 2)):
            for has_xd in (True, False):
                lora_case(M, K, N, r, T, has_xd, dtype, gen, timed=False)
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
                        if bf and T == 0 and window is None and KV == H:
                            extra[f"swa_attention B={B} H={H} S={S} hd={hd}"] = res
                        if bf and T == 8 and window is None and KV == H:
                            extra[f"swa_attention_mt B={B} H={H} S={S} hd={hd} T=8"] = res
                        if T:
                            res = note("swa_attention_mt_jvps", dtype, swa_jvps_case(
                                B, H, KV, S, hd, window, T, dtype, gen, timed))
                            if bf and si == 0 and window is None and KV == H and T == 8:
                                main["swa_attention_mt_jvps"] = res
                            if bf and T == 8:
                                extra[f"swa_attention_mt_jvps B={B} H={H} KV={KV} S={S} "
                                      f"hd={hd} window={window} T=8"] = res
        # the primal's routes at short and odd S and at S = 2048 with hd = 64
        # (hd 48: a 16 multiple off the configs' widths; hd 40: padded to 48
        # inside the tensor-core kernel; hd 36: off the 8 multiple, simt)
        for B, H, S, hd in ((2, 8, 1, 64), (2, 8, 1, 128), (2, 8, 17, 64),
                            (2, 8, 17, 128), (1, 16, 2048, 64), (2, 4, 33, 48),
                            (2, 4, 33, 40), (2, 4, 33, 36)):
            for window in (None, 256):
                for KV in (H, H // 4):
                    timed = bf and window is None and KV == H and S == 2048
                    res = swa_case(B, H, KV, S, hd, window, 0, dtype, gen, timed)
                    if timed:
                        extra[f"swa_attention B={B} H={H} S={S} hd={hd}"] = res
        dense_width_cases(dtype, gen, extra, note)
    family_width_cases(gen, extra, note)
    # the bf16 contraction epilogues' lanes: LoRA at roberta-large's and
    # llama2-7b's widths and off the tiles, with and without an input tangent;
    # attention at both head widths (two tangents a group, one) and with four
    # a group over two key buffers and a band
    for M, K, N, r in ((256, 1024, 1024, 1), (256, 4096, 4096, 1), (200, 1032, 1032, 16)):
        for has_xd in (True, False):
            lora_jvps_lanes_and_repeats(M, K, N, r, has_xd, gen)
    for B, H, KV, S, hd, window in ((8, 16, 16, 32, 64, None), (8, 32, 32, 32, 128, None),
                                    (2, 8, 2, 100, 128, 40), (1, 4, 1, 150, 32, 64)):
        swa_jvps_lanes_and_repeats(B, H, KV, S, hd, window, gen)
    # the dense configs' widths: gemma3-12b's hd 256 (the wide plan, its
    # column halves; at S = 100 two key tiles through its one buffer and a
    # band) and h2o-danube's hd 120 (padded to 128)
    for B, H, KV, S, hd, window in ((8, 16, 8, 32, 256, None), (2, 16, 8, 100, 256, 40),
                                    (8, 32, 8, 32, 120, None), (2, 32, 8, 100, 120, 40)):
        swa_jvps_lanes_and_repeats(B, H, KV, S, hd, window, gen)
    # the wide plan at widths no config has whose 16-column groups do not
    # come in fours (hd 144: 10 groups, hd 200: 14, padded to 224): primal,
    # tangents and contraction against the plain versions
    for B, H, KV, S, hd, window in ((2, 4, 4, 100, 144, 40), (1, 4, 2, 70, 200, None)):
        for T in (0, 2):
            swa_case(B, H, KV, S, hd, window, T, torch.bfloat16, gen, False)
        note("swa_attention_mt_jvps", torch.bfloat16, swa_jvps_case(
            B, H, KV, S, hd, window, 2, torch.bfloat16, gen, False))
    # the mamba2 recurrence (fp32 only): zamba2's shapes (one client estimate,
    # B=8, S=32, H=64, hd=N=64, one 32-token chunk), one token past the chunk
    # (S=33), a ragged shape (odd S; hd, N and B*H*hd not multiples of 32 or
    # of 16) and N > 64, three chunks with hd=40 (the chunk carry); T in
    # {1, 8, 64}, timed at zamba2's shapes (T=1 and T=64: each plain version
    # in one call). Then zamba2's widths at S=1024 (32 chunks), T in {1, 8}
    for (B, S, H, hd, N) in ((8, 32, 64, 64, 64), (2, 33, 64, 64, 64),
                             (3, 37, 5, 24, 20), (2, 19, 3, 40, 100),
                             (2, 70, 3, 40, 64)):
        for T in (1, 8, 64):
            timed = B == 8
            res = mamba2_cases(B, S, H, hd, N, T, gen, timed, plain_once=T != 8)
            note("mamba2_scan_mt_jvps", torch.float32, res["mamba2_scan_mt_jvps"])
            if timed:
                extra[f"mamba2_scan_mt_jvps B={B} S={S} H={H} hd={hd} N={N} T={T}"] = \
                    res["mamba2_scan_mt_jvps"]
            if (B, T) == (8, 8):
                main.update(res)
    for T in (1, 8):
        res = mamba2_cases(1, 1024, 64, 64, 64, T, gen, timed=True, plain_once=True)
        note("mamba2_scan_mt_jvps", torch.float32, res["mamba2_scan_mt_jvps"])
        extra[f"mamba2_scan_mt_jvps B=1 S=1024 H=64 hd=64 N=64 T={T}"] = \
            res["mamba2_scan_mt_jvps"]
    mamba2_lanes_and_repeats(8, 32, 64, 64, 64, gen)
    mamba2_lanes_and_repeats(3, 29, 5, 24, 20, gen)
    mamba2_lanes_and_repeats(3, 37, 5, 24, 20, gen)
    mamba2_lanes_and_repeats(2, 70, 3, 40, 64, gen)
    # the wkv6 recurrence (fp32 only): rwkv6-1.6b's shapes (one client
    # estimate, B=8, S=32, H=32, hd=64; the tangents' chunk route), two
    # ragged shapes (odd S on either tangent route, B*H = 15, hd not a
    # multiple of the 32-column tile or the 16-byte rows of 8) and a long
    # sequence; T in {1, 8, 64}, with and without a tangent of u (the path
    # passes none)
    for (B, S, H, hd) in ((8, 32, 32, 64), (3, 29, 5, 40), (3, 37, 5, 40),
                          (1, 1024, 4, 64)):
        for T in (1, 8, 64):
            for has_ud in (False, True):
                res = wkv6_cases(B, S, H, hd, T, has_ud, gen)
                note("wkv6_scan_mt_jvps", torch.float32, res["wkv6_scan_mt_jvps"])
                extra[f"wkv6_scan_mt_jvps B={B} S={S} H={H} hd={hd} T={T} ud={has_ud}"] = \
                    res["wkv6_scan_mt_jvps"]
                if (B, T, has_ud) == (8, 8, False):
                    main.update(res)
    for has_ud in (False, True):
        wkv6_lanes_and_repeats(8, 32, 32, 64, has_ud, gen)
        wkv6_lanes_and_repeats(3, 29, 5, 40, has_ud, gen)
        wkv6_lanes_and_repeats(3, 37, 5, 40, has_ud, gen)
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
        # the stream route's edges: one row, 16 rows with rank 16, K off the
        # 8 slices, N a multiple of 8 but not of the 128-column strip
        for M, K, N, P, r in ((1, 4096, 4096, 1, 1), (16, 4096, 4096, 6, 16),
                              (7, 1000, 136, 3, 2)):
            lora_multi_case(M, K, N, P, r, dtype, gen, timed=False)
    # the engine decode's other projections (M = 4, P = 4, r = 1, bf16), each W
    # read cold as in a decode step: rwkv6-1.6b's wr / wv and zamba2-1.2b's
    # shared wq / wv (2048 x 2048), zamba2's in_proj (2048 x 8192) and
    # out_proj (4096 x 2048)
    for K, N in ((2048, 2048), (2048, 8192), (4096, 2048)):
        lora_multi_case(4, K, N, 4, 1, torch.bfloat16, gen, timed=True, cold=True)
    # command-r-plus-104b's decode projections (K = d_model = 12288, the
    # stream route's largest K): wq (12288 x 12288) and wv (12288 x 1024)
    for K, N in ((12288, 12288), (12288, 1024)):
        res = lora_multi_case(4, K, N, 4, 1, torch.bfloat16, gen, timed=True, cold=True)
        extra[f"lora_dual_multi M=4 K={K} N={N} P=4 r=1"] = res
    log(f"[kernels] contraction epilogues, largest err / sum|terms| (limit "
        f"{JVPS_RTOL}; 'vs fp64': the scan epilogues' chunk route against the "
        f"fp64 contraction of the tangents, limit {FP64_RTOL}): " + json.dumps(worst))
    log("[kernels] redesigned rows 1-5 (every timed bf16 case), 9 and 12 (every "
        "timed case): " + json.dumps(extra))
    # release what the timing holds (the side stream and the cuBLAS
    # workspaces), so the later phases' memory peaks do not depend on
    # whether this phase ran
    torch.cuda.synchronize()
    _SIDE_STREAM = None
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[kernels] device memory allocated before / after the phase: "
        f"{held_before / 2 ** 30:.3f} / {held / 2 ** 30:.3f} GiB")
    if held != held_before:
        raise AssertionError(f"phase 3 left {held - held_before} bytes allocated")
    return main


# ---------------------------------------------------------------------------
# phase 4: one reduced round, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

PARITY_RTOL = 1e-5     # card vs CPU, fp32 throughout: loss, jvps, server step
# card vs CPU end to end, the new PEFT, per config (see parity_round): about
# twice the largest reading on the H100 (PERF.md, Findings: roberta 5.0e-6,
# zamba2 1.38e-5). rwkv6 (scripts/parity_plain_on_card.py, standard / fused
# route): card vs CPU 4.73e-5 / 4.44e-5, the plain versions on the card
# 4.80e-5 / 4.76e-5, the kernels against the plain versions on the card
# 9.7e-6 / 8.7e-6
PEFT_RTOL = {"roberta-large-lora": 1e-5, "zamba2-1.2b": 3e-5, "rwkv6-1.6b": 1e-4}
# card vs CPU, the jvps, for a config whose jvps miss PARITY_RTOL with the
# plain versions on the card as well (scripts/parity_plain_on_card.py): about
# twice the larger reading. rwkv6, standard route (PERF.md, Findings): jvps
# 1.63e-5 with the kernels, 1.76e-5 with the plain versions on the card;
# end-to-end PEFT 4.73e-5 and 4.80e-5. The loss, the replayed PEFT and every
# other config keep PARITY_RTOL.
JVPS_RTOL_BY_ARCH = {"rwkv6-1.6b": 3.5e-5}


def parity_round(fused, arch="roberta-large-lora", card_out=None, **overrides):
    """One reduced SPRY round, kernels on the card against plain versions on
    the CPU; ``overrides`` replace fields of the reduced config (zamba2 with
    ``n_layers=3, hybrid_attn_every=2`` ends in a mamba2 site). Every
    config's LoRA B leaves are drawn non-zero (B = 0 at init), so the LoRA
    path is live. Returns the readings, checks nothing; ``card_out`` (a dict)
    receives the card round's jvps and PEFT leaves, on the host.

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
    for group, t in (("layers", "wq"), ("layers", "in_proj"), ("shared", "wq"),
                     ("layers", "wr")):
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
    if card_out is not None:
        card_out["jvps"] = gpu_met["jvps"].cpu()
        card_out["peft"] = [x.cpu() for x in tree_leaves(gpu_state.peft)]
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
    within PARITY_RTOL (the jvps within the config's JVPS_RTOL_BY_ARCH where
    it has one), the end-to-end PEFT within the config's PEFT_RTOL."""
    res = parity_round(fused, arch, **overrides)
    route = "fused" if fused else "standard"
    peft_rtol = PEFT_RTOL[arch]
    jvps_rtol = JVPS_RTOL_BY_ARCH.get(arch, PARITY_RTOL)
    log(f"[parity] reduced {arch} {overrides or ''} (final site {res['final_site']}), "
        f"1 spry round K=4, {route} route, card (kernels) vs cpu (limits "
        f"{PARITY_RTOL}, jvps {jvps_rtol}, end-to-end PEFT {peft_rtol}): "
        + json.dumps(res))
    if not (res["jvps_rel_err"] <= jvps_rtol
            and res["peft_rel_err_same_jvps"] <= PARITY_RTOL
            and res["peft_rel_err"] <= peft_rtol
            and abs(res["loss_gpu"] - res["loss_cpu"]) <= PARITY_RTOL * abs(res["loss_cpu"])):
        raise AssertionError(f"parity ({arch}, {route}): card round disagrees with "
                             f"cpu round {res}")


# ---------------------------------------------------------------------------
# phase 5: the single-projection LoRA estimator (SplitLoss kind 'lora')
# ---------------------------------------------------------------------------

def check_paths(what, paths, path_totals):
    """Every launch of rows 1-5 on the full-width training path is bf16 at
    aligned widths and must take a tensor-core route (``lora_dual_mt``: tc,
    or store where no input tangent exists; the ``swa_attention`` primal,
    tangents and contraction and the LoRA contraction: tc), never simt
    (training launches no row 6), and every launch of rows 8, 9 and 12 (S=32:
    the wkv6 tangents and the wkv6 and mamba2 contraction epilogues) the
    chunk route, never rec. Adds ``paths`` into ``path_totals``."""
    for k, by in paths.items():
        for off in ("simt", "rec"):
            if by.get(off):
                raise AssertionError(f"{what}: {by[off]} {k} launches took the {off} "
                                     f"route: {paths}")
        for route, n in by.items():
            path_totals[k][route] += n


def phase_site(totals, path_totals):
    """forward_gradient on a LoRA site at full widths, K=8: the fused route
    makes one LoRA contraction epilogue an estimate (plus, with an input
    tangent, the upstream projection's one multi-tangent launch) and agrees
    with the standard route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SplitLoss, forward_gradient
    from repro_torch.kernels import (dispatch, launch_counts, launch_paths,
                                     reset_launch_counts)

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
            counts, paths = launch_counts(), launch_paths()
            _, _, jvps_std = forward_gradient(split, peft, 7, 8)
            want = {k: 0 for k in counts}
            want.update({"lora_dual_mt_jvps": 1, "lora_dual_mt": int(x_has_tangent)})
            err = float((jvps - jvps_std).abs().max() / jvps_std.abs().max())
            res = {"arch": arch, "x_has_tangent": x_has_tangent, "loss": float(loss),
                   "jvps_rel_err_vs_standard": err, "launches": counts,
                   "paths": paths}
            log("[site] lora SplitLoss K=8: " + json.dumps(res))
            if counts != want:
                raise AssertionError(f"site {arch}: launches {counts} != {want}")
            check_paths(f"site {arch}", paths, path_totals)
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
           "mamba2_scan_mt", "mamba2_scan_mt_jvps", "lora_dual_multi",
           "wkv6_scan", "wkv6_scan_mt", "wkv6_scan_mt_jvps")


def round_launches(cfg, kind, estimates, peft="lora"):
    """The launches a round of ``estimates`` estimates must make on ``cfg``:
    per estimate, one primal and one multi-tangent kernel per mixer site and
    one multi-tangent LoRA kernel per adapted projection on the standard
    route. The fused route replaces the final site's tangent kernel by ONE
    contraction epilogue; at a mamba2 site the final layer's out_proj sits in
    the reversed post-head and launches nothing (at a wkv6 site the final
    layer's adapted wr and wv come before the site, so every LoRA launch
    stays). Reverse mode and the zero-order clients launch no kernel.

    ``peft`` other than lora (the dense family): no LoRA projection, and
    an attention site has a tangent only where the tree reaches its inputs:
    every layer under ia3 (k and v are scaled), every layer but the first
    under bitfit (its biases follow the attention), none under
    classifier_only, whose fused route then launches no epilogue either."""
    want = dict.fromkeys(KERNELS, 0)
    if kind not in ("standard", "fused"):
        return want
    L = cfg.n_layers
    if peft != "lora":
        if cfg.family != "dense":
            raise NotImplementedError(f"round_launches: peft {peft!r} on {cfg.family}")
        tangent = {"ia3": L, "bitfit": L - 1, "classifier_only": 0}[peft]
        per = {"swa_attention": L, "swa_attention_mt": tangent}
        if kind == "fused" and tangent:
            per["swa_attention_mt"] -= 1
            per["swa_attention_mt_jvps"] = 1
        want.update({k: n * estimates for k, n in per.items()})
        return want
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        sites = L // every                 # shared attention applications
        per = {"lora_dual_mt": 2 * L + 2 * sites,   # in_proj, out_proj; wq, wv
               "swa_attention": sites, "swa_attention_mt": sites,
               "mamba2_scan": L, "mamba2_scan_mt": L}
        final = "swa" if (L - 1) % every == every - 1 else "mamba2"
    elif cfg.family == "ssm":
        from repro_torch.peft.lora import default_lora_targets
        per = {"lora_dual_mt": len(default_lora_targets(cfg)) * L,   # wr, wv
               "wkv6_scan": L, "wkv6_scan_mt": L}
        final = "wkv6"
    elif cfg.family == "audio":
        # the encoder's wq, wv (its attention is non-causal: plain torch); the
        # decoder's self-attention wq, wv and cross-attention wq
        per = {"lora_dual_mt": 2 * cfg.encoder_layers + 3 * L,
               "swa_attention": L, "swa_attention_mt": L}
        final = "swa"
    else:
        per = {"lora_dual_mt": 2 * L,      # wq, wv per layer
               "swa_attention": L, "swa_attention_mt": L}
        final = "swa"
    if kind == "fused":
        if final == "swa":
            per["swa_attention_mt"] -= 1
            per["swa_attention_mt_jvps"] = 1
            if cfg.family == "audio":   # the final cross-attention's wq: post-head
                per["lora_dual_mt"] -= 1
        elif final == "wkv6":
            per["wkv6_scan_mt"] -= 1
            per["wkv6_scan_mt_jvps"] = 1
        else:
            per["mamba2_scan_mt"] -= 1
            per["mamba2_scan_mt_jvps"] = 1
            per["lora_dual_mt"] -= 1
    want.update({k: n * estimates for k, n in per.items()})
    return want


def phase_train(phases, totals, path_totals, cfg=None):
    """Each of ``phases`` through ``run_training``; ``cfg``: the config the
    runs are held to (``depth_cut``'s), else the arch's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    from repro_torch.launch.train import run_training

    results = []
    for arch, method, K, rounds, clients, fused in phases:
        cfg_run = cfg or get_config(arch)
        reset_launch_counts()
        hist = run_training(arch=arch, task="sst2", method=method, rounds=rounds,
                            clients_per_round=clients, batch_size=8,
                            k_perturbations=K, eval_every=1, reduced=False,
                            fused_contraction=fused, device="cuda",
                            log=lambda s: log("  " + s))
        torch.cuda.synchronize()
        counts, paths = launch_counts(), launch_paths()
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
               "launches": counts, "paths": paths,
               "round_launches": [h["launches"] for h in hist]}
        log(f"[train] {arch} {method} K={K} {kind}: " + json.dumps(res))
        check_paths(f"train {arch} {method}", paths, path_totals)
        if not all(math.isfinite(x) for x in res["loss"]):
            raise AssertionError(f"train {arch} {method}: loss not finite")
        for route, rl in zip(routes, res["round_launches"]):
            want = round_launches(cfg_run, route, clients)   # one estimate a client
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
    per adapted projection in each batched engine decode step, counted
    from the served peft tree: each target of a layer-stacked group once a
    layer, each target of the hybrid family's shared block once an
    application site (llama2-7b: wq, wv x 32 layers = 64; rwkv6-1.6b: wr,
    wv x 24 = 48; zamba2-1.2b: in_proj, out_proj x 38 + wq, wv x 6 = 88;
    whisper-tiny: wq, wv x 4 decoder layers and the cross-attention's wq x
    4 = 12). The B=1 admission prefill and encoding (a single-adapter page)
    and the greedy loop launch none."""
    import torch
    from repro_torch.configs import SpryConfig
    from repro_torch.launch.adapter_cache import _STACKED_GROUPS
    from repro_torch.models.hybrid import n_attn_sites
    from repro_torch.peft import init_peft
    tree = init_peft(cfg, torch.Generator().manual_seed(0), SpryConfig())
    per_step = sum(len(targets) * (cfg.n_layers if group in _STACKED_GROUPS
                                   else n_attn_sites(cfg))
                   for group, targets in tree.items()
                   if group not in ("head", "enc_layers"))
    if cfg.family == "audio":
        per_step += cfg.n_layers * sum(t in tree["layers"] for t in ("wq", "wo"))
    want = dict.fromkeys(KERNELS, 0)
    want["lora_dual_multi"] = per_step * decode_steps
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


def phase_serve_parity(arch="llama2-7b", **overrides):
    """One engine on the card (the multi-adapter kernel) and the same engine
    on the CPU (its plain version), ``arch`` reduced (and replaced by
    ``overrides``) in fp32, the same weights, adapters and requests: 5
    requests over 3 adapters, max_batch 2, capacity 2, so rows are admitted
    mid-flight and a page is evicted. Every decode step's logits within
    SERVE_RTOL, the same ids, cache stats and exactly ``serve_launches``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serving import Request
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(reduce_config(get_config(arch)), **overrides)
    gen = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_base(cfg, gen)
    cpu_store = SyntheticAdapterStore(cfg, seed=0, device="cpu")

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
    what = arch + "".join(f" {k}={v}" for k, v in overrides.items())
    log(f"[serve] reduced {what} fp32 engine, card (kernel) vs cpu (plain), limit "
        f"{SERVE_RTOL}: " + json.dumps(res))
    if not (len(log_c) == len(log_g) and max(errs) <= SERVE_RTOL and out_g == out_c
            and stats_g == stats_c and stats_g["evictions"] > 0
            and counts == serve_launches(cfg, len(log_g))):
        raise AssertionError(f"serve parity {what}: card engine disagrees with cpu {res}")


# the reference's ``request`` event (``repro/launch/serving.py``): envelope + fields
REQUEST_EVENT_KEYS = {"ts", "run_id", "kind", "request_id", "adapter_id", "prompt_len",
                      "gen_tokens", "ttft_s", "latency_s", "tok_per_sec"}


def serve_telemetry(arch="llama2-7b"):
    """The reduced ``arch`` engine on the card through ``run_engine``, with
    telemetry (in memory) and without: 5 requests over 3 adapters, max_batch
    2, capacity 2 (admissions mid-flight and evictions). Token ids
    bitwise equal, the same ``lora_dual_multi`` launches by route, one
    ``request`` event a request with the reference's fields, and the
    ``adapter_cache.*`` counters equal to ``AdapterCache.stats()``."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    from repro_torch.launch.serve import run_engine
    from repro_torch.obs import InMemorySink, Telemetry

    cfg = reduce_config(get_config(arch))
    runs = {}
    for on in (False, True):
        sink = InMemorySink()
        tel = Telemetry(run_id=f"chip-smoke-serve-{arch}", sinks=[sink]) if on else None
        reset_launch_counts()
        out, eng = run_engine(cfg, 5, 8, 6, max_batch=2, cache_capacity=2,
                              telemetry=tel, n_adapters=3, device="cuda")
        torch.cuda.synchronize()
        runs[on] = (out, launch_counts()["lora_dual_multi"],
                    launch_paths()["lora_dual_multi"], eng.adapters.stats(), sink, tel)
    (out_off, n_off, paths_off, _, _, _), (out_on, n_on, paths_on, stats, sink, tel) = (
        runs[False], runs[True])
    reqs = sink.by_kind("request")
    counters = tel.metrics_snapshot()["counters"]
    cache_counters = {k: int(counters[f"adapter_cache.{k}"])
                      for k in ("hits", "misses", "evictions")}
    res = {"ids_equal": out_on == out_off, "lora_dual_multi": [n_on, n_off],
           "by_route": [paths_on, paths_off], "request_events": len(reqs),
           "request_keys_equal": all(set(e) == REQUEST_EVENT_KEYS for e in reqs),
           "adapter_cache_counters": cache_counters, "adapter_cache_stats": stats,
           "serve.requests": counters["serve.requests"]}
    log(f"[serve] reduced {arch} engine, telemetry on vs off: " + json.dumps(res))
    if not (res["ids_equal"] and n_on == n_off > 0 and paths_on == paths_off
            and len(reqs) == len(out_on) == 5 and res["request_keys_equal"]
            and cache_counters == {k: stats[k] for k in cache_counters}
            and counters["serve.requests"] == 5):
        raise AssertionError(f"serve telemetry {arch}: {res}")


# full-depth bf16 logits, engine vs greedy, per arch: about twice the largest
# reading on the H100 (PERF.md, Findings). llama2-7b: 0.078-0.084 with the
# kernel, of logits with max 4.5: the kernel rounds x@W + s*u@B once where
# the plain primal rounds twice; that one-ulp difference at 64 projections
# grows through 32 bf16 layers. The engine with the plain version instead
# reproduces greedy to 0.0-0.031 (batching alone). rwkv6-1.6b: 0.114 with
# the kernel, 0.094 with the plain version (48 projections, 24 layers).
# zamba2-1.2b: 1.69 and 0.48, of logits with max 4.6, so at this limit the
# bf16 check bounds only gross faults. The kernel is held instead call by
# call: every launch of one engine decode step against its plain version
# on the path's own inputs (``hold_decode_step``), and the batched path by
# the fp32 witness below, whose readings say how far each arch carries one
# rounding difference (PERF.md, Findings; ROADMAP, Recorded deviations).
SERVE_BF16_ATOL = {"llama2-7b": 0.16, "rwkv6-1.6b": 0.25, "zamba2-1.2b": 3.5,
                   # phase 9's engines (4 requests on 4 adapters), about twice
                   # the largest reading over seeds 0-2, kernel (plain version):
                   # 0.111 (0.051), 0.117 (0.094), 0.078 (0.070); command-r at
                   # 8 layers 0.25 (0.039), one bf16 ulp of a logit in [32, 64):
                   # its logits reach 46, where the others' stay under 12. The
                   # fp32 witness reads 6-9e-6 on each (PERF.md, Findings)
                   "gemma3-12b": 0.25, "gemma3-27b": 0.25, "h2o-danube-3-4b": 0.16,
                   "command-r-plus-104b": 0.5,
                   # phase 10's, seeds 0-2, kernel (plain version): qwen3 0.277
                   # / 0.039 / 0.258 (0 / 0 / 0: a bf16 rounding of the
                   # kernel's flips a token's top-8 experts), llama4 0.066 /
                   # 0.070 / 0.063 (0 / 0.031 / 0), internvl2 0.077 / 0.086 /
                   # 0.086 (0.031 / 0.063 / 0.047), whisper 0.040 / 0.047 /
                   # 0.039 (0.0078 / 0.0039 / 0.0010)
                   "qwen3-moe-235b-a22b": 0.6, "llama4-maverick-400b-a17b": 0.15,
                   "internvl2-76b": 0.2, "whisper-tiny": 0.1}


# the fp32 witness (``serve_fp32_witness``): one batched engine decode step
# against the B=1 greedy steps at full width and depth in fp32, where a
# faithful batched path differs only by reduction order, on the card (the
# kernel, the plain version) and on the host CPU. About twice the largest
# card reading (PERF.md, Findings: 7.6e-6, 1.3e-5 and 2.1e-4, of logits with
# max 4.6-4.8); the CPU read 1.1e-5, 2.1e-5 and 1.9e-4. The dense configs
# (phase 9, on the card, DENSE_WITNESS_LAYERS' depth): about twice the
# largest over seeds 0-2, 8.4e-6, 9.4e-6, 6.7e-6 and 7.6e-6 (command-r,
# logits up to 52)
SERVE_FP32_ATOL = {"llama2-7b": 2e-5, "rwkv6-1.6b": 3e-5, "zamba2-1.2b": 5e-4,
                   "gemma3-12b": 2e-5, "gemma3-27b": 2e-5, "h2o-danube-3-4b": 1.5e-5,
                   "command-r-plus-104b": 2e-5,
                   # phase 10 (qwen3 at 4 layers, internvl2 at 12), seeds 0-2:
                   # 9.8e-6, 1.24e-5 and 2.1e-6 at most, kernel and plain alike
                   "qwen3-moe-235b-a22b": 2e-5, "internvl2-76b": 2.5e-5, "whisper-tiny": 5e-6}


def _witness_steps(cfg, model, base, pages, page, prompts, fns, routes, frames=None):
    """Prompt b prefilled at B=1 with its own adapter page ``page[b]`` of
    ``pages`` (and, for the encoder-decoder family, ``frames[b]`` encoded
    with it), its first decode step taken at B=1 and, the four rows
    scattered into one B=4 cache, as one batched step over the four pages
    through each of ``routes`` (name -> the multi-adapter function). Returns
    the B=1 logits (4,V) and each route's batched logits, fp32."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import encode_into_cache
    from repro_torch.launch.serving import _scatter_row

    P, dev = prompts.shape[1], prompts.device
    batch = model.init_cache(cfg, 4, P + 1, device=dev)
    toks, single = [], []
    for b in range(4):
        one = model.init_cache(cfg, 1, P + 1, device=dev)
        if frames is not None:
            encode_into_cache(cfg, base, pages.page_tree(page[b]), one, frames[b:b + 1])
        logits, one = fns["prefill"](base, pages.page_tree(page[b]), one,
                                     prompts[b:b + 1])
        toks.append(torch.argmax(logits, dim=-1)[:, None].to(torch.int32))
        _scatter_row(batch, one, b)
        single.append(fns["decode"](base, pages.page_tree(page[b]), one, toks[-1],
                                    P)[0])
    pos = torch.full((4,), P, dtype=torch.int32, device=dev)
    batched, orig = {}, dispatch.lora_dual_multi
    for name, fn in routes.items():
        dispatch.lora_dual_multi = fn
        try:
            cache = {k: v.clone() for k, v in batch.items()}
            batched[name] = fns["decode"](base, pages.multi_peft(page), cache,
                                          torch.cat(toks), pos)[0].float()
        finally:
            dispatch.lora_dual_multi = orig
    return torch.cat(single).float(), batched


def serve_fp32_witness(arch, P=16, cfg=None, cpu=True, seed=0):
    """``arch`` at full width and depth (or ``cfg``'s) in fp32 (random
    weights from ``seed``, synthetic adapters 0-3, four prompts of P
    tokens), ``_witness_steps``
    on the card, through the ``lora_dual_multi`` kernel (its fp32 route) and
    through its plain version, and again on the host CPU (the plain version)
    on the same weights, adapters and prompts unless not ``cpu``. Returns the largest |logit|,
    each batched step's largest absolute difference from the B=1 steps on
    its device (what batching alone does at full depth, apart from bf16's
    rounding; the bf16 engine's limits rest on it), and the card's B=1
    logits against the CPU's (the same ops in other reduction orders and
    other math libraries): two witnesses of how far the arch carries one
    rounding difference, apart from the card's path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.lora_dual import ops
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serve import build_serve_fns
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(cfg or get_config(arch), param_dtype="float32")
    model = get_model(cfg)
    fns = build_serve_fns(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = model.init_base(cfg, gen)
    card_store = SyntheticAdapterStore(cfg, seed=seed, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (4, P), generator=gen, device="cuda",
                            dtype=torch.int32)
    frames = (torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                          device="cuda") if cfg.encoder_layers else None)

    class HostStore:            # the card's adapters, on the host
        def template(self):
            return self.load(0)

        def load(self, aid):
            return tree_map(lambda t: t.cpu(), card_store.load(aid))

    res = {}
    for dev, store, routes in (
            ("card", card_store, {"kernel": dispatch.lora_dual_multi,
                                  "plain": ops.lora_dual_multi_ref}),
            ("cpu", HostStore(), {"cpu": ops.lora_dual_multi_ref}))[:2 if cpu else 1]:
        if dev == "cpu":
            base, prompts = tree_map(lambda t: t.cpu(), base), prompts.cpu()
            frames = None if frames is None else frames.cpu()
            torch.cuda.empty_cache()
        pages = AdapterCache(store, capacity=4)
        page = [pages.pin(aid) for aid in range(4)]
        single, batched = _witness_steps(cfg, model, base, pages, page, prompts, fns,
                                         routes, frames)
        if dev == "card":
            card_single = single.cpu()
            res["max_abs_logit"] = float(single.abs().max())
        for name, logits in batched.items():
            res[f"{name}_max_abs_err_vs_b1"] = float((logits - single).abs().max())
    if cpu:
        res["cpu_b1_vs_card_b1"] = float((single - card_single).abs().max())
    return res


def _run_engine_recorded(cfg, P, steps, plain=False, n_requests=8, n_adapters=6, seed=0):
    """``serve.run_engine`` (``n_requests`` requests on ``n_adapters``
    adapters, max_batch 4, capacity 4, weights, adapters and prompts from
    ``seed``) with each request's first decode-step
    logits recorded; ``plain`` swaps
    the multi-adapter kernel for its plain version. Returns (outputs,
    engine, step log, launch counts, launches by route, peak GiB, the first
    decode step's kernel calls). Each call of the first batched decode step
    is kept as (inputs, output) as the path made them: x, the page index
    and the page stacks cloned (a later eviction rewrites the pages in
    place), W by reference (frozen). The peak is the serving run's (see
    ``recording_engine``)."""
    import torch
    from repro_torch.kernels import (dispatch, launch_counts, launch_paths,
                                     reset_launch_counts)
    from repro_torch.kernels.lora_dual import ops
    from repro_torch.launch import serve, serving

    step_log, first_step = [], []
    per_step = serve_launches(cfg, 1)["lora_dual_multi"]

    def capture(x, idx, w, a_stack, b_stack, scale):
        out = ops.lora_dual_multi(x, idx, w, a_stack, b_stack, scale)
        if len(first_step) < per_step:      # every call of the first step
            first_step.append(((x.clone(), idx.clone(), w, a_stack.clone(),
                                b_stack.clone(), scale), out.clone()))
        return out
    orig = serving.ServingEngine, dispatch.lora_dual_multi
    serving.ServingEngine = recording_engine(step_log, all_steps=False)
    dispatch.lora_dual_multi = ops.lora_dual_multi_ref if plain else capture
    reset_launch_counts()
    try:
        outputs, engine = serve.run_engine(cfg, n_requests, P, steps, max_batch=4,
                                           cache_capacity=4, n_adapters=n_adapters,
                                           seed=seed, device="cuda")
    finally:
        serving.ServingEngine, dispatch.lora_dual_multi = orig
    torch.cuda.synchronize()
    return (outputs, engine, step_log, launch_counts(), launch_paths(),
            torch.cuda.max_memory_allocated() / 2 ** 30, first_step)


def hold_decode_step(arch, calls):
    """Each ``lora_dual_multi`` call of one engine decode step, its output as
    the path made it, against the plain version (fp32) on the same inputs at
    the per-call bf16 tolerance. Returns the calls held, the page indices,
    and by (K, N) shape the calls, the largest error and the largest |output|
    (the tolerance is relative to it)."""
    import torch
    from repro_torch.kernels.lora_dual import ops
    shapes, pages = {}, set()
    for i, ((x, idx, w, a, b, scale), out) in enumerate(calls):
        want = ops.lora_dual_multi_ref(x.float(), idx, w.float(), a.float(),
                                       b.float(), scale)
        err = close(f"{arch} decode-step lora_dual_multi call {i}", out, want,
                    torch.bfloat16)
        at = shapes.setdefault("x".join(map(str, w.shape)),
                               {"calls": 0, "max_abs_err": 0.0, "max_abs_out": 0.0})
        at["calls"] += 1
        at["max_abs_err"] = max(at["max_abs_err"], err)
        at["max_abs_out"] = max(at["max_abs_out"], float(want.abs().max()))
        pages.update(idx.flatten().tolist())
    return {"calls": len(calls), "pages": sorted(pages), "shapes": shapes}


def phase_serve(arch, totals, path_totals, smi):
    """``arch`` at full width and depth in bf16 through the serve entry
    points. ``run_engine`` (8 requests on 6 adapters, max_batch 4, capacity
    4, P=16, 32 new tokens) must make exactly ``serve_launches``, every one
    on the stream route (``lora_multi_path``); every call of its first
    batched decode step is held against the plain version on the path's own
    inputs at the bf16 tolerance (``hold_decode_step``). The same engine with
    the plain version launches nothing. Each request's first decode-step
    logits, from both engines, are held against its own B=1 greedy run (the
    plain single-adapter primal) within SERVE_BF16_ATOL[arch]; the id sequences equal to greedy's are counted.
    ``greedy_generate`` (B=4, P=16, 32 steps) must launch nothing. Then
    ``serve_fp32_witness`` within SERVE_FP32_ATOL[arch]. Prints
    end-to-end and steady-state decode tokens/s, decode steps, the adapter
    cache's stats, peak device memory, and a profile of batched decode
    steps (device time by kernel, host-bound share)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    cfg = get_config(arch)
    P, steps = 16, 32
    outputs, engine, log_steps, counts, paths, engine_peak, calls = _run_engine_recorded(
        cfg, P, steps)
    want = serve_launches(cfg, engine.steps)
    n_tok = sum(len(v) for v in outputs.values())
    in_situ = hold_decode_step(arch, calls)
    if in_situ["calls"] != serve_launches(cfg, 1)["lora_dual_multi"]:
        raise AssertionError(f"serve {arch}: first decode step held {in_situ}")
    res = {"requests": len(outputs), "decode_steps": engine.steps,
           "generated_tokens": n_tok, "e2e_s": engine.run_s,
           "e2e_tok_per_s": n_tok / engine.run_s,
           "steady_decode_tok_per_s": sum(x["n_active"] for x in log_steps)
           / sum(x["s"] for x in log_steps),
           "mean_decode_step_ms": 1e3 * sum(x["s"] for x in log_steps) / len(log_steps),
           "adapter_cache": engine.adapters.stats(), "peak_GiB": engine_peak,
           "in_situ_first_decode_step": in_situ,
           "lora_dual_multi_per_decode_step": want["lora_dual_multi"] // engine.steps,
           "launches": counts,
           "lora_dual_multi_by_route": paths["lora_dual_multi"], "card": smi}
    log(f"[serve] {arch} engine: " + json.dumps(res))
    if counts != want or len(log_steps) != engine.steps:
        raise AssertionError(f"serve {arch} engine: launches {counts} != {want}")
    if paths["lora_dual_multi"] != {"stream": want["lora_dual_multi"], "simt": 0}:
        raise AssertionError(f"serve {arch} engine: decode launches by route "
                             f"{paths['lora_dual_multi']}, not all stream")
    for route, n in paths["lora_dual_multi"].items():
        path_totals["lora_dual_multi"][route] += n
    if engine.adapters.stats()["evictions"] < 1:
        raise AssertionError(f"serve {arch} engine: no adapter page was evicted")
    for k, n in counts.items():
        totals[k] += n
    base, store, model = engine.base, engine.adapters.store, engine.model
    requests = engine.requests
    fns = serve.build_serve_fns(cfg, model)
    log_serve_profile(cfg, engine, fns, P)
    del engine, calls
    gc.collect()                  # the engines' decode closures form cycles

    p_out, p_engine, p_log, p_counts, _, _, _ = _run_engine_recorded(cfg, P, steps,
                                                                    plain=True)
    p_ms = 1e3 * sum(x["s"] for x in p_log) / len(p_log)
    del p_engine
    gc.collect()
    if any(p_counts.values()):
        raise AssertionError(f"serve {arch} engine, plain version: launched {p_counts}")

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
        if req.frames is not None:
            serve.encode_into_cache(cfg, base, peft1, cache1,
                                    torch.as_tensor(req.frames, device="cuda")[None])
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
    log(f"[serve] {arch} greedy: " + json.dumps(res))
    res = {"first_step_max_abs_err_vs_greedy": {k: max(v) for k, v in errs.items()},
           "per_request": errs, "max_abs_logit": max_logit,
           "ids_equal_greedy": {k: f"{v}/8" for k, v in same.items()},
           "plain_engine_mean_decode_step_ms": p_ms, "limit": SERVE_BF16_ATOL[arch]}
    log(f"[serve] {arch} engine (kernel, plain version) vs per-request greedy: "
        + json.dumps(res))
    if any(g_counts.values()):
        raise AssertionError(f"serve {arch} greedy launched kernels: {g_counts}")
    if not (math.isfinite(e2e) and math.isfinite(decode_tps)
            and max(errs["kernel"] + errs["plain"]) <= SERVE_BF16_ATOL[arch]):
        raise AssertionError(f"serve {arch}: engine vs greedy {res}")
    res = serve_fp32_witness(arch)
    res.update(limit=SERVE_FP32_ATOL[arch], card=smi)
    log(f"[serve] {arch} fp32 witness, one batched decode step (B=4, four adapters) "
        f"vs the B=1 steps: " + json.dumps(res))
    if max(res["kernel_max_abs_err_vs_b1"], res["plain_max_abs_err_vs_b1"],
           res["cpu_max_abs_err_vs_b1"]) > SERVE_FP32_ATOL[arch]:
        raise AssertionError(f"serve {arch}: fp32 witness {res}")


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
    log(f"[serve] {cfg.arch_id} batched decode step (B={engine.max_batch}): wall "
        f"{1e3 * wall:.3f} ms unprofiled, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / (1e3 * wall):.1f}% of the wall)")
    for ms, count, key in rows[:10]:
        log(f"[serve]   {ms:8.3f} ms {count:5d}x  {key}")


# ---------------------------------------------------------------------------
# phase 8: the federation runtime (engines, wire, faults, checkpoints)
# ---------------------------------------------------------------------------

RUNTIME_RTOL = 1e-5              # (d) card vs CPU chaos round, fp32: new PEFT
RUNTIME_B_LAYERS = 12            # (b)'s depth: 12 of roberta-large's 24 layers
                                 # (the whole script's clock; see PERF.md)
CHAOS_SEED = 3                   # (d): a crash, a corrupt frame, a duplicate,
                                 # a retry and a requorum of 2 (host CPU run)
STREAM_PEAK_PEFTS = 4            # (c) cohort 16's round peak over cohort 4's, in
                                 # |peft| (fp32 payload bytes): a stacked cohort
                                 # would add 12 |peft| more
_TIMING = ("t", "round_s", "round_peak_bytes")


def _round_equal(a_state, a_met, b_state, b_met):
    """Bitwise: new PEFT, server state (count, moments), round index and
    every metric."""
    import torch
    from repro_torch.utils.pytree import tree_leaves

    def leaves(s):
        return (tree_leaves(s.peft) + tree_leaves(s.server.m)
                + tree_leaves(s.server.v))
    return (a_state.round_idx == b_state.round_idx
            and a_state.server.count == b_state.server.count
            and sorted(a_met) == sorted(b_met)
            and all(torch.equal(x, y) for x, y in zip(leaves(a_state), leaves(b_state)))
            and all(torch.equal(a_met[k], b_met[k].to(a_met[k].device)) for k in a_met))


def _counted(what, fn, want, totals, path_totals):
    """``fn()`` with every launch counter zeroed just before and read just
    after; the launches must equal ``want`` (None: not checked) and every
    route a tensor-core one (``check_paths``). Adds them to the totals."""
    import torch
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts, paths = launch_counts(), launch_paths()
    if want is not None and counts != want:
        raise AssertionError(f"runtime {what}: launches {counts} != {want}")
    check_paths(f"runtime {what}", paths, path_totals)
    for k, n in counts.items():
        totals[k] += n
    return out, secs, counts, paths


def _live_peft(cfg, gen, sc, device):
    """``init_peft`` with every LoRA B drawn non-zero (B = 0 at init), so
    the LoRA path is live."""
    import torch
    from repro_torch.peft import init_peft
    peft = init_peft(cfg, gen, sc)
    for t in peft["layers"].values():
        t["B"] = 0.1 * torch.randn(t["B"].shape, generator=gen, device=device)
    return peft


def runtime_bit_identity(totals, path_totals):
    """(a) roberta-large-lora at full width and depth (bf16), 4 clients,
    K=8, standard route: ``FederationEngine.run_ideal`` against the
    in-process round step, both comm modes, with no wire and with an fp32
    wire bitwise, each making exactly ``round_launches``; the bf16 wire's
    largest relative PEFT difference printed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpryConfig, get_config
    from repro_torch.core import init_state, make_round_step, make_round_step_per_iteration
    from repro_torch.fl.runtime import FederationEngine, WireConfig
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_leaves

    cfg = dataclasses.replace(get_config("roberta-large-lora"), n_classes=2)
    M, K = 4, 8
    sc = SpryConfig(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
                    server_lr=1e-2, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_state(get_model(cfg).init_base(cfg, gen),
                       _live_peft(cfg, gen, sc, "cuda"))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (M, 8, 32)),
                                       device="cuda"),
             "labels": torch.as_tensor(rng.integers(0, 2, (M, 8)), device="cuda")}
    want = round_launches(cfg, "standard", M)
    for mode in ("per_epoch", "per_iteration"):
        step = (make_round_step if mode == "per_epoch"
                else make_round_step_per_iteration)(cfg, sc)
        (rs, rm), step_s, _, _ = _counted(f"round step {mode}", lambda: step(state, batch),
                                          want, totals, path_totals)
        res = {"mode": mode, "round_step_s": step_s}
        for wire in ("none", "fp32", "bf16"):
            eng = FederationEngine(cfg, sc, comm_mode=mode, wire=WireConfig(
                simulate=wire != "none", dtype="fp32" if wire == "none" else wire))
            (es, em), secs, counts, paths = _counted(
                f"run_ideal {mode} wire {wire}", lambda: eng.run_ideal(state, batch),
                want, totals, path_totals)
            res[f"wire_{wire}_s"] = secs
            if wire == "bf16":
                res["bf16_wire_max_rel_peft_diff"] = max(
                    float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    for a, b in zip(tree_leaves(es.peft), tree_leaves(rs.peft)))
            else:
                res[f"wire_{wire}_bitwise"] = _round_equal(rs, rm, es, em)
        res.update(launches=counts, paths=paths)
        log(f"[runtime] (a) roberta-large-lora bf16, {M} clients K={K}, standard route, "
            f"run_ideal vs the in-process round step: " + json.dumps(res))
        if not (res["wire_none_bitwise"] and res["wire_fp32_bitwise"]):
            raise AssertionError(f"runtime (a) {mode}: the engine's round differs from "
                                 f"the round step's: {res}")
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _history(h):
    return json.dumps([{k: v for k, v in e.items() if k not in _TIMING} for e in h],
                      sort_keys=True)


_HOST_SPLIT = (
    ("checkpoint_writes", re.compile(r"checkpoint state_\d+\.npz written \(([\d.]+)s\)")),
    ("checkpoint_loads", re.compile(r"resumed from .* \(load ([\d.]+)s\)")),
    ("personalized_accuracy", re.compile(r"personalized_acc=\S+ \(([\d.]+)s\)")))


def _host_split(lines):
    """(calls, seconds) of the checkpoint writes, loads and personalized
    evals that ``run_training`` logged."""
    out = {}
    for name, pat in _HOST_SPLIT:
        secs = [float(m.group(1)) for m in map(pat.search, lines) if m]
        out[name] = {"calls": len(secs), "s": sum(secs)}
    return out


def runtime_entry_point(totals, path_totals):
    """(b) ``run_training(runtime=True)`` at roberta-large-lora's full width
    and RUNTIME_B_LAYERS of its 24 layers (bf16) with everything on: spry K=8, 8 clients a round from
    64 over-selected 1.5x, a 30 s deadline, dropout 0.25, the streaming
    executor (2 clients a chunk), wire simulation, the mild fault preset,
    quorum 0.5, a checkpoint every round. 3 rounds straight (its final
    state's content hash is the reference), then 2 rounds, killed, and
    resumed to 3 in another directory: the final state's content hash and
    the history (timings aside) must be equal, and the runs must have
    logged 6 checkpoint writes. The same for spry_periter and for the async
    engine (buffer 4, concurrency 8, max staleness 2, 3 versions). A
    synchronous round must make exactly ``round_launches`` for its cohort
    (12 clients, each one estimate). The host seconds of the checkpoint
    writes, loads and personalized evals are read from ``run_training``'s
    log lines. The straight runs record telemetry (JSONL, Prometheus file,
    Chrome trace) and the killed and resumed runs do not, so the equalities
    above also hold telemetry on to telemetry off; ``check_telemetry``
    then reads the artifacts."""
    import dataclasses
    with depth_cut("roberta-large-lora", RUNTIME_B_LAYERS,
                   "the script's clock: phase 9 needs the time") as cut:
        _runtime_entry_point(dataclasses.replace(cut, n_classes=2), totals, path_totals)


def _runtime_entry_point(cfg, totals, path_totals):
    import shutil
    import tempfile
    from repro_torch.checkpoint import read_manifest
    from repro_torch.fl import comm_cost
    from repro_torch.launch.train import run_training
    from repro_torch.obs import make_telemetry

    n_units, w_l, cohort = 2 * cfg.n_layers, 2 * cfg.d_model, 12
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    lines = []

    def run_log(line):
        lines.append(line)
        log("  " + line)
    try:
        for name, kw in (("spry", {"method": "spry"}),
                         ("spry_periter", {"method": "spry_periter"}),
                         ("async", {"method": "spry", "async_mode": True,
                                    "buffer_size": 4, "async_concurrency": 8,
                                    "max_staleness": 2})):
            common = dict(arch="roberta-large-lora", task="sst2", rounds=3,
                          clients_per_round=8, total_clients=64, batch_size=8,
                          k_perturbations=8, eval_every=1, reduced=False,
                          device="cuda", runtime=True, over_select=1.5,
                          deadline=30.0, dropout_rate=0.25, runtime_microbatch=2,
                          wire_simulate=True, faults="mild", quorum=0.5,
                          checkpoint_every=1, log=run_log, **kw)
            a, b = os.path.join(root, name + "_straight"), os.path.join(root, name + "_killed")
            art = {k: os.path.join(root, f"{name}_telemetry.{k}")
                   for k in ("jsonl", "prom", "trace")}
            tel = make_telemetry(jsonl=art["jsonl"], prometheus=art["prom"],
                                 run_id=f"chip-smoke-{name}", workload="train")
            full, straight_s, _, _ = _counted(f"{name} straight", lambda: run_training(
                checkpoint_dir=a, telemetry=tel, **common), None, totals, path_totals)
            tel.export_chrome_trace(art["trace"])
            tel.close()
            killed, killed_s, _, _ = _counted(f"{name} killed", lambda: run_training(
                checkpoint_dir=b, **dict(common, rounds=2)), None, totals, path_totals)
            resumed, resumed_s, _, _ = _counted(f"{name} resumed", lambda: run_training(
                checkpoint_dir=b, resume=True, **common), None, totals, path_totals)
            host_s = _host_split(lines)
            lines.clear()
            ma, mb = read_manifest(a), read_manifest(b)
            mode = "per_iteration" if name == "spry_periter" else "per_epoch"
            table2 = comm_cost("spry", mode, w_l, n_units, cohort)
            rounds, prev_up, prev_down = [], 0, 0
            for e in full:
                r = {"round": e["round"], "round_s": e["round_s"],
                     "round_peak_GiB": e["round_peak_bytes"] / 2 ** 30,
                     "loss": e["loss"], "health": e["health"]}
                if name == "async":
                    r.update(bytes_up=e["bytes_up"] - prev_up,
                             bytes_down=e["bytes_down"] - prev_down,
                             staleness=e["staleness"], sim_time_s=e["sim_time_s"])
                    prev_up, prev_down = e["bytes_up"], e["bytes_down"]
                else:
                    r.update(bytes_up=e["round_bytes_up"], bytes_down=e["round_bytes_down"],
                             survivors=e["survivors"], cohort=e["cohort"],
                             dropped_frame_ids=e["dropped_frame_ids"],
                             round_skipped=e["round_skipped"])
                    want = round_launches(cfg, "standard", e["cohort"])
                    if e["launches"] != want:
                        raise AssertionError(f"runtime (b) {name} round {e['round']}: "
                                             f"launches {e['launches']} != {want}")
                h = e["health"]
                r["bytes_up_per_transmission"] = (r["bytes_up"] / h["transmissions"]
                                                  if h["transmissions"] else None)
                rounds.append(r)
            res = {"run": name, "straight_s": straight_s, "killed_s": killed_s,
                   "resumed_s": resumed_s,
                   "checkpoints_written": host_s["checkpoint_writes"]["calls"],
                   "host_split_of_the_three_runs": host_s,
                   "table2_payload_bytes_a_frame": 4 * table2.client_to_server,
                   "table2_note": "fp32 scalars of the assigned units (per_epoch, "
                                  "the head's 2050 more not counted) or the K jvps "
                                  "(per_iteration: Table 2's 1 scalar a perturbation)",
                   "rounds": rounds,
                   "state_file_bytes": os.path.getsize(os.path.join(a, ma.state_file)),
                   "content_hash": [ma.content_hash[:16], mb.content_hash[:16]],
                   "history_equal": _history(full) == _history(resumed)}
            if name == "spry_periter":
                res["table2_payload_bytes_a_frame"] = 4 * 8    # K=8 jvps
            log(f"[runtime] (b) run_training roberta-large-lora ({cfg.n_layers} layers) "
                f"{name}, everything on, 3 rounds straight vs killed at 2 and resumed: "
                + json.dumps(res))
            # a checkpoint every round: 3 straight, 2 killed, 1 resumed
            if not (ma.content_hash == mb.content_hash and res["history_equal"]
                    and ma.round_idx == mb.round_idx == 3
                    and res["checkpoints_written"] == 6):
                raise AssertionError(f"runtime (b) {name}: the resumed run differs from "
                                     f"the straight one: {res}")
            check_telemetry(name, art, full, killed)
            shutil.rmtree(a)
            shutil.rmtree(b)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_telemetry(name, art, full, killed):
    """(b)'s telemetry artifacts of one straight run (``full``: its
    history): every JSONL line carries the envelope, the reference's event
    kinds occur, a ``wire_health`` event for every synchronous round with
    health, ``fl.rounds`` 3 and the byte counters equal to the history's
    bytes (sync: the sum of its round bytes; async: its last totals), 3
    round spans in the Chrome trace, ``fl_bytes_up`` in the Prometheus
    file, and the ``post_round_1`` memory event's ``peak_bytes_in_use`` the
    first round's ``round_peak_bytes``. Prints the event counts by kind,
    the artifacts' bytes and ``round_s`` on (this run) vs off (``killed``,
    its first two rounds)."""
    from collections import Counter
    from repro_torch.obs import load_chrome_trace

    sync = name != "async"
    with open(art["jsonl"]) as f:
        events = [json.loads(line) for line in f if line.strip()]
    kinds = Counter(e.get("kind") for e in events)
    counters = [e for e in events if e.get("kind") == "metrics"][-1]["metrics"]["counters"]
    mem = {e["label"]: e for e in events if e.get("kind") == "memory"}
    spans = [e for e in load_chrome_trace(art["trace"])["traceEvents"]
             if e["ph"] == "X" and e["name"] == ("fl.round" if sync else "fl.async.version")]
    if sync:
        want_up = sum(e["round_bytes_up"] for e in full)
        want_down = sum(e["round_bytes_down"] for e in full)
    else:
        want_up, want_down = full[-1]["bytes_up"], full[-1]["bytes_down"]
    health_rounds = sorted(e["round"] - 1 for e in full if sync and e["health"] is not None)
    with open(art["prom"]) as f:
        prom = f.read()
    checks = {
        "envelope": all({"ts", "run_id", "kind"} <= e.keys() for e in events),
        "kinds": {"run_meta", "round" if sync else "async_round", "eval", "memory",
                  "personalized_eval", "metrics"} <= kinds.keys(),
        "wire_health": sorted(e["round"] for e in events
                              if e.get("kind") == "wire_health") == health_rounds,
        "fl.rounds": counters.get("fl.rounds") == (3 if sync else None),
        "bytes": (counters["fl.bytes_up"], counters["fl.bytes_down"])
        == (want_up, want_down),
        "trace_spans": len(spans) == 3,
        "prometheus": "fl_bytes_up" in prom,
        "post_round_1_peak": mem["post_round_1"]["device_stats"]["cuda:0"][
            "peak_bytes_in_use"] == full[0]["round_peak_bytes"]}
    res = {"run": name, "events_by_kind": dict(kinds),
           "artifact_bytes": {k: os.path.getsize(p) for k, p in art.items()},
           "round_s_on": [e["round_s"] for e in full],
           "round_s_off": [e["round_s"] for e in killed],
           "bytes_up": [counters["fl.bytes_up"], want_up],
           "post_round_1_peak_bytes": [mem["post_round_1"]["device_stats"]["cuda:0"][
               "peak_bytes_in_use"], full[0]["round_peak_bytes"]],
           "checks": checks}
    log(f"[runtime] (b) telemetry {name}: " + json.dumps(res))
    if not all(checks.values()):
        raise AssertionError(f"runtime (b) telemetry {name}: {res}")


def runtime_streaming_memory(totals, path_totals):
    """(c) llama2-7b at full width and depth (bf16), spry K=4, the streaming
    executor (2 clients a chunk): one round at cohort 4 and one at cohort 16
    from the same state; the cohort-16 round's peak (weights included) must
    stay within STREAM_PEAK_PEFTS·|peft| (~8 MiB) of the cohort-4 round's:
    the accumulator is (m+1)·|peft| at any cohort, while payloads kept
    alive across the cohort would add |peft| a client."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpryConfig, get_config
    from repro_torch.core import enumerate_units, init_state
    from repro_torch.core.assignment import assignment_matrix
    from repro_torch.fl.runtime import CohortPlan, FederationEngine, SerialExecutor
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_leaves

    cfg = dataclasses.replace(get_config("llama2-7b"), n_classes=2)
    sc = SpryConfig(n_clients_per_round=16, k_perturbations=4, local_lr=5e-3,
                    server_lr=1e-2, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_state(get_model(cfg).init_base(cfg, gen),
                       _live_peft(cfg, gen, sc, "cuda"))
    n_units = enumerate_units(state.peft).n_units
    peft_bytes = 4 * sum(x.numel() for x in tree_leaves(state.peft))
    slack = STREAM_PEAK_PEFTS * peft_bytes
    eng = FederationEngine(cfg, sc, executor=SerialExecutor(microbatch=2))
    rng = np.random.default_rng(0)
    res = {}
    for C in (4, 16):
        plan = CohortPlan(round_idx=0, client_ids=np.arange(C), seed_ids=np.arange(
            C, dtype=np.int32), mask_matrix=assignment_matrix(n_units, C, 0).numpy(),
            latencies=np.zeros(C), deadline=float("inf"), keep=np.ones(C, bool),
            assignments=[], n_requested=C)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (C, 8, 32)),
                                           device="cuda"),
                 "labels": torch.as_tensor(rng.integers(0, 2, (C, 8)), device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (_, metrics, rep), secs, _, _ = _counted(
            f"streaming cohort {C}", lambda: eng.run_round(state, plan, batch),
            round_launches(cfg, "standard", C), totals, path_totals)
        res[C] = {"round_s": secs, "round_peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "loss": float(metrics["loss"]),
                  "agg_bytes_streaming": rep.agg_bytes_streaming,
                  "agg_bytes_stacked": rep.agg_bytes_stacked}
    grew = (res[16]["round_peak_GiB"] - res[4]["round_peak_GiB"]) * 2 ** 30
    log(f"[runtime] (c) llama2-7b bf16 spry K=4, streaming executor (2 clients a "
        f"chunk), round peak at cohort 4 and 16 (weights included; limit "
        f"{STREAM_PEAK_PEFTS} |peft| = {slack / 2 ** 20:.2f} MiB more): "
        + json.dumps({"cohort_4": res[4], "cohort_16": res[16], "peft_bytes": peft_bytes,
                      "peak_growth_MiB": grew / 2 ** 20}))
    if not (grew <= slack and math.isfinite(res[16]["loss"])
            and res[4]["agg_bytes_streaming"] == res[16]["agg_bytes_streaming"]
            == 3 * peft_bytes):
        raise AssertionError(f"runtime (c): cohort 16's round peak grew {grew} bytes "
                             f"(limit {slack}): {res}")
    del state, eng
    gc.collect()
    torch.cuda.empty_cache()


def runtime_card_vs_cpu():
    """(d) one reduced fp32 chaos round (6 clients, 2 of them in the
    over-selection pool, quorum 4, crashes, corruption, loss and NaN
    poisoning) on the card (kernels) and on the CPU (plain versions), the
    same weights, batch, perturbations and fault seed: equal WireHealth,
    survivors and dropped frame ids, the new PEFT within RUNTIME_RTOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.core import enumerate_units, init_state, stacked_perturbations
    from repro_torch.core.assignment import assignment_matrix
    from repro_torch.fl.runtime import CohortPlan, FaultConfig, FederationEngine, WireConfig
    from repro_torch.models import get_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = dataclasses.replace(reduce_config(get_config("roberta-large-lora")), n_classes=2)
    M, K = 6, 4
    sc = SpryConfig(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
                    server_lr=1e-2, seed=0)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    base, peft = get_model(cfg).init_base(cfg, gen), _live_peft(cfg, gen, sc, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (M, 4, 32))),
             "labels": torch.as_tensor(rng.integers(0, 2, (M, 4)))}
    perts = [[stacked_perturbations(1000 + m, peft, list(range(K)))] for m in range(M)]
    n_units = enumerate_units(peft).n_units
    plan = CohortPlan(round_idx=0, client_ids=np.arange(M), seed_ids=np.arange(
        M, dtype=np.int32), mask_matrix=assignment_matrix(n_units, M, 0).numpy(),
        latencies=np.arange(1.0, M + 1), deadline=4.5,
        keep=np.arange(M) < 4, assignments=[], n_requested=M)
    faults = dict(crash_rate=0.15, corrupt_rate=0.3, loss_rate=0.2, nan_rate=0.15,
                  seed=CHAOS_SEED)
    out = {}
    for dev in ("cpu", "cuda"):
        to = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
        eng = FederationEngine(cfg, sc, wire=WireConfig(simulate=True),
                               faults=FaultConfig(**faults), quorum=4)
        out[dev] = eng.run_round(init_state(to(base), to(peft)), plan, to(batch),
                                 [[to(p[0])] for p in perts])
    torch.cuda.synchronize()
    (cs, cm, cr), (gs, gm, gr) = out["cpu"], out["cuda"]
    rel = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
              for g, c in zip(tree_leaves(gs.peft), tree_leaves(cs.peft)))
    res = {"health_cpu": dataclasses.asdict(cr.health),
           "health_card": dataclasses.asdict(gr.health),
           "survivors": [cr.n_validated, gr.n_validated],
           "dropped_frame_ids": [cr.dropped_frame_ids, gr.dropped_frame_ids],
           "loss": [float(cm["loss"]), float(gm["loss"])], "peft_rel_err": rel}
    log(f"[runtime] (d) reduced roberta fp32 chaos round, card (kernels) vs cpu "
        f"(limit {RUNTIME_RTOL}): " + json.dumps(res))
    if not (res["health_cpu"] == res["health_card"] and cr.n_validated == gr.n_validated
            and cr.dropped_frame_ids == gr.dropped_frame_ids and not cr.round_skipped
            and rel <= RUNTIME_RTOL):
        raise AssertionError(f"runtime (d): card and cpu chaos rounds disagree: {res}")


def phase_runtime(totals, path_totals):
    for name, part in (("(a) bit identity", runtime_bit_identity),
                       ("(b) entry point", runtime_entry_point),
                       ("(c) streaming memory", runtime_streaming_memory),
                       ("(d) card vs cpu", lambda *_: runtime_card_vs_cpu())):
        tp = time.time()
        part(totals, path_totals)
        log(f"[runtime] {name} {time.time() - tp:.1f}s")


# ---------------------------------------------------------------------------
# phase 9: the other dense configs (gemma3-12b, gemma3-27b, h2o-danube-3-4b,
# command-r-plus-104b) at full published width
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("gemma3-12b", "gemma3-27b", "h2o-danube-3-4b", "command-r-plus-104b")
# the only cut: command-r-plus-104b's bf16 weights (~208 GB) do not fit one
# 80 GB card; 8 of its 64 layers (~15.7 B parameters, ~31 GB) do
DENSE_LAYERS = {"command-r-plus-104b": 8}
# the long estimate (gemma3-12b at all 48 layers, S=2048): each bf16 route
# against the fp32 estimate, loss relative and jvps of the largest |jvp|.
# Over seeds 0-2 the kernels read 0.049, 0.038, 0.034 in the jvps and the
# plain versions 0.028, 0.034, 0.056; loss 5.4e-4, 0.028, 0.0097 and
# 0.010, 0.021, 0.0033 (PERF.md, Findings; scripts/dense_readings.py long).
# Both routes are held to DENSE_LONG_FP32_RTOL, and the kernels' jvps drift
# to DENSE_LONG_PLAIN_MULT times the plain versions' (0.60-1.72 read)
DENSE_LONG_FP32_RTOL = 0.075
DENSE_LONG_PLAIN_MULT = 2.0
# kernels vs plain versions, the bf16 per-call tolerance: printed, not met
# at 48 layers (jvps 0.049, 0.038, 0.028 over seeds 0-2), where each route's
# roundings drift it from the fp32 estimate by as much (ROADMAP C)
DENSE_LONG_RTOL = 2e-2
# the fp32 witness's depth where an arch's fp32 weights, beside the draw of
# its largest leaf, would not fit one card (gemma3-27b 108 GB whole;
# command-r-plus-104b 63 GB at the engine's 8 layers): 45 GB and 50 GB
DENSE_WITNESS_LAYERS = {"gemma3-27b": 24, "command-r-plus-104b": 6}
# fp32 decode step vs teacher-forced forward, of the largest |logit|: about
# five times the larger first reading (2.6e-7 gemma3-12b, 3.9e-6 h2o-danube)
DENSE_FP32_DECODE_RTOL = 2e-5


@contextlib.contextmanager
def depth_cut(arch, n_layers, why):
    """``arch``'s config cut to ``n_layers`` layers (None: as published),
    the cut printed with ``why``; yields the config, which the script passes
    on itself wherever it reckons with it. The one lookup patched is the
    train entry point's (``run_training`` finds its config by name), and a
    run's launch totals, held to ``round_launches`` of the yielded config,
    show that it ran at the cut depth."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    full = get_config(arch)
    if n_layers is None:
        yield full
        return
    cfg = dataclasses.replace(full, n_layers=n_layers)
    log(f"[depth] {arch} reduced: n_layers {full.n_layers} -> {n_layers} ({why})")

    def cut(a):
        return cfg if a == arch else get_config(a)
    train_mod.get_config = cut
    try:
        yield cfg
    finally:
        train_mod.get_config = get_config


def bf16_depth(arch, n_layers):
    """``depth_cut`` at ``n_layers`` (None: as published), the bf16 weights
    whole and cut printed as the reason."""
    import dataclasses

    from repro_torch.configs import get_config
    full = get_config(arch)
    gb = lambda c: 2 * c.n_param_estimate() / 1e9  # noqa: E731  bf16 weights
    cut = dataclasses.replace(full, n_layers=n_layers or 1)
    return depth_cut(arch, n_layers, f"bf16 weights {gb(full):.0f} GB whole, "
                                     f"{gb(cut):.1f} GB cut")


def dense_depth(arch):
    """``depth_cut`` at DENSE_LAYERS' depth (command-r-plus-104b's 8)."""
    return bf16_depth(arch, DENSE_LAYERS.get(arch))


# the dispatch layer's LoRA and attention entry points and their plain versions
PLAIN_DISPATCH = {"swa_attention": "swa_attention_ref",
                  "swa_attention_mt_tangents": "swa_attention_mt_tangents_ref",
                  "swa_attention_mt_jvps": "swa_attention_mt_jvps_ref",
                  "lora_dual_mt_tangents": "lora_dual_mt_tangents_ref",
                  "lora_dual_mt_jvps": "lora_dual_mt_jvps_ref"}


@contextlib.contextmanager
def plain_dispatch(names=tuple(PLAIN_DISPATCH)):
    """The dispatch layer's entry points ``names`` (default: every LoRA and
    attention one) replaced by their plain versions (on the card's
    tensors), or by the functions of a {name: function} ``names``; restored
    on exit."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.lora_dual import ops as lo
    from repro_torch.kernels.swa_attention import ops as so
    fns = names if isinstance(names, dict) else {
        k: getattr(so if k.startswith("swa") else lo, PLAIN_DISPATCH[k]) for k in names}
    saved = {k: getattr(dispatch, k) for k in fns}
    for k, fn in fns.items():
        setattr(dispatch, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(dispatch, k, fn)


def _free():
    """Collect what the last model left (the engines' and rounds' closures
    form cycles) and release the allocator's cache and cuBLAS's workspaces,
    so that each model's peak and the phase's end are its own."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def long_estimate_readings(n_layers=None, seed=0, variants=None):
    """One ``forward_gradient`` on gemma3-12b at full width, B=1, S=2048,
    K=4 (bf16, a classification loss; random weights, tokens and
    perturbations from ``seed``) at ``n_layers`` layers (None: all 48): its
    local layers' window of 1024 < S puts the tensor-core band walk to work,
    its global layers run full causal. The estimate is made once for each
    of ``variants`` (name -> the dispatch entry points that take their
    plain versions, or {name: function}; default: "kernels" none, "plain"
    all), then once with
    the weights in fp32 through the plain versions (the estimate the bf16
    runs approximate). Returns the config, the launches and launches by
    route of the "kernels" run, and each variant's reading: loss, jvps, the
    seconds, and its drift from the fp32 estimate (loss relative, jvps of
    the largest |jvp|)."""
    import dataclasses

    import torch
    from repro_torch.configs import SpryConfig, get_config
    from repro_torch.core.forward_grad import forward_gradient, stacked_perturbations
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.models.registry import cls_loss
    from repro_torch.peft import init_peft
    from repro_torch.utils.pytree import tree_map, tree_paths

    variants = variants or {"kernels": (), "plain": tuple(PLAIN_DISPATCH)}
    cfg = dataclasses.replace(get_config("gemma3-12b"), n_classes=2)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, SpryConfig())
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen, device="cuda")
    batch = {"tokens": tokens, "labels": torch.ones(1, dtype=torch.int64, device="cuda")}
    K = 4
    vs = stacked_perturbations(11 + seed, tree_map(lambda x: x.float(), peft), list(range(K)))

    def estimate(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, jvps = forward_gradient(lambda p: cls_loss(c, base, p, batch), peft,
                                         11 + seed, K, perturbations=vs)
        torch.cuda.synchronize()
        return {"loss": float(loss), "jvps": jvps.float().cpu(),
                "s": time.perf_counter() - t0}
    out, counts, paths = {}, None, None
    for name, plain in variants.items():
        reset_launch_counts()
        with plain_dispatch(plain):
            out[name] = estimate(cfg)
        if name == "kernels":
            counts, paths = launch_counts(), launch_paths()
    with plain_dispatch():
        for *head, last in [p for p, _ in tree_paths(base)]:   # fp32, a leaf at a time
            node = base
            for k in head:
                node = node[k]
            node[last] = node[last].float()
        f32 = estimate(dataclasses.replace(cfg, param_dtype="float32"))
    for r in out.values():
        r["vs_fp32"] = {"loss": abs(r["loss"] - f32["loss"]) / abs(f32["loss"]),
                        "jvps": rel_max(r["jvps"], f32["jvps"])}
    out["fp32"] = f32
    del base, peft, vs
    _free()
    return cfg, counts, paths, out


def rel_max(got, want):
    """The largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def dense_long_estimate(smi):
    """``long_estimate_readings`` at gemma3-12b's full depth (48 layers,
    seed 0): the kernels' and the plain versions' estimates each within
    DENSE_LONG_FP32_RTOL of the fp32 estimate (loss and jvps), the kernels'
    jvps no further from it than DENSE_LONG_PLAIN_MULT times the plain
    versions'; the kernels against the plain versions printed beside
    DENSE_LONG_RTOL. Returns the launches and launches by route of the
    kernel run."""
    cfg, counts, paths, r = long_estimate_readings()
    kern, plain = r["kernels"], r["plain"]
    L = cfg.n_layers
    want = dict.fromkeys(KERNELS, 0)
    want.update(lora_dual_mt=2 * L, swa_attention=L, swa_attention_mt=L)
    vs_plain = {"loss": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
                "jvps": rel_max(kern["jvps"], plain["jvps"])}
    res = {"arch": cfg.arch_id, "n_layers": L, "B": 1, "S": 2048, "K": 4,
           "window": cfg.window, "local_layers": sum(not cfg.is_global_layer(i)
                                                     for i in range(L)),
           **{f"{k}_{v}": r[v][k] if k == "loss" else r[v][k].tolist()
              for v in ("kernels", "plain", "fp32") for k in ("loss", "jvps")},
           "vs_fp32": {"kernels": kern["vs_fp32"], "plain": plain["vs_fp32"]},
           "fp32_limit": DENSE_LONG_FP32_RTOL, "plain_mult": DENSE_LONG_PLAIN_MULT,
           "kernels_vs_plain": vs_plain, "kernels_vs_plain_limit": DENSE_LONG_RTOL,
           "kernels_vs_plain_within": max(vs_plain.values()) <= DENSE_LONG_RTOL,
           "s_kernels": kern["s"], "s_plain": plain["s"],
           "launches": {k: n for k, n in counts.items() if n},
           "paths": {k: by for k, by in paths.items() if any(by.values())}, "card": smi}
    log("[dense] long estimate, kernels and plain versions on the card vs the fp32 "
        "estimate: " + json.dumps(res))
    if counts != want:
        raise AssertionError(f"dense long estimate: launches {counts} != {want}")
    check_paths("dense long estimate", paths, {k: dict.fromkeys(by, 0)
                                               for k, by in paths.items()})
    k32, p32 = kern["vs_fp32"], plain["vs_fp32"]
    if not (math.isfinite(kern["loss"]) and torch_finite(kern["jvps"])
            and max(*k32.values(), *p32.values()) <= DENSE_LONG_FP32_RTOL
            and k32["jvps"] <= DENSE_LONG_PLAIN_MULT * p32["jvps"]):
        raise AssertionError(f"dense long estimate: the routes vs fp32 {res}")
    return counts, paths


def torch_finite(t):
    import torch
    return bool(torch.isfinite(t).all())


def dense_decode_vs_forward(arch, n_layers, prompt_len, smi, tag="dense",
                            rtol=None):
    """``arch`` at full width and ``n_layers`` layers in fp32 (random weights,
    synthetic adapter 0; an encoder-decoder's random frames encoded into the
    cache): the prompt's first prompt_len - 1 tokens prefilled, its last one
    decoded at position prompt_len - 1, the step's logits held against the
    teacher-forced forward over the whole prompt within ``rtol`` (default
    DENSE_FP32_DECODE_RTOL) of the largest |logit| (the reference's
    tests/test_arch_smoke.py checks the same on its reduced configs)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.adapter_cache import SyntheticAdapterStore
    from repro_torch.launch.serve import build_serve_fns, can_fuse_prefill, encode_into_cache
    from repro_torch.models import get_model

    rtol = DENSE_FP32_DECODE_RTOL if rtol is None else rtol
    full = get_config(arch)
    cfg = dataclasses.replace(full, param_dtype="float32", n_layers=n_layers)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = model.init_base(cfg, gen)
    peft = SyntheticAdapterStore(cfg, seed=0, device="cuda").load(0)
    toks = torch.randint(0, cfg.vocab, (1, prompt_len), generator=gen, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": toks}
    fns = build_serve_fns(cfg, model)
    cache = model.init_cache(cfg, 1, prompt_len, device="cuda")
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                                      device="cuda")
        encode_into_cache(cfg, base, peft, cache, batch["frames"])
    if not can_fuse_prefill(cfg, model, cache, prompt_len - 1):
        raise AssertionError(f"{tag} {arch}: the prompt cannot take the fused prefill")
    _, cache = fns["prefill"](base, peft, cache, toks[:, :-1])
    got = fns["decode"](base, peft, cache, toks[:, -1:], prompt_len - 1)[0].float()
    with torch.inference_mode():
        h, _ = model.forward(cfg, base, peft, batch)
        want = (h[:, -1, :] @ model.unembed(cfg, base)).float()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    res = {"arch": arch, "n_layers": f"{full.n_layers} -> {n_layers}", "dtype": "float32",
           "prompt_len": prompt_len, "cache_slots": int(cache["k"].shape[2]),
           "window": cfg.window, "mixed_local_global": any(
               cfg.is_global_layer(i) for i in range(n_layers)) and cfg.attn_pattern != "full",
           "max_abs_logit": scale, "rel_err": rel, "limit": rtol, "card": smi}
    log(f"[{tag}] {arch} decode step vs teacher-forced forward: " + json.dumps(res))
    del base, peft, cache, h, batch
    _free()
    if not rel <= rtol:
        raise AssertionError(f"{tag} {arch}: decode vs teacher-forced forward {res}")


def dense_serve(arch, cfg, totals, path_totals, smi, seed=0, tag="dense",
                witness_layers=None):
    """``arch`` (``cfg``: full width, DENSE_LAYERS' depth) in bf16 through
    ``serve.run_engine`` (weights, adapters and prompts from ``seed``): 4
    requests on 4 adapters (max_batch 4, P=16, 32 new tokens), exactly
    ``serve_launches``, every one on the stream route, every call of the
    first batched decode step held against the plain version at the bf16
    tolerance; the same engine with the plain version, which launches
    nothing; each request's first decode-step logits from both engines
    against its own B=1 greedy step (the plain single-adapter primal)
    within SERVE_BF16_ATOL[arch]; ``greedy_generate`` (B=4, adapter 0, 32
    steps), which must launch nothing; then ``serve_fp32_witness`` on the
    card at ``witness_layers``' depth (default DENSE_WITNESS_LAYERS', else
    the config's; 0: none) within SERVE_FP32_ATOL[arch]. An encoder-decoder
    request's frames are encoded with its adapter (greedy's B=4 frames from
    the prompts' generator). The engines run one after the other, each on
    its own copy of the weights (the same draws), so that one copy is held
    at a time. ``tag`` heads the printed lines."""
    import dataclasses

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    P, steps = 16, 32
    if witness_layers is None:
        witness_layers = DENSE_WITNESS_LAYERS.get(arch, cfg.n_layers)
    outputs, engine, log_steps, counts, paths, peak, calls = _run_engine_recorded(
        cfg, P, steps, n_requests=4, n_adapters=4, seed=seed)
    want = serve_launches(cfg, engine.steps)
    in_situ = hold_decode_step(arch, calls)
    n_tok = sum(len(v) for v in outputs.values())
    res = {"seed": seed, "requests": len(outputs), "decode_steps": engine.steps,
           "e2e_s": engine.run_s, "e2e_tok_per_s": n_tok / engine.run_s,
           "steady_decode_tok_per_s": sum(x["n_active"] for x in log_steps)
           / sum(x["s"] for x in log_steps),
           "mean_decode_step_ms": 1e3 * sum(x["s"] for x in log_steps) / len(log_steps),
           "peak_GiB": peak, "in_situ_first_decode_step": in_situ,
           "lora_dual_multi_per_decode_step": want["lora_dual_multi"] // engine.steps,
           "lora_dual_multi_by_route": paths["lora_dual_multi"], "card": smi}
    log(f"[{tag}] {arch} serve engine: " + json.dumps(res))
    if counts != want or len(log_steps) != engine.steps:
        raise AssertionError(f"{tag} serve {arch}: launches {counts} != {want}")
    if paths["lora_dual_multi"] != {"stream": want["lora_dual_multi"], "simt": 0}:
        raise AssertionError(f"{tag} serve {arch}: decode launches by route "
                             f"{paths['lora_dual_multi']}, not all stream")
    if in_situ["calls"] != serve_launches(cfg, 1)["lora_dual_multi"]:
        raise AssertionError(f"{tag} serve {arch}: first decode step held {in_situ}")
    for k, n in counts.items():
        totals[k] += n
    for route, n in paths["lora_dual_multi"].items():
        path_totals["lora_dual_multi"][route] += n
    first = {"kernel": {x: r for st in log_steps for x, r in st["rows"].items()}}
    del engine, calls
    _free()

    p_out, engine, p_log, p_counts, _, _, _ = _run_engine_recorded(
        cfg, P, steps, plain=True, n_requests=4, n_adapters=4, seed=seed)
    if any(p_counts.values()):
        raise AssertionError(f"{tag} serve {arch} engine, plain version: launched {p_counts}")
    first["plain"] = {x: r for st in p_log for x, r in st["rows"].items()}
    base, store, model = engine.base, engine.adapters.store, engine.model
    requests = engine.requests
    fns = serve.build_serve_fns(cfg, model)
    del engine
    gc.collect()

    reset_launch_counts()
    errs, max_logit = {"kernel": [], "plain": []}, 0.0
    for req in requests:            # each request's own B=1 first decode step
        prompt1 = torch.as_tensor(req.prompt, device="cuda")[None]
        peft1 = store.load(req.adapter_id)
        cache1 = model.init_cache(cfg, 1, P + steps, device="cuda")
        if req.frames is not None:
            serve.encode_into_cache(cfg, base, peft1, cache1,
                                    torch.as_tensor(req.frames, device="cuda")[None])
        logits, cache1 = fns["prefill"](base, peft1, cache1, prompt1)
        tok1 = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        g = fns["decode"](base, peft1, cache1, tok1, P)[0][0].float().cpu()
        max_logit = max(max_logit, float(g.abs().max()))
        for route, rows in first.items():
            errs[route].append(float((rows[req.request_id] - g).abs().max()))
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (4, P), generator=gen, device="cuda",
                           dtype=torch.int32)
    frames = (torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda")
              if cfg.encoder_layers else None)
    peft = store.load(0)
    serve.greedy_generate(cfg, base, peft, prompt, 1, cache_len=P + steps, fns=fns,
                          frames=frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = serve.greedy_generate(cfg, base, peft, prompt, steps, cache_len=P + steps, fns=fns,
                                frames=frames)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    g_counts = launch_counts()
    res = {"seed": seed, "batch": 4, "prompt_len": P, "steps": steps, "e2e_s": e2e,
           "e2e_tok_per_s": 4 * steps / e2e,
           "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": {k: n for k, n in g_counts.items() if n},
           "sample_ids": ids[0, :8].tolist(),
           "engine_first_step_vs_greedy": {
               "max_abs_err": {k: max(v) for k, v in errs.items()}, "per_request": errs,
               "max_abs_logit": max_logit, "limit": SERVE_BF16_ATOL[arch]},
           "card": smi}
    log(f"[{tag}] {arch} greedy: " + json.dumps(res))
    del base, store, model, fns, peft, frames
    _free()
    if any(g_counts.values()):
        raise AssertionError(f"{tag} serve {arch}: greedy launched kernels {g_counts}")
    if not (math.isfinite(e2e) and max(errs["kernel"] + errs["plain"])
            <= SERVE_BF16_ATOL[arch]):
        raise AssertionError(f"{tag} serve {arch}: engines vs greedy {res}")
    if not witness_layers:
        return
    n = witness_layers
    wit = serve_fp32_witness(arch, cfg=dataclasses.replace(cfg, n_layers=n), cpu=False,
                             seed=seed)
    wit.update(seed=seed, n_layers=n, limit=SERVE_FP32_ATOL[arch], card=smi)
    log(f"[{tag}] {arch} fp32 witness, one batched decode step (B=4, four adapters) "
        f"vs the B=1 steps: " + json.dumps(wit))
    _free()
    if max(wit["kernel_max_abs_err_vs_b1"], wit["plain_max_abs_err_vs_b1"]) > \
            SERVE_FP32_ATOL[arch]:
        raise AssertionError(f"{tag} serve {arch}: fp32 witness {wit}")


def phase_dense(totals, path_totals, smi):
    """Phase 9: train, estimate at long context and serve the four configs
    at full published width (command-r-plus-104b at DENSE_LAYERS' depth,
    printed as ``reduced``), freeing each model before the next; ends with
    the device memory allocated at its start."""
    import torch
    t_phase = time.time()
    _free()
    held_before = torch.cuda.memory_allocated()
    g12, g27, h2o, cr = DENSE_ARCHS
    runs = [(g12, "spry", 4, 1, 2, False), (g12, "spry", 4, 1, 2, True),
            (g12, "fedavg", 1, 1, 2, False), (g27, "spry", 4, 1, 2, False),
            (h2o, "spry", 4, 1, 2, False), (h2o, "spry", 4, 1, 2, True),
            (cr, "spry", 4, 1, 2, False)]
    dense_paths = {k: dict.fromkeys(by, 0) for k, by in path_totals.items()}
    results = []
    for run in runs:
        with dense_depth(run[0]) as cfg:
            results += phase_train([run], totals, dense_paths, cfg)
        _free()
    for k, by in dense_paths.items():
        for route, n in by.items():
            path_totals[k][route] += n
    log("[dense] s/round and round peak GiB (2 clients, batch 8 x 32 tokens, one "
        "round): " + json.dumps({f"{r['arch']} {r['method']} {r['route']}":
                                 {"round_s": r["round_s"][0],
                                  "round_peak_GiB": r["round_peak_GiB"]}
                                 for r in results}))
    log("[train] launches of rows 1-5 by route over the dense runs (simt must be "
        "0): " + json.dumps({k: by for k, by in dense_paths.items()
                             if k in ("lora_dual_mt", "swa_attention", "swa_attention_mt",
                                      "swa_attention_mt_jvps", "lora_dual_mt_jvps")}))
    tp = time.time()
    counts, paths = dense_long_estimate(smi)
    for k, n in counts.items():
        totals[k] += n
    for k, by in paths.items():
        for route, n in by.items():
            path_totals[k][route] += n
    log(f"[dense] long estimate {time.time() - tp:.1f}s")
    tp = time.time()
    before = dict(path_totals["lora_dual_multi"])
    for arch in DENSE_ARCHS:
        with dense_depth(arch) as cfg:
            dense_serve(arch, cfg, totals, path_totals, smi)
    log("[dense] lora_dual_multi launches by route over the four engines (simt must "
        "be 0): " + json.dumps({r: n - before[r]
                                for r, n in path_totals["lora_dual_multi"].items()}))
    # decode against teacher forcing in fp32: gemma3-12b past its window
    # (1100 > 1024) with 6 layers, so that layer 5 is global and the decode
    # mixes windows; h2o-danube's 4096-slot ring wrapped by 8 tokens
    dense_decode_vs_forward("gemma3-12b", 6, 1100, smi)
    dense_decode_vs_forward("h2o-danube-3-4b", 3, 4104, smi)
    log(f"[dense] serving {time.time() - tp:.1f}s")
    _free()
    held = torch.cuda.memory_allocated()
    log(f"[dense] device memory allocated before / after the phase: "
        f"{held_before / 2 ** 30:.3f} / {held / 2 ** 30:.3f} GiB; phase "
        f"{time.time() - t_phase:.1f}s")
    if held != held_before:
        raise AssertionError(f"phase 9 left {held - held_before} bytes allocated")


# ---------------------------------------------------------------------------
# phase 10: the moe, vlm and encoder-decoder families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "internvl2-76b",
                "whisper-tiny")
# the depth cuts, bf16 weights on one 80 GB card (whisper-tiny whole):
# qwen3 4.97 GB a layer (128 experts) + 2.5 GB of embeddings, llama4 32.6
# GB a layer + 4.1 GB, internvl2 1.71 GB a layer + 4.2 GB
FAMILY_LAYERS = {"qwen3-moe-235b-a22b": 8, "llama4-maverick-400b-a17b": 2,
                 "internvl2-76b": 24}
# where fp32 weights fit beside the bf16 ones freed (llama4's one fp32
# layer is 65 GB: none): the fp32 estimate, witness and decode depths
FAMILY_FP32_LAYERS = {"qwen3-moe-235b-a22b": 4, "internvl2-76b": 12, "whisper-tiny": 4}
# the frontend batches of the estimates: B=2, 32 text tokens after P patch
# embeddings (attention over P + 32), whisper's 1500 frames
FAMILY_EST_B, FAMILY_EST_S = 2, 32
# the estimates (split LM loss, K=4, both routes), largest relative drift
# (loss relative, jvps of the largest |jvp|) over seeds 0-2, the limits
# about twice the largest (scripts/dense_readings.py families; PERF.md,
# Findings). Kernels vs plain versions on the card, bf16: internvl2 0.025 /
# 0.031 / 0.036 at 24 layers, 0.090 / 0.066 / 0.048 at 12; whisper 0.0041
# / 0.022 / 0.011; llama4 with the routing pinned 0.024 / 0.032 / 0.012
# (unpinned 0.38 / 0.52 / 0.077: 11, 13 and 6 of 640 top-1 decisions flip
# between the kernel's and the plain primal). Each bf16 run against the
# fp32 estimate: internvl2 at 12 layers kernels 0.081 / 0.065 / 0.044,
# plain 0.087 / 0.086 / 0.017; whisper kernels 0.009 / 0.014 / 0.017,
# plain 0.009 / 0.009 / 0.026
FAMILY_EST_PLAIN_RTOL = {"llama4-maverick-400b-a17b": 0.07, "internvl2-76b": 0.18,
                         "whisper-tiny": 0.05}
FAMILY_EST_FP32_RTOL = {"internvl2-76b": 0.18, "whisper-tiny": 0.05}
# fp32 decode step vs teacher-forced forward (of the largest |logit|), as
# phase 9's: qwen3 read 1.5e-6, whisper 4.9e-7
FAMILY_FP32_DECODE_RTOL = 2e-5
# qwen3's prompt for it: 4 tokens, so that no expert (capacity 4 in a
# chunk of up to 51 tokens) can drop one in the forward that the decode
# step keeps
FAMILY_DECODE_PROMPT = {"qwen3-moe-235b-a22b": 4, "whisper-tiny": 64}


def family_depth(arch, n_layers=None):
    """``depth_cut`` at FAMILY_LAYERS' depth (or ``n_layers``)."""
    return bf16_depth(arch, n_layers or FAMILY_LAYERS.get(arch))


def family_batch(cfg, gen, B=FAMILY_EST_B, S=FAMILY_EST_S):
    """An LM batch with the config's frontend: B x S tokens, and P patch
    embeddings (vlm, llama4) or the encoder's frames (whisper), standard
    normal, from ``gen``."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")}
    if cfg.n_frontend_tokens:
        batch["patch_embeds"] = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=gen, device="cuda")
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                                      device="cuda")
    return batch


@contextlib.contextmanager
def moe_routing(record=None, replay=None):
    """Each MoE block's top-k routing decisions, in call order: appended to
    ``record`` (a list), or taken from ``replay`` (the gates gathered at
    the replayed experts, so the tangents still flow through them): a run
    then routes every token as the recorded run did."""
    import torch
    from repro_torch.models import moe
    orig, it = moe._top_k, None if replay is None else iter(replay)

    def top_k(gates, k):
        if it is not None:
            idx = next(it)
            return torch.gather(gates, -1, idx), idx
        g, idx = orig(gates, k)
        record.append(idx.clone())
        return g, idx
    moe._top_k = top_k
    try:
        yield
    finally:
        moe._top_k = orig


def family_estimate_readings(cfg, seed=0, fp32=False, K=4):
    """``forward_gradient`` of the registry's split LM loss on ``cfg`` (bf16,
    random weights, batch and perturbations from ``seed``) on the standard
    and the fused route, through the kernels and through their plain
    versions on the card, and (``fp32``) once more with the weights in fp32
    through the plain versions, the estimate the bf16 runs approximate.
    A MoE config's runs are made twice: as they route, and with every token
    routed as the plain forward routes it (``moe_routing``; keys
    ``pinned_*``), which takes the experts a rounding flips out of the
    comparison; ``flips`` counts the routing decisions (token, choice) in
    which the forward with the attention kernel and the plain forward
    differ. Returns the launches and launches by route of each unpinned
    kernel run, each run's loss, jvps and seconds (with the drift from the
    fp32 estimate), and the flips."""
    import dataclasses

    import torch
    from repro_torch.configs import SpryConfig
    from repro_torch.core.forward_grad import forward_gradient, stacked_perturbations
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    from repro_torch.kernels.dispatch import forward_ad_region
    from repro_torch.models import get_model
    from repro_torch.models.registry import split_lm_loss
    from repro_torch.peft import init_peft
    from repro_torch.utils.pytree import tree_map, tree_paths

    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, SpryConfig())
    batch = family_batch(cfg, gen)
    vs = stacked_perturbations(11 + seed, tree_map(lambda x: x.float(), peft), list(range(K)))

    def estimate(c, fused, routing=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if routing is not None:
                stack.enter_context(moe_routing(replay=routing))
            loss, _, jvps = forward_gradient(split_lm_loss(c, base, batch), peft, 11 + seed,
                                             K, perturbations=vs, fused_contraction=fused)
        torch.cuda.synchronize()
        return {"loss": float(loss), "jvps": jvps.float().cpu(),
                "s": time.perf_counter() - t0}
    routing, flips = None, None
    if cfg.moe is not None:
        routing, kernel_routing = [], []
        with torch.no_grad():
            with moe_routing(record=routing):
                split_lm_loss(cfg, base, batch)(peft)
            with moe_routing(record=kernel_routing), forward_ad_region():
                split_lm_loss(cfg, base, batch)(peft)
        flips = {"decisions": sum(r.numel() for r in routing),
                 "flipped": sum(int((a != b).sum()) for a, b in zip(routing, kernel_routing))}
    out, counts, paths = {}, {}, {}
    for route in ("standard", "fused"):
        fused = route == "fused"
        estimate(cfg, fused)                        # warm: allocator and libraries
        reset_launch_counts()
        out[f"kernels_{route}"] = estimate(cfg, fused)
        counts[route], paths[route] = launch_counts(), launch_paths()
        with plain_dispatch():
            out[f"plain_{route}"] = estimate(cfg, fused)
        if routing is not None:
            out[f"pinned_kernels_{route}"] = estimate(cfg, fused, routing)
            with plain_dispatch():
                out[f"pinned_plain_{route}"] = estimate(cfg, fused, routing)
    if fp32:
        with plain_dispatch():
            for *head, last in [p for p, _ in tree_paths(base)]:   # a leaf at a time
                node = base
                for k in head:
                    node = node[k]
                node[last] = node[last].float()
            out["fp32"] = estimate(dataclasses.replace(cfg, param_dtype="float32"), False,
                                   routing)
        for name, r in out.items():
            if name != "fp32":
                r["vs_fp32"] = {"loss": abs(r["loss"] - out["fp32"]["loss"])
                                / abs(out["fp32"]["loss"]),
                                "jvps": rel_max(r["jvps"], out["fp32"]["jvps"])}
    del base, peft, vs, batch, routing
    _free()
    return counts, paths, out, flips


def kernels_vs_plain(r, prefix=""):
    """Each route's drift of the kernels' estimate from the plain versions'
    (loss relative, jvps of the largest |jvp|)."""
    return {route: {"loss": abs(r[f"{prefix}kernels_{route}"]["loss"]
                                - r[f"{prefix}plain_{route}"]["loss"])
                    / abs(r[f"{prefix}plain_{route}"]["loss"]),
                    "jvps": rel_max(r[f"{prefix}kernels_{route}"]["jvps"],
                                    r[f"{prefix}plain_{route}"]["jvps"])}
            for route in ("standard", "fused")}


def family_estimate(arch, cfg, smi, totals, path_totals, fp32=False):
    """``family_estimate_readings`` (seed 0) held: each route's launches
    exactly ``round_launches`` of one estimate, all on the tensor-core
    route; the kernels within FAMILY_EST_PLAIN_RTOL of the plain versions
    (loss and jvps) on each route, a MoE config's with the routing pinned
    (its unpinned drift and the flipped decisions printed); with ``fp32``,
    every bf16 run within FAMILY_EST_FP32_RTOL of the fp32 estimate."""
    counts, paths, r, flips = family_estimate_readings(cfg, fp32=fp32)
    drift = kernels_vs_plain(r)
    held = kernels_vs_plain(r, "pinned_") if flips is not None else drift
    res = {"arch": arch, "n_layers": cfg.n_layers, "B": FAMILY_EST_B, "S": FAMILY_EST_S,
           "patches": cfg.n_frontend_tokens, "frames": cfg.encoder_seq, "K": 4,
           "loss": {k: v["loss"] for k, v in r.items()},
           "jvps": {k: v["jvps"].tolist() for k, v in r.items()},
           "s": {k: v["s"] for k, v in r.items()},
           "kernels_vs_plain": drift, "routing_flips": flips,
           "kernels_vs_plain_pinned": held if flips is not None else None,
           "limit": FAMILY_EST_PLAIN_RTOL[arch],
           "launches": {route: {k: n for k, n in c.items() if n} for route, c in counts.items()},
           "card": smi}
    if fp32:
        res["vs_fp32"] = {k: v["vs_fp32"] for k, v in r.items() if k != "fp32"}
        res["fp32_limit"] = FAMILY_EST_FP32_RTOL[arch]
    log(f"[families] {arch} estimate with a frontend batch, kernels vs plain versions"
        + (" and vs the fp32 estimate" if fp32 else "") + ": " + json.dumps(res))
    for route in ("standard", "fused"):
        want = round_launches(cfg, route, 1)
        if counts[route] != want:
            raise AssertionError(f"families {arch} estimate {route}: launches "
                                 f"{counts[route]} != {want}")
        check_paths(f"families {arch} estimate {route}", paths[route], path_totals)
        for k, n in counts[route].items():
            totals[k] += n
    if not (all(math.isfinite(v["loss"]) and torch_finite(v["jvps"]) for v in r.values())
            and max(max(d.values()) for d in held.values()) <= FAMILY_EST_PLAIN_RTOL[arch]):
        raise AssertionError(f"families {arch} estimate: kernels vs plain {res}")
    if fp32 and max(max(d.values()) for d in res["vs_fp32"].values()) > \
            FAMILY_EST_FP32_RTOL[arch]:
        raise AssertionError(f"families {arch} estimate: vs fp32 {res}")


def phase_families(totals, path_totals, smi):
    """Phase 10: train, estimate with a frontend batch and serve the moe
    (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b), vlm (internvl2-76b)
    and encoder-decoder (whisper-tiny) configs at full published width
    (FAMILY_LAYERS' depths, printed as ``reduced``), freeing each model
    before the next; ends with the device memory allocated at its start."""
    import torch
    t_phase = time.time()
    _free()
    held_before = torch.cuda.memory_allocated()
    qw, l4, iv, wh = FAMILY_ARCHS
    # the train tasks carry tokens only (the reference's too): the moe and
    # vlm configs train text-only; whisper's loss needs frames (estimate below)
    runs = [(qw, "spry", 4, 1, 2, False), (qw, "spry", 4, 1, 2, True),
            (qw, "fedavg", 1, 1, 2, False), (iv, "spry", 4, 1, 2, False),
            (iv, "spry", 4, 1, 2, True), (l4, "spry", 4, 1, 2, False)]
    fam_paths = {k: dict.fromkeys(by, 0) for k, by in path_totals.items()}
    results = []
    for run in runs:
        with family_depth(run[0]) as cfg:
            results += phase_train([run], totals, fam_paths, cfg)
        _free()
    log("[families] s/round and round peak GiB (2 clients, batch 8 x 32 tokens, one "
        "round): " + json.dumps({f"{r['arch']} {r['method']} {r['route']}":
                                 {"round_s": r["round_s"][0],
                                  "round_peak_GiB": r["round_peak_GiB"]}
                                 for r in results}))
    tp = time.time()
    for arch, n, fp32 in ((iv, None, False), (iv, FAMILY_FP32_LAYERS[iv], True),
                          (l4, None, False), (wh, None, True)):
        with family_depth(arch, n) as cfg:
            family_estimate(arch, cfg, smi, totals, fam_paths, fp32=fp32)
    for k, by in fam_paths.items():
        for route, n in by.items():
            path_totals[k][route] += n
    log("[train] launches of rows 1-4 by route over the families' runs and estimates "
        "(simt must be 0): " + json.dumps({k: by for k, by in fam_paths.items()
                                           if k in ("lora_dual_mt", "swa_attention",
                                                    "swa_attention_mt",
                                                    "swa_attention_mt_jvps")}))
    log(f"[families] estimates {time.time() - tp:.1f}s")
    tp = time.time()
    before = dict(path_totals["lora_dual_multi"])
    for arch in FAMILY_ARCHS:
        with family_depth(arch) as cfg:
            dense_serve(arch, cfg, totals, path_totals, smi, tag="families",
                        witness_layers=FAMILY_FP32_LAYERS.get(arch, 0))
    # llama4's fp32 weights do not fit at one layer (65 GB): its reduced fp32
    # engine on the card against the CPU instead
    phase_serve_parity(l4)
    log("[families] lora_dual_multi launches by route over the four engines (simt "
        "must be 0): " + json.dumps({r: n - before[r]
                                     for r, n in path_totals["lora_dual_multi"].items()}))
    for arch, P in FAMILY_DECODE_PROMPT.items():
        dense_decode_vs_forward(arch, FAMILY_FP32_LAYERS[arch], P, smi, tag="families",
                                rtol=FAMILY_FP32_DECODE_RTOL)
    log(f"[families] serving {time.time() - tp:.1f}s")
    _free()
    held = torch.cuda.memory_allocated()
    log(f"[families] device memory allocated before / after the phase: "
        f"{held_before / 2 ** 30:.3f} / {held / 2 ** 30:.3f} GiB; phase "
        f"{time.time() - t_phase:.1f}s")
    if held != held_before:
        raise AssertionError(f"phase 10 left {held - held_before} bytes allocated")


# ---------------------------------------------------------------------------
# phase 11: the ia3, bitfit and classifier_only PEFT trees at full width
# ---------------------------------------------------------------------------

PEFT_KINDS = ("ia3", "bitfit", "classifier_only")
PEFT_COUNTS = {"ia3": (126980, 48), "bitfit": (53252, 48), "classifier_only": (4100, 0)}
PEFT_M, PEFT_K = 4, 4            # clients a round, perturbations an estimate
# the first round's kernels against the plain versions on the card (bf16):
# loss (relative), jvps (of the largest |jvp|) and the new PEFT's update
# (of the largest |update|); about twice the largest of seeds 0-2 on both
# routes and all three kinds (0.0028, 0.0253, 0.0285;
# scripts/dense_readings.py peft)
PEFT_PLAIN_RTOL = {"loss": 6e-3, "jvps": 0.05, "update": 0.06}
PEFT_PREFILL_RTOL = 2e-5         # reduced llama2, fp32: fused prefill vs token loop


def peft_setup(kind, seed=0):
    """roberta-large-lora at full width on the card (bf16 base), the
    ``kind`` tree from ``init_peft`` and a batch of PEFT_M clients x 8 x 32
    tokens, all from ``seed``."""
    import torch
    from repro_torch.configs import SpryConfig, get_config
    from repro_torch.models import get_model
    from repro_torch.peft import init_peft
    cfg = get_config("roberta-large-lora")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    peft = init_peft(cfg, gen, SpryConfig(peft=kind))
    batch = {"tokens": torch.randint(0, cfg.vocab, (PEFT_M, 8, 32), generator=gen,
                                     device="cuda"),
             "labels": torch.randint(0, cfg.n_classes, (PEFT_M, 8), generator=gen,
                                     device="cuda")}
    return cfg, base, peft, batch


def peft_rounds(cfg, base, peft, batch, kind, fused, rounds, plain=False, seed=0):
    """``rounds`` SPRY rounds through ``make_round_step`` (the plain
    versions on the card with ``plain``); per round its metrics, seconds,
    peak device memory, launches and routes, and the new PEFT."""
    import torch
    from repro_torch.configs import SpryConfig
    from repro_torch.core.spry import init_state, make_round_step
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    sc = SpryConfig(peft=kind, n_clients_per_round=PEFT_M, k_perturbations=PEFT_K,
                    fused_contraction=fused, seed=seed)
    step = make_round_step(cfg, sc, "cls")
    state = init_state(base, peft)
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t = time.time()
        with plain_dispatch() if plain else contextlib.nullcontext():
            state, met = step(state, batch)
        torch.cuda.synchronize()
        out.append({"s": time.time() - t, "loss": float(met["loss"]),
                    "jvps": met["jvps"].float().clone(), "peft": state.peft,
                    "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": launch_counts(), "paths": launch_paths()})
    return out


def _update_rel(got, want, peft):
    """max |got - want| / max |want - peft| over the trees' leaves: two new
    PEFT trees against the update from ``peft``."""
    from repro_torch.utils.pytree import tree_leaves
    num = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    den = max(float((b.float() - p.float()).abs().max())
              for b, p in zip(tree_leaves(want), tree_leaves(peft)))
    return num / max(den, 1e-30)


def peft_readings(kind, seed=0, rounds=1):
    """The first round of ``kind`` on both routes, kernels and plain versions
    on the card: the kernel runs and the readings of kernels against plain
    (loss, jvps, update)."""
    cfg, base, peft, batch = peft_setup(kind, seed)
    out = {}
    for fused in (False, True):
        kern = peft_rounds(cfg, base, peft, batch, kind, fused, rounds, seed=seed)
        plain = peft_rounds(cfg, base, peft, batch, kind, fused, 1, plain=True, seed=seed)
        k0, p0 = kern[0], plain[0]
        out["fused" if fused else "standard"] = {
            "runs": kern,
            "plain_s": p0["s"],
            "loss": abs(k0["loss"] - p0["loss"]) / abs(p0["loss"]),
            "jvps": rel_max(k0["jvps"], p0["jvps"]),
            "update": _update_rel(k0["peft"], p0["peft"], peft)}
    return cfg, base, peft, batch, out


def peft_periter(cfg, base, peft, batch, kind, totals, path_totals, seed=0):
    """One spry_periter round (fused route): each client's estimate equals
    the server's rebuild from its K jvps bit for bit, and the round makes
    exactly one estimate a client's launches."""
    import torch
    from repro_torch.configs import SpryConfig
    from repro_torch.core.assignment import (assignment_matrix, build_mask_tree,
                                             enumerate_units)
    from repro_torch.core.forward_grad import fold_in, forward_gradient
    from repro_torch.core.spry import (init_state, make_rebuild_fn,
                                       make_round_step_per_iteration, make_task_loss)
    from repro_torch.kernels import launch_counts, launch_paths, reset_launch_counts
    from repro_torch.utils.pytree import tree_leaves
    sc = SpryConfig(peft=kind, n_clients_per_round=PEFT_M, k_perturbations=PEFT_K,
                    fused_contraction=True, seed=seed)
    index = enumerate_units(peft)
    rows = assignment_matrix(index.n_units, PEFT_M, 0, device="cuda")
    rk = fold_in(sc.seed, 0)
    rebuild = make_rebuild_fn()
    for m in range(PEFT_M):
        cb = {k: v[m] for k, v in batch.items()}
        _, g, jvps = forward_gradient(
            make_task_loss(cfg, sc, "cls", base, cb), peft, fold_in(fold_in(rk, m), 0),
            PEFT_K, mask_tree=build_mask_tree(peft, index, rows[m]), fused_contraction=True)
        g_srv = rebuild(peft, rk, m, rows[m], jvps)
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g_srv))):
            raise AssertionError(f"peft {kind}: client {m}'s estimate != the server's rebuild")
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.time()
    _, met = make_round_step_per_iteration(cfg, sc, "cls")(init_state(base, peft), batch)
    torch.cuda.synchronize()
    secs = time.time() - t
    counts, paths = launch_counts(), launch_paths()
    want = round_launches(cfg, "fused", PEFT_M, peft=kind)
    if counts != want:
        raise AssertionError(f"peft {kind} spry_periter: launches {counts} != {want}")
    check_paths(f"peft {kind} spry_periter", paths, path_totals)
    for k, n in counts.items():
        totals[k] += n
    return {"loss": float(met["loss"]), "s": secs}


def peft_prefill(kind, seed=0):
    """Reduced llama2 in fp32 on the card with a ``kind`` tree (its scales or
    biases moved off identity): the fused prefill against the token loop,
    logits and every cache leaf (BitFit stays out of serving, as in the
    reference)."""
    import torch
    from repro_torch.configs import SpryConfig, get_config, reduce_config
    from repro_torch.launch.serve import build_serve_fns, tokenwise_prefill
    from repro_torch.models import get_model
    from repro_torch.peft import init_peft
    from repro_torch.utils.pytree import tree_map
    cfg = reduce_config(get_config("llama2-7b"))
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = model.init_base(cfg, gen)
    peft = init_peft(cfg, gen, SpryConfig(peft=kind))
    peft["layers"] = tree_map(
        lambda x: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda"),
        peft["layers"])
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=gen, device="cuda")
    fused = model.init_cache(cfg, 2, 16, device="cuda")
    loop = model.init_cache(cfg, 2, 16, device="cuda")
    lf, fused = build_serve_fns(cfg, model)["prefill"](base, peft, fused, prompt)
    with torch.inference_mode():
        ll, loop = tokenwise_prefill(cfg, model, base, peft, loop, prompt)
    errs = {"logits": rel_max(lf, ll)}
    errs.update({name: rel_max(fused[name], loop[name]) for name in loop})
    return errs


def peft_kind(kind, totals, path_totals, smi):
    """Phase 11 for one PEFT kind: the counts, the rounds on both routes
    with their launches and the plain versions' readings, and the
    per-iteration round."""
    from repro_torch.core.assignment import enumerate_units
    from repro_torch.peft import count_trainable
    cfg, base, peft, batch, read = peft_readings(kind, rounds=2)
    got = (count_trainable(peft), enumerate_units(peft).n_units)
    log(f"[peft] {kind}: count_trainable {got[0]}, units {got[1]}")
    if got != PEFT_COUNTS[kind]:
        raise AssertionError(f"peft {kind}: (trainable, units) {got} != {PEFT_COUNTS[kind]}")
    for route, r in read.items():
        for i, run in enumerate(r["runs"]):
            want = round_launches(cfg, route, PEFT_M, peft=kind)
            if run["launches"] != want:
                raise AssertionError(f"peft {kind} {route} round {i + 1}: launches "
                                     f"{run['launches']} != {want}")
            check_paths(f"peft {kind} {route}", run["paths"], path_totals)
            for k, n in run["launches"].items():
                totals[k] += n
            if not math.isfinite(run["loss"]):
                raise AssertionError(f"peft {kind} {route}: loss not finite")
            log(f"[peft] {kind} spry K={PEFT_K} {route} round {i + 1}: " + json.dumps(
                {"loss": run["loss"], "s_round": round(run["s"], 4),
                 "round_peak_GiB": round(run["peak_GiB"], 3),
                 "launches": {k: n for k, n in run["launches"].items() if n}})
                + f"  [{smi}]")
        reading = {k: r[k] for k in ("loss", "jvps", "update")}
        log(f"[peft] {kind} {route} first round, kernels vs plain versions on the "
            f"card (plain {r['plain_s']:.3f} s): " + json.dumps(reading)
            + f" limits {json.dumps(PEFT_PLAIN_RTOL)}")
        bad = {k: v for k, v in reading.items() if not v <= PEFT_PLAIN_RTOL[k]}
        if bad:
            raise AssertionError(f"peft {kind} {route}: kernels vs plain {bad} past "
                                 f"{PEFT_PLAIN_RTOL}")
    per = peft_periter(cfg, base, peft, batch, kind, totals, path_totals)
    log(f"[peft] {kind} spry_periter (fused): client estimate == server rebuild "
        f"bitwise; round loss {per['loss']:.6f}, {per['s']:.4f} s  [{smi}]")


def phase_peft(totals, path_totals, smi):
    """Phase 11 (see the module docstring)."""
    import torch
    t_phase = time.time()
    _free()
    held_before = torch.cuda.memory_allocated()
    for kind in PEFT_KINDS:
        peft_kind(kind, totals, path_totals, smi)
        _free()
    for kind in ("bitfit", "ia3"):
        errs = peft_prefill(kind)
        log(f"[peft] reduced llama2 fp32 with a {kind} tree: fused prefill vs token "
            f"loop " + json.dumps(errs) + f" limit {PEFT_PREFILL_RTOL}")
        if not all(e <= PEFT_PREFILL_RTOL for e in errs.values()):
            raise AssertionError(f"peft {kind}: prefill vs token loop {errs}")
    _free()
    held = torch.cuda.memory_allocated()
    log(f"[peft] device memory allocated before / after the phase: "
        f"{held_before / 2 ** 30:.3f} / {held / 2 ** 30:.3f} GiB; phase "
        f"{time.time() - t_phase:.1f}s")
    if held != held_before:
        raise AssertionError(f"phase 11 left {held - held_before} bytes allocated")


# ---------------------------------------------------------------------------
# phase 12: the analysis rules on the card
# ---------------------------------------------------------------------------

def phase_analysis(smi):
    """Phase 12: the lint (``python -m repro_torch.analysis.lint``) over
    every family on the card, in a process of its own (a profiler trace
    taken after this process's earlier sessions can miss its first
    launches), with its kernel calls at the main path's shapes profiled
    too; fails on any error finding."""
    import tempfile
    t_phase = time.time()
    fd, path = tempfile.mkstemp(suffix=".analysis.json")
    os.close(fd)
    try:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                               "--device", "cuda", "--json", path], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        log("[analysis] " + proc.stdout.rstrip().replace("\n", "\n[analysis] "))
        if proc.returncode not in (0, 1):
            raise AssertionError(f"analysis: the lint exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    s, rows = doc["summary"], doc["smem_kernels"]
    log("[analysis] kernel functions launched (threads and dynamic shared memory "
        "measured): " + json.dumps(sorted({row["function"] for row in rows
                                           if row["launched"]})))
    log(f"[analysis] {s['entrypoints']} entry points, {len(rows)} kernel instantiations "
        f"({sum(row['launched'] for row in rows)} launched in this run), findings "
        f"{json.dumps({k: s[k] for k in ('errors', 'warnings', 'info')})}; phase "
        f"{time.time() - t_phase:.1f}s  [{smi}]")
    if s["errors"] or proc.returncode:
        raise AssertionError(f"analysis: {s['errors']} error finding(s), lint exit "
                             f"{proc.returncode}")


# the tensor-core kernels: (library, a name fragment of each kernel's
# instantiations, the SASS instruction that proves tensor-core use; DMMA:
# the fp64 tensor cores). Every instantiation is counted: the mamba2 and
# wkv6 kernels' tangent-store and contraction (JVPS) modes alike
TENSOR_CORE_KERNELS = (("lora_dual", "lora_mt_tc_kernel", "HGMMA"),
                       ("lora_dual", "lora_jvps_tc_kernel", "HGMMA"),
                       ("swa_attention", "swa_tc_kernel", "HMMA"),
                       ("swa_attention", "swa_tc_mt_kernel", "HMMA"),
                       ("swa_attention", "swa_tc_jvps_kernel", "HMMA"),
                       ("mamba2_ssd", "mamba2_ssd_kernel", "DMMA"),
                       ("wkv6_chunk", "wkv6_chunk_kernel", "DMMA"))


def log_tensor_core_sass(build):
    """Count each tensor-core kernel's HGMMA / HMMA / DMMA instructions in the built
    library's SASS (``cuobjdump -sass``); fail if an instantiation has none."""
    from repro_torch.analysis import smem
    for lib, kernel, op in TENSOR_CORE_KERNELS:
        sass = smem.cuobjdump("-sass", str(build._target(lib)))
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
                if fn:
                    counts[fn] = 0
            elif fn and re.search(rf"\b{op}\b", line):
                counts[fn] += 1
        short = {re.sub(r"^.*?" + kernel, kernel, f)[:48]: n for f, n in counts.items()}
        log(f"[build] {lib}: {op} instructions in the SASS of {kernel}: " + json.dumps(short))
        if not counts or min(counts.values()) == 0:
            raise AssertionError(f"{lib}: {kernel} has no {op} instruction: {short}")


def check_dense_spills():
    """The resource use of the swa_attention tensor-core instantiations that
    serve gemma3-12b (16 column groups: hd 256, the wide plan) and
    h2o-danube-3-4b (8, padded: hd 120), read from the built library
    (``analysis.smem.res_usage``, so a library an earlier run built is read
    too): fails unless each of the 9 has no stack frame and no local
    memory, where spilled registers would go."""
    from repro_torch.analysis import smem
    use = {}
    for fn, u in smem.res_usage("swa_attention").items():
        k = re.search(r"swa_tc(_mt|_jvps)?_kernelILi(16|8)ELb([01])E", fn)
        if k:
            name = f"swa_tc{k.group(1) or ''}_kernel<{k.group(2)}, pad={k.group(3)}>"
            use[name] = {key: u[key] for key in ("reg", "stack", "local")}
    log("[build] swa_attention registers, stack and local bytes of the hd-256 and "
        "hd-120 tensor-core instantiations: " + json.dumps(use))
    if len(use) != 9 or any(u["stack"] or u["local"] for u in use.values()):
        raise AssertionError(f"swa_attention: resource use {use} (want no stack frame "
                             f"and no local memory in each of 9)")


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test of repro_torch")
    ap.add_argument("--only", choices=("kernels", "parity", "train", "serve", "runtime",
                                       "dense", "families", "peft", "analysis"),
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
    log_tensor_core_sass(build)
    check_dense_spills()

    tp = time.time()
    main_cases = phase_kernels() if args.only in (None, "kernels") else {}
    log(f"[phase] kernels {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "parity"):
        for fused in (False, True):
            phase_parity(fused)
            phase_parity(fused, "zamba2-1.2b", n_layers=3, hybrid_attn_every=2)
            phase_parity(fused, "zamba2-1.2b")      # final site attention
            phase_parity(fused, "rwkv6-1.6b")       # final site wkv6
    log(f"[phase] parity {time.time() - tp:.1f}s")
    from repro_torch.kernels import launch_counts, launch_paths
    totals = {k: 0 for k in launch_counts()}
    path_totals = {k: dict.fromkeys(by, 0) for k, by in launch_paths().items()}
    tp = time.time()
    if args.only in (None, "train"):
        phase_site(totals, path_totals)
        rb, ll, zb, rw = ("roberta-large-lora", "llama2-7b", "zamba2-1.2b",
                          "rwkv6-1.6b")
        results = phase_train(
            [(rb, "spry", 1, 1, 4, False), (rb, "spry", 8, 2, 4, False),
             (rb, "spry_periter", 8, 2, 4, False),
             (rb, "spry", 8, 2, 4, True), (rb, "spry_periter", 8, 2, 4, True),
             (rb, "fedfgd", 8, 2, 4, False)]
            + [(rb, m, 1, 1, 4, False) for m in ("fedavg", "fedyogi", "fedsgd",
                                                 "fedavgsplit", "fedmezo", "baffle",
                                                 "fwdllm")]
            + [(ll, "spry", 4, 1, 2, False), (ll, "spry", 4, 1, 2, True),
               (ll, "fedavg", 1, 1, 2, False)]
            + [(zb, "spry", 8, 2, 4, False), (zb, "spry", 8, 1, 4, True),
               (zb, "spry_periter", 8, 1, 4, True), (zb, "fedavg", 1, 1, 4, False)]
            + [(rw, "spry", 8, 2, 4, False), (rw, "spry", 8, 1, 4, True),
               (rw, "spry_periter", 8, 1, 4, True), (rw, "fedavg", 1, 1, 4, False)],
            totals, path_totals)
        lora = {f"{r['method']}_{r['route']}": r["round_launches"][0]["lora_dual_mt"]
                for r in results if r["arch"] == rw and r["route"] != "none"}
        log(f"[train] {rw} lora_dual_mt launches a round, by route (the final "
            f"layer's wr and wv sit before the wkv6 site): " + json.dumps(lora))
        if len(set(lora.values())) != 1:
            raise AssertionError(f"train {rw}: LoRA launches differ by route {lora}")
        for arch, what in ((ll, "2 clients"), (zb, "4 clients"), (rw, "4 clients")):
            peak = {f"{r['method']}_{r['route']}": r["round_peak_GiB"]
                    for r in results if r["arch"] == arch}
            log(f"[train] {arch} peak device memory GiB of a round ({what}, batch "
                f"8 x 32 tokens): " + json.dumps(peak))
        log("[train] launches of rows 1-5, 8, 9 and 12 by route over the site and "
            "train phases (simt and rec must be 0): " + json.dumps(path_totals))
    log(f"[phase] site and train {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "serve"):
        phase_serve_parity()
        phase_serve_parity("rwkv6-1.6b")
        phase_serve_parity("zamba2-1.2b", n_layers=3, hybrid_attn_every=2)
        serve_telemetry()
        before = dict(path_totals["lora_dual_multi"])
        for arch in ("llama2-7b", "rwkv6-1.6b", "zamba2-1.2b"):
            phase_serve(arch, totals, path_totals, smi)
            gc.collect()                # the engines' decode closures form cycles
            torch.cuda.empty_cache()    # so the next arch's peak is its own
        log("[serve] lora_dual_multi launches by route over the three full-size "
            "engines (simt must be 0): " + json.dumps(
                {r: n - before[r] for r, n in path_totals["lora_dual_multi"].items()}))
    log(f"[phase] serve {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "runtime"):
        phase_runtime(totals, path_totals)
    log(f"[phase] runtime {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "dense"):
        phase_dense(totals, path_totals, smi)
    log(f"[phase] dense {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "families"):
        phase_families(totals, path_totals, smi)
    log(f"[phase] families {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "peft"):
        before = dict(totals)
        phase_peft(totals, path_totals, smi)
        log("[peft] launches of the phase: " + json.dumps(
            {k: n - before[k] for k, n in totals.items() if n != before[k]}))
    log(f"[phase] peft {time.time() - tp:.1f}s")
    tp = time.time()
    if args.only in (None, "analysis"):
        phase_analysis(smi)
    log(f"[phase] analysis {time.time() - tp:.1f}s")
    if args.only is None:
        missing = [k for k, n in totals.items() if n == 0]
        if missing:
            raise AssertionError(f"main path (phases 5-11) never launched {missing}")
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
        kernels[-1].update({k: c[k] for k in ("cold_ms", "plain_cold_ms",
                                              "yardstick_cold_ms") if k in c})
        if name in path_totals:
            kernels[-1]["launches_by_path"] = path_totals[name]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
