"""Batched serving of a (SPRY-finetuned) model: prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --full-size [--engine N --batch B --cache-capacity C]

Port of ``repro/launch/serve.py``: the single-tenant greedy loop and, with
``--engine N``, the multi-tenant continuous-batching ``ServingEngine``
(``launch/serving.py``) over a paged ``AdapterCache``
(``launch/adapter_cache.py``). Runs on CUDA unless ``--device cpu`` is
given; asking for CUDA without a card raises. The dense (llama2-7b,
gemma3-12b, gemma3-27b, h2o-danube-3-4b, command-r-plus-104b; roberta-
large-lora), hybrid (zamba2-1.2b) and ssm (rwkv6-1.6b, the default)
families serve (``--arch``, reduced unless ``--full-size``). In engine mode
``--telemetry PATH`` writes the run's events (``run_meta``, one
``request`` per request, the final ``metrics`` snapshot) and
``--trace-out`` its Chrome trace (``repro_torch.obs``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.launch.train import _sync, resolve_device
from repro_torch.models import get_model
from repro_torch.obs import make_telemetry
from repro_torch.peft import init_peft


def tokenwise_prefill(cfg, model, base, peft, cache, prompt_tokens, decode=None):
    """Reference prompt ingestion: P ``decode_step`` calls (the cache
    exercised exactly as production decode does). The fallback for caches
    the fused prefill cannot reproduce (quantized, too-short rings) and the
    equivalence oracle in tests. ``decode`` is a ``build_serve_fns`` decode;
    by default the model's own. The cache is written in place."""
    if decode is None:
        decode = build_serve_fns(cfg, model)["decode"]
    for p in range(prompt_tokens.shape[1]):
        logits, cache = decode(base, peft, cache, prompt_tokens[:, p:p + 1], p)
    return logits, cache


def can_fuse_prefill(cfg, model, cache, prompt_len):
    """Whether ``model.prefill`` reproduces the token-by-token decode loop
    for this cache shape (the fused pass must write exactly the rows the
    loop would have)."""
    if model.prefill is None:
        return False
    if not isinstance(cache, dict):
        return False
    if "k" in cache:
        # int8-KV caches: the decode loop attends to QUANTIZED history
        # during ingestion while a fused pass would attend to exact K/V
        if "k_scale" in cache:
            return False
        # a ring cache SHORTER than the prompt makes the decode loop lossy
        # (early keys are overwritten before later prompt tokens attend);
        # fused attention over the full prompt cannot reproduce that unless
        # every layer is sliding-window AND the ring still covers the window
        Sc = cache["k"].shape[2]
        if Sc < prompt_len:
            all_swa = not any(cfg.is_global_layer(i)
                              for i in range(cfg.n_layers))
            if not (all_swa and Sc >= cfg.window):
                return False
        return True
    if "attn_k" in cache:
        # hybrid shared-attention ring: fusible unless the ring is both
        # shorter than the prompt AND narrower than the window
        W = cache["attn_k"].shape[2]
        if W < prompt_len and W < cfg.window:
            return False
        return True
    return True   # stateful families (rwkv): prefill threads exact state


def build_serve_fns(cfg, model):
    """The model's serve entry points bound to ``cfg``, run under
    ``torch.inference_mode()`` (no autograd bookkeeping). Built once and
    reused across requests; there is no tracing to hoist, as the
    reference's jit has. Both write the cache they are given in place."""
    def decode(base, peft, cache, tok, pos):
        with torch.inference_mode():
            return model.decode_step(cfg, base, peft, cache, tok, pos)

    run_prefill = None
    if model.prefill is not None:
        def run_prefill(base, peft, cache, toks):
            with torch.inference_mode():
                return model.prefill(cfg, base, peft, cache, toks)
    return {"decode": decode, "prefill": run_prefill}


def greedy_generate(cfg, base, peft, prompt_tokens, n_steps, cache_len=None,
                    fused_prefill=True, kv_int8=False, fns=None, frames=None):
    """prompt_tokens: (B, P) int tensor on the model's device. Returns
    (B, n_steps) generated ids.

    ``fused_prefill=True`` ingests the prompt with one chunked-attention
    pass (``model.prefill``) instead of P ``decode_step`` calls, where
    ``can_fuse_prefill`` says the two agree. ``fns``: entry points from
    ``build_serve_fns``. Encoder ``frames`` wait for the encoder-decoder
    family."""
    if frames is not None:
        raise NotImplementedError(
            "encoder frames need the encoder-decoder family (a later slice)")
    model = get_model(cfg)
    B, P = prompt_tokens.shape
    if kv_int8 and not model.supports_kv_int8:
        raise ValueError(
            f"family {cfg.family!r} has no int8-KV cache "
            f"(ModelFns.supports_kv_int8 is False)")
    extra = {"kv_int8": kv_int8} if model.supports_kv_int8 else {}
    cache = model.init_cache(cfg, B, cache_len or (P + n_steps),
                             device=prompt_tokens.device, **extra)
    if fns is None:
        fns = build_serve_fns(cfg, model)
    decode = fns["decode"]

    if fused_prefill and can_fuse_prefill(cfg, model, cache, P):
        logits, cache = fns["prefill"](base, peft, cache, prompt_tokens)
    else:
        logits, cache = tokenwise_prefill(cfg, model, base, peft, cache,
                                          prompt_tokens, decode=decode)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for s in range(n_steps):
        out.append(tok)
        logits, cache = decode(base, peft, cache, tok, P + s)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def run_engine(cfg, n_requests, prompt_len, steps, max_batch=4,
               cache_capacity=4, telemetry=None, seed=0, n_adapters=None,
               device="cuda"):
    """Drive the multi-tenant ServingEngine with ``n_requests`` requests
    over ``n_adapters`` synthetic adapters (default one each), request i on
    adapter i % n_adapters. Base weights from a generator seeded with
    ``seed`` on ``device``, prompts from numpy's ``default_rng(seed)``.
    Returns (outputs, engine)."""
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serving import Request, ServingEngine

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    store = SyntheticAdapterStore(cfg, SpryConfig(), seed=seed, device=dev)
    cache = AdapterCache(store, capacity=cache_capacity, telemetry=telemetry)
    engine = ServingEngine(cfg, base, cache, max_batch=max_batch,
                           cache_len=prompt_len + steps, telemetry=telemetry)
    rng = np.random.default_rng(seed)
    n_adapters = n_adapters or max(1, n_requests)
    reqs = [Request(request_id=f"req-{i}", adapter_id=i % n_adapters,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=prompt_len).astype(np.int32),
                    max_new_tokens=steps)
            for i in range(n_requests)]
    outputs = engine.run(reqs)
    return outputs, engine


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--engine", type=int, default=0, metavar="N",
                    help="serve N multi-tenant requests through the "
                         "continuous-batching ServingEngine instead of the "
                         "single-tenant greedy loop")
    ap.add_argument("--cache-capacity", type=int, default=4,
                    help="resident adapter pages in the AdapterCache "
                         "(engine mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--telemetry", default=None,
                    help="JSONL event-log path ('off' disables)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON (Perfetto-loadable) "
                         "of the run's spans to this path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduce_config(cfg)
    model = get_model(cfg)

    if args.engine:
        tel = make_telemetry(
            jsonl=(None if args.telemetry in (None, "off", "none", "")
                   else args.telemetry),
            run_id=f"serve-{args.arch}", workload="serve")
        if tel.enabled:
            tel.event("run_meta", workload="serve", arch=args.arch,
                      n_requests=args.engine, prompt_len=args.prompt_len,
                      steps=args.steps, max_batch=args.batch,
                      cache_capacity=args.cache_capacity)
        outputs, engine = run_engine(
            cfg, args.engine, args.prompt_len, args.steps,
            max_batch=args.batch, cache_capacity=args.cache_capacity,
            telemetry=tel, device=dev)
        print(f"[serve] engine: {len(outputs)} requests drained in "
              f"{engine.steps} decode steps; adapter cache {engine.adapters.stats()}")
        if tel.enabled:
            if args.trace_out:
                tel.export_chrome_trace(args.trace_out)
            tel.close()
            print(f"[telemetry] events -> {args.telemetry}"
                  + (f"  trace -> {args.trace_out}" if args.trace_out
                     else ""))
        return

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    base = model.init_base(cfg, gen)
    peft = init_peft(cfg, gen, SpryConfig())
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    total = args.prompt_len + args.steps

    # warm up prefill and decode at the serving shapes outside the timed
    # region (first calls pay allocator and library set-up)
    fns = build_serve_fns(cfg, model)
    greedy_generate(cfg, base, peft, prompt, 1, cache_len=total, fns=fns)
    _sync(dev)

    t0 = time.perf_counter()
    ids = greedy_generate(cfg, base, peft, prompt, args.steps, cache_len=total,
                          fns=fns)
    _sync(dev)
    e2e = time.perf_counter() - t0

    # steady-state decode throughput, separated from end-to-end latency
    # (which includes prompt ingestion)
    cache = model.init_cache(cfg, args.batch, total, device=dev)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    logits, cache = fns["decode"](base, peft, cache, tok, 0)
    _sync(dev)
    t0 = time.perf_counter()
    for s in range(args.steps):
        logits, cache = fns["decode"](base, peft, cache, tok, 1 + s)
    _sync(dev)
    decode_tps = args.batch * args.steps / (time.perf_counter() - t0)

    print(f"[serve] {args.arch}: generated {tuple(ids.shape)} in {e2e:.2f}s "
          f"end-to-end ({args.batch * args.steps / e2e:.1f} tok/s incl. "
          f"prefill); steady-state decode {decode_tps:.1f} tok/s; "
          f"sample row: {ids[0, :16].cpu().numpy()}")


if __name__ == "__main__":
    main()
