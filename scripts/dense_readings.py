#!/usr/bin/env python3
"""Diagnostic: the readings that phase 9's limits in chip_smoke.py rest on.

    python3 scripts/dense_readings.py long [--layers 48] [--seeds 0 1 2] [--ablate]
    python3 scripts/dense_readings.py serve [--seeds 0 1 2] [--archs ...]

``long`` runs ``chip_smoke.long_estimate_readings`` (gemma3-12b at full
width, B=1, S=2048, K=4) at each depth and seed and prints one JSON line
each: the drift of each bf16 route from the fp32 estimate (loss relative,
jvps of the largest |jvp|) and the kernels against the plain versions.
``--ablate`` adds three routes that swap one kernel for its plain version
(the attention primal, the attention tangents, the LoRA tangents), which
says whose roundings a drift comes from, and a fourth whose attention
primal is the plain one in the kernel's roundings (``primal_fp32_scores``).
``serve`` runs
``chip_smoke.dense_serve`` for each dense arch and seed (weights, adapters
and prompts from the seed): the kernel and plain-version engines' first
decode steps against B=1 greedy, and the fp32 witness, printed as phase 9
prints them; a reading past its limit is printed as such, not raised.

It checks nothing and is no part of the port. Needs one CUDA card with room
for gemma3-12b's weights in fp32 (~47 GB); prints the card's name and power
limit first.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def primal_fp32_scores(q, k, v, window=None):
    """The plain attention primal in the tensor-core kernel's roundings:
    scores and softmax in fp32 (the plain version rounds the scores to q's
    dtype), p rounded to q's dtype before P V, fp32 sums, one rounding of
    the output. Operands as ``ops.swa_attention_ref``."""
    import math

    import torch
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qg = q.float().reshape(B, KV, H // KV, S, hd)
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(torch.where(keep, scores, torch.full_like(scores, -1e30)), dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(q.dtype).float(), v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def long_readings(cs, smi, layers, seeds, ablate):
    variants = {"kernels": (), "plain": tuple(cs.PLAIN_DISPATCH)}
    if ablate:
        variants.update(plain_swa=("swa_attention",),
                        plain_swa_mt=("swa_attention_mt_tangents",),
                        plain_lora_mt=("lora_dual_mt_tangents",),
                        fp32_scores_swa={"swa_attention": primal_fp32_scores})
    for n in layers:
        for seed in seeds:
            cfg, _, _, r = cs.long_estimate_readings(n or None, seed, variants)
            kern, plain = r["kernels"], r["plain"]
            print(json.dumps({
                "n_layers": cfg.n_layers, "seed": seed,
                "vs_fp32": {v: r[v]["vs_fp32"] for v in variants},
                "kernels_vs_plain": {
                    "loss": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
                    "jvps": cs.rel_max(kern["jvps"], plain["jvps"])},
                "jvps_fp32": r["fp32"]["jvps"].tolist(),
                "s": {v: r[v]["s"] for v in variants}, "card": smi}), flush=True)


def serve_readings(cs, smi, archs, seeds):
    from repro_torch.kernels import launch_counts, launch_paths
    totals = dict.fromkeys(launch_counts(), 0)
    paths = {k: dict.fromkeys(by, 0) for k, by in launch_paths().items()}
    for arch in archs:
        for seed in seeds:
            with cs.dense_depth(arch) as cfg:
                try:
                    cs.dense_serve(arch, cfg, totals, paths, smi, seed=seed)
                except AssertionError as e:
                    print(f"[readings] {arch} seed {seed} past a limit: {e}", flush=True)
            cs._free()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    lo = sub.add_parser("long")
    lo.add_argument("--layers", type=int, nargs="+", default=[48])
    lo.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    lo.add_argument("--ablate", action="store_true")
    se = sub.add_parser("serve")
    se.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    se.add_argument("--archs", nargs="+", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("dense_readings: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs = _chip_smoke()
    if args.what == "long":
        long_readings(cs, smi, args.layers, args.seeds, args.ablate)
    else:
        serve_readings(cs, smi, args.archs or cs.DENSE_ARCHS, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
