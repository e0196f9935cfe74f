#!/usr/bin/env python3
"""Diagnostic: how much of the card-vs-CPU round difference the kernels make.

    python3 scripts/parity_plain_on_card.py [--arch zamba2-1.2b|rwkv6-1.6b|...]

Runs ``chip_smoke.parity_round`` on one reduced config (default: zamba2
with ``n_layers=3, hybrid_attn_every=2``, final site mamba2; rwkv6-1.6b's
final site is wkv6), on the standard and on the fused-contraction route,
three times on the card each: once through the kernels, once with the
dispatch layer's kernel entry points replaced by their plain versions, and
once through the kernels but with the mamba2 primal computed exactly (the
plain recurrence in fp64, rounded once to fp32). Prints the card's name and
power limit, each round's readings against the CPU round, and the kernel
round against the plain-version round on the card (jvps and new PEFT,
largest relative error), one JSON line a route. The exact primal shows what
the CPU reference's own rounding of the mamba2 state, at every token, does
to the readings: a primal that does not repeat it reads further from the
CPU round however exact it is. It checks
nothing and is no part of the port: the port itself never swaps a kernel
for its plain version on a CUDA tensor. Needs one CUDA card.
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


def _plain_dispatch():
    """Replaces the dispatch layer's kernel entry points by their plain
    versions; returns the originals to restore."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.lora_dual import ops as lo
    from repro_torch.kernels.mamba2_scan import ops as mo
    from repro_torch.kernels.swa_attention import ops as so
    from repro_torch.kernels.wkv6_scan import ops as wo
    plain = {"mamba2_scan": lambda *a: mo.mamba2_scan_ref(*a)[0],
             "mamba2_scan_mt_tangents": lambda *a: mo.mamba2_scan_mt_ref(*a)[1],
             "mamba2_scan_mt_jvps": mo.mamba2_scan_mt_jvps_ref,
             "swa_attention": so.swa_attention_ref,
             "swa_attention_mt_tangents": so.swa_attention_mt_tangents_ref,
             "swa_attention_mt_jvps": so.swa_attention_mt_jvps_ref,
             "lora_dual_mt_tangents": lo.lora_dual_mt_tangents_ref,
             "lora_dual_mt_jvps": lo.lora_dual_mt_jvps_ref,
             "wkv6_scan": lambda *a: wo.wkv6_scan_ref(*a)[0],
             "wkv6_scan_mt_tangents": lambda *a: wo.wkv6_scan_mt_ref(*a)[1],
             "wkv6_scan_mt_jvps": wo.wkv6_scan_mt_jvps_ref}
    saved = {k: getattr(dispatch, k) for k in plain}
    for k, fn in plain.items():
        setattr(dispatch, k, fn)
    return saved


def _exact_mamba2_primal():
    """Replaces the dispatch layer's mamba2 primal, on CUDA tensors, by the
    plain recurrence in fp64 rounded once to fp32; returns the original."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.mamba2_scan import ops as mo
    real = dispatch.mamba2_scan

    def exact(xdt, bm, cm, dec):
        if xdt.device.type != "cuda":
            return real(xdt, bm, cm, dec)
        return mo.mamba2_scan_ref(xdt.double(), bm.double(), cm.double(),
                                  dec.double())[0].float()
    dispatch.mamba2_scan = exact
    return real


def main(argv=None):
    ap = argparse.ArgumentParser(description="card-vs-CPU round, kernels and "
                                             "plain versions on the card")
    ap.add_argument("--arch", default="zamba2-1.2b")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("parity_plain_on_card: needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import build, dispatch
    build.build()
    cs = _chip_smoke()
    cfg = ({"n_layers": 3, "hybrid_attn_every": 2} if args.arch == "zamba2-1.2b"
           else {})
    for fused in (False, True):
        kern, plain = {}, {}
        out = {"arch": args.arch, "overrides": cfg,
               "route": "fused" if fused else "standard",
               "kernels": cs.parity_round(fused, args.arch, kern, **cfg)}
        saved = _plain_dispatch()
        try:
            out["plain_versions"] = cs.parity_round(fused, args.arch, plain, **cfg)
        finally:
            for k, fn in saved.items():
                setattr(dispatch, k, fn)
        real = _exact_mamba2_primal()
        try:
            out["exact_mamba2_primal"] = cs.parity_round(fused, args.arch, **cfg)
        finally:
            dispatch.mamba2_scan = real
        out["kernels_vs_plain_on_card"] = {
            "jvps_rel_err": float((kern["jvps"] - plain["jvps"]).abs().max()
                                  / plain["jvps"].abs().max()),
            "peft_rel_err": max(float((a - b).abs().max()
                                      / b.abs().max().clamp(min=1e-30))
                                for a, b in zip(kern["peft"], plain["peft"]))}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
