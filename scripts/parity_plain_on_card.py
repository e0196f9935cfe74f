#!/usr/bin/env python3
"""Diagnostic: how much of the card-vs-CPU round difference the kernels make.

    python3 scripts/parity_plain_on_card.py

Runs ``chip_smoke.parity_round`` on reduced zamba2 with ``n_layers=3,
hybrid_attn_every=2`` (final site mamba2), standard route, twice on the
card: once through the kernels, once with the dispatch layer's kernel entry
points replaced by their plain versions. Prints the card's name and power
limit and both rounds' readings against the CPU round as JSON. It checks
nothing and is no part of the port: the port itself never swaps a kernel
for its plain version on a CUDA tensor. Needs one CUDA card.
"""
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
    plain = {"mamba2_scan": lambda *a: mo.mamba2_scan_ref(*a)[0],
             "mamba2_scan_mt_tangents": lambda *a: mo.mamba2_scan_mt_ref(*a)[1],
             "mamba2_scan_mt_jvps": mo.mamba2_scan_mt_jvps_ref,
             "swa_attention": so.swa_attention_ref,
             "swa_attention_mt_tangents": so.swa_attention_mt_tangents_ref,
             "swa_attention_mt_jvps": so.swa_attention_mt_jvps_ref,
             "lora_dual_mt_tangents": lo.lora_dual_mt_tangents_ref,
             "lora_dual_mt_jvps": lo.lora_dual_mt_jvps_ref}
    saved = {k: getattr(dispatch, k) for k in plain}
    for k, fn in plain.items():
        setattr(dispatch, k, fn)
    return saved


def main():
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
    cfg = {"n_layers": 3, "hybrid_attn_every": 2}
    out = {"kernels": cs.parity_round(False, "zamba2-1.2b", **cfg)}
    saved = _plain_dispatch()
    try:
        out["plain_versions"] = cs.parity_round(False, "zamba2-1.2b", **cfg)
    finally:
        for k, fn in saved.items():
            setattr(dispatch, k, fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
