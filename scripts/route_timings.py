#!/usr/bin/env python3
"""Diagnostic: the off-main-path kernel routes timed in two checkouts on one
card, to compare a change to a kernel's launch bounds or plan with its
parent.

    python3 scripts/route_timings.py --parent DIR
    python3 scripts/route_timings.py --one DIR        # one checkout's times

``DIR`` is a checkout of the parent commit (``git archive``); the change
is the checkout this script sits in. Parent, change, change and parent
each run ``--one`` on their checkout in a process of its own, which
builds the checkout's libraries into its own ``build/kernels`` and
prints one JSON line a case: the median ms of a call over three
CUDA-graph windows (``chip_smoke.time_ms``) and the route it took. The
cases are the routes no full-width main path takes:

- rows 8 and 9 on the recurrent route (``rec``): wkv6 tangents and
  contraction at B=1, S=1024, H=4, hd=64, T in {1, 8, 64};
- row 12 on ``rec``: the mamba2 contraction at zamba2's widths, B=1,
  S=1024, H=64, hd=N=64, T in {1, 8, 64};
- rows 1 and 5 on ``simt``: the LoRA tangents and contraction in fp32 at
  roberta-large's widths (M=256, K=N=1024, rank 1, T=8) and in bf16 off the
  8-element alignment (N=1020, rank 2), with and without an input tangent;
- row 2 at hd 96 (bf16; no config has that width): B=8, H=16, S=32 and
  B=1, H=16, S=2048.

The summary gives each case's readings in run order and the change's mean
over the parent's. It checks nothing and is no part of the port. Needs one
CUDA card; prints the card's name and power limit first.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs):
    """(name, kernel counter, route, call) of each case; inputs from seed 0."""
    import torch
    from repro_torch.kernels.lora_dual import ops as lo
    from repro_torch.kernels.mamba2_scan import ops as mo
    from repro_torch.kernels.swa_attention import ops as so
    from repro_torch.kernels.wkv6_scan import ops as wo
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    out = []
    for T in (1, 8, 64):
        prim, tang, uds, gy = cs.wkv6_inputs(1, 1024, 4, 64, T, False, gen)
        shape = f"B=1 S=1024 H=4 hd=64 T={T}"
        out.append((f"row 8 wkv6_scan_mt {shape}", wo.launches_by_path["wkv6_scan_mt"], "rec",
                    lambda p=prim, t=tang: wo.wkv6_scan_mt_tangents(*p, *t)))
        out.append((f"row 9 wkv6_scan_mt_jvps {shape}",
                    wo.launches_by_path["wkv6_scan_mt_jvps"], "rec",
                    lambda p=prim, t=tang, g=gy: wo.wkv6_scan_mt_jvps(*p, *t, g)))
    for T in (1, 8, 64):
        prim, tang, gy = cs.mamba2_inputs(1, 1024, 64, 64, 64, T, gen)
        out.append((f"row 12 mamba2_scan_mt_jvps B=1 S=1024 H=64 hd=N=64 T={T}",
                    mo.launches_by_path["mamba2_scan_mt_jvps"], "rec",
                    lambda p=prim, t=tang, g=gy: mo.mamba2_scan_mt_jvps(*p, *t, g)))
    for dtype, M, K, N, r in ((torch.float32, 256, 1024, 1024, 1),
                              (torch.bfloat16, 64, 1024, 1020, 2)):
        T = 8
        x, w = rn(M, K).to(dtype), (rn(K, N) / K ** 0.5).to(dtype)
        a, ad = rn(K, r) / K ** 0.5, rn(T, K, r) / K ** 0.5
        b, bd = rn(r, N), rn(T, r, N)
        gy = rn(M, N).to(dtype)
        for xd in (rn(T, M, K).to(dtype), None):
            shape = (f"M={M} K={K} N={N} r={r} T={T} xd={xd is not None} "
                     f"{str(dtype).replace('torch.', '')}")
            out.append((f"row 1 lora_dual_mt {shape}", lo.launches_by_path["lora_dual_mt"],
                        "simt", lambda x=x, xd=xd, w=w, a=a, ad=ad, b=b, bd=bd:
                        lo.lora_dual_mt_tangents(x, xd, w, a, ad, b, bd, 1.0)))
            out.append((f"row 5 lora_dual_mt_jvps {shape}",
                        lo.launches_by_path["lora_dual_mt_jvps"], "simt",
                        lambda x=x, xd=xd, w=w, a=a, ad=ad, b=b, bd=bd, gy=gy:
                        lo.lora_dual_mt_jvps(x, w, a, ad, b, bd, gy, 1.0, xdots=xd)))
    for B, H, S in ((8, 16, 32), (1, 16, 2048)):
        q, k, v = (rn(B, H, S, 96).bfloat16() for _ in range(3))
        out.append((f"row 2 swa_attention B={B} H={H} S={S} hd=96 bf16",
                    so.launches_by_path["swa_attention"], "tc",
                    lambda q=q, k=k, v=v: so.swa_attention(q, k, v)))
    return out


def one(root):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    from repro_torch.kernels import build
    assert os.path.realpath(build.CSRC).startswith(os.path.realpath(root))
    build.build(["lora_dual", "swa_attention", "wkv6_scan", "mamba2_scan"])
    for name, counter, route, call in cases(cs):
        cs.took_path(name, counter, route, call)
        print(json.dumps({"root": root, "case": name, "route": route,
                          "ms": cs.time_ms(call)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--one", help="time one checkout's kernels (a child process)")
    args = ap.parse_args(argv)
    if args.one:
        return one(os.path.abspath(args.one))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    roots = {"p": os.path.abspath(args.parent), "c": ROOT}
    got = {}
    for i, which in enumerate("pccp"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               roots[which]], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            rec = json.loads(line)
            print(json.dumps(dict(rec, run=i, which=which)), flush=True)
            got.setdefault(rec["case"], {"p": [], "c": []})[which].append(rec["ms"])
    for case, by in got.items():
        print(json.dumps({"case": case, "parent_ms": by["p"], "change_ms": by["c"],
                          "change_over_parent": statistics.mean(by["c"])
                          / statistics.mean(by["p"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
