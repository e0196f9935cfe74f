"""The analysis lint CLI: the rules over what the port's entry points run.
Stands for ``repro/analysis/lint.py``.

    PYTHONPATH=src python -m repro_torch.analysis.lint [--strict] [--quick] \
        [--families dense,ssm] [--tasks lm,cls] [--k 4] [--device cpu] \
        [--json PATH]

Runs every registered entry point (``analysis.entrypoints``) under the
kernel-call recorder and checks the six rule classes (``analysis.rules``).
On the card (``--device cuda``, the default) the entry points and one call
of each kernel at the main path's shapes launch the kernels,
``torch.profiler`` records each launch's block and shared memory, and the
shared-memory table covers every instantiation of the seven built
libraries (``analysis.smem``); on the CPU the plain versions run at the same
boundary and there is no table. Exit code: 0 when clean, 1 on any error
finding; ``--strict`` also fails on warnings. JSON is written only to
``--json``'s path.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Tuple

from repro_torch.analysis import entrypoints as eps
from repro_torch.analysis import rules as R
from repro_torch.analysis import smem
from repro_torch.analysis.report import render, summarize, to_doc, write_analysis
from repro_torch.kernels.calls import record_calls


def check_traces(traces) -> List[R.Finding]:
    """The rules each trace kind answers to."""
    findings: List[R.Finding] = []
    for t in traces:
        if t.kind == "fused_loss":
            findings += R.check_tangent_stack(t.name, t.calls, t.K, t.y_shape,
                                              family=t.site_family)
            findings += R.check_dtype_policy(t.name, t.calls)
        elif t.kind == "standard_loss":
            findings += R.record_expected_stack(t.name, t.calls, t.K, t.y_shape,
                                                family=t.site_family)
            findings += R.check_dtype_policy(t.name, t.calls)
        elif t.kind == "grad_guard":
            findings += R.check_transpose_reachability(t.name, t.calls, t.meta.get("error"))
        elif t.kind == "lowered":
            findings += R.check_donation(t.name, t.meta["before"], t.meta["after"])
        elif t.kind == "telemetry_pair":
            findings += R.check_telemetry_neutrality(
                t.name, t.meta["calls_off"], t.meta["calls_on"], t.meta["outputs_equal"])
    return findings


def _profiled(fn) -> str:
    """Run ``fn`` under ``torch.profiler`` on the card; the path of its
    Chrome trace (a temporary file the caller removes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def run(families=None, tasks=eps.TASKS, quick=False, K=4,
        device="cuda") -> Tuple[List[R.Finding], list, list]:
    """Run and check everything; returns (findings, smem rows, entry-point
    names). On the card the kernels at the main path's shapes
    (``entrypoints.main_path_calls``: once to warm up, then under the
    recorder) and the sweep each run in a ``torch.profiler`` session of
    their own, every recorded main-path call must show in its trace, and
    the table joins each instantiation's launches in. Run it in a process
    of its own: a trace taken after an earlier profiler session in the
    same process can miss its first launches."""
    def sweep():
        return eps.sweep(families=families, tasks=tasks, quick=quick, K=K, device=device)

    findings: List[R.Finding] = []
    if device != "cuda":
        traces, launch_traces = sweep(), []
    else:
        from repro_torch.kernels import build
        build.build()
        # one profiler session each, the main path's first: the sweep makes
        # thousands of launches, and the main path's must reach the table
        # whatever the profiler keeps of those
        eps.main_path_calls()
        with record_calls() as rec:
            launch_traces = [_profiled(eps.main_path_calls)]
        findings += R.check_smem_traced("main_path", rec,
                                        smem.launches_from_trace(launch_traces[0]))
        box = {}
        launch_traces.append(_profiled(lambda: box.update(traces=sweep())))
        traces = box["traces"]
    findings += check_traces(traces)
    findings += R.check_csrc_accumulators()
    findings += R.check_wire_dtypes()
    rows = []
    if launch_traces:
        try:
            rows = smem.card_table(launch_traces)
        finally:
            for path in launch_traces:
                os.remove(path)
        findings += R.check_smem_rows("kernels.instantiations", rows)
        findings += R.check_smem_coverage("kernels.instantiations", rows, smem.ALL_ROWS)
    else:
        findings.append(R.Finding(
            "smem-budget", "info", "kernels.instantiations", device,
            "no built library on this device: the shared-memory table is read on the "
            "card (--device cuda)", {}))
    return findings, rows, [t.name for t in traces]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="memory and AD-safety invariants over what the entry points run")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too, not just errors")
    ap.add_argument("--quick", action="store_true", help="dense+ssm only")
    ap.add_argument("--families", default=None,
                    help=f"comma-separated families (default: all of {', '.join(eps.ARCHS)})")
    ap.add_argument("--tasks", default=",".join(eps.TASKS))
    ap.add_argument("--k", type=int, default=4,
                    help="K perturbations for the estimator runs")
    ap.add_argument("--device", default="cuda",
                    help="where the entry points run (cuda: the kernels; cpu: their "
                         "plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings and the table here")
    args = ap.parse_args(argv)

    families = (tuple(f for f in args.families.split(",") if f)
                if args.families else None)
    tasks = tuple(t for t in args.tasks.split(",") if t)
    findings, rows, names = run(families=families, tasks=tasks, quick=args.quick,
                                K=args.k, device=args.device)
    print(render(findings, rows, names))
    if args.json:
        write_analysis(args.json, to_doc(findings, rows, names, args.device, smem.BUDGET))
        print(f"\nwrote {args.json}")
    s = summarize(findings)
    failed = s["errors"] > 0 or (args.strict and s["warnings"] > 0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
