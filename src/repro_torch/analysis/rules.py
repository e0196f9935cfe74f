"""The rule classes: declared invariants checked against what the port's
entry points actually ran. Stands for ``repro/analysis/rules.py``: the same
``RULES`` order (``smem-budget`` in ``vmem-budget``'s place), ``Finding``,
severities and ``DONATION_WAIVERS`` names.

``tangent-materialization``  on the fused route the site makes exactly one
    ``*_mt_jvps`` contraction call, and no call at the site writes a tensor
    of at least K x |y| elements; the standard route records its
    ``*_mt`` tangent stack as ``info`` (the rule's teeth).
``smem-budget``  every compiled kernel instantiation fits the H100's
    shared-memory, register, local-memory and stack budget
    (``analysis.smem``; a spill ``smem.SPILL_WAIVERS`` records is info).
``transpose-reachability``  ``torch.autograd.grad`` of a loss outside
    ``forward_ad_region()`` records no kernel call: the kernels have no
    reverse rule.
``donation``  a buffer carried across a call is written in place: the
    decode step and prefill keep every cache tensor's storage, a round step
    returns the frozen base without copying it. Intentional copies are
    waived by name, which downgrades the finding to ``info``.
``dtype-policy``  every recorded contraction output and partial is fp32
    (fp64 partials pass), no tensor-core instruction in ``csrc`` accumulates
    in half precision, and the wire-dtype table carries the widths its names
    declare (``fl/runtime/messages.py``).
``telemetry-neutrality``  an engine round and the serving steps with
    telemetry on and off record the same kernel-call sequence and give
    bitwise-equal outputs.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import kernel_calls as kc
from repro_torch.analysis.smem import BUDGET

RULES = (
    "tangent-materialization",
    "smem-budget",
    "transpose-reachability",
    "donation",
    "dtype-policy",
    "telemetry-neutrality",
)

# intentional non-donation, by entry-point name (the reference's names). A
# waiver downgrades the finding to severity "info" with the recorded reason
# instead of silencing it.
DONATION_WAIVERS = {
    "engine.round_step": (
        "FederationEngine.run_round borrows the caller's state; callers "
        "(reference comparisons, benches) legitimately reuse it after the "
        "round"),
    "engine.clients": (
        "wire-sim phase 1: the same state is re-read by engine.aggregate "
        "in the same round"),
    "engine.aggregate": (
        "public wire-sim API borrows caller state (see engine.round_step)"),
    "serve.tokenwise_default_decode": (
        "tokenwise_prefill's fallback decode is intentionally non-donating "
        "so callers keep using the cache they passed in"),
}


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str           # "error" | "warning" | "info"
    entrypoint: str
    where: str
    message: str
    data: Dict = dataclasses.field(default_factory=dict)

    def __str__(self):
        return (f"[{self.severity:7s}] {self.rule} @ {self.entrypoint}: "
                f"{self.message} ({self.where})")


def _site_name(call) -> str:
    return f"{call.name} ({call.route})"


# ---------------------------------------------------------------------------
# rule 1: tangent-materialization
# ---------------------------------------------------------------------------

def check_tangent_stack(entrypoint: str, records: Sequence, K: int, y_shape,
                        family: Optional[str] = None) -> List[Finding]:
    """A fused-route estimate must reach the SITE through exactly one
    ``*_mt_jvps`` call, whose outputs (the jvps and its per-block partials)
    stay below a (K,)+y_shape tangent stack. Upstream layers legitimately
    write their per-layer tangents, so only the epilogue calls are
    checked."""
    out = []
    stack = kc.tangent_stack_size(K, y_shape)
    site_calls = kc.calls(records, family)
    jvps = [c for c in site_calls if kc.is_contraction(c)]
    if len(jvps) != 1:
        out.append(Finding(
            "tangent-materialization", "error", entrypoint, family or "<site>",
            f"expected exactly ONE *_mt_jvps contraction epilogue at the "
            f"site, found {len(jvps)}",
            {"n_epilogues": len(jvps), "n_site_calls": len(site_calls)}))
    for call in jvps:
        for spec, n in zip(call.outputs, call.numel("outputs")):
            if n >= stack:
                out.append(Finding(
                    "tangent-materialization", "error", entrypoint, _site_name(call),
                    f"site kernel writes a tangent-stack-sized tensor {spec[0]} "
                    f"(>= K x y = {stack} elems)",
                    {"K": K, "y_shape": list(map(int, y_shape)),
                     "out_shape": list(spec[0])}))
    return out


def record_expected_stack(entrypoint: str, records: Sequence, K: int, y_shape,
                          family: Optional[str] = None) -> List[Finding]:
    """The standard route SHOULD write the site's tangent stack: recorded
    as info, so the no-stack rule is shown not to be vacuous on every lint
    run (its teeth)."""
    hits = kc.tangent_stack_outputs(records, K, y_shape, family=family)
    if hits:
        return [Finding(
            "tangent-materialization", "info", entrypoint, _site_name(hits[0][0]),
            f"standard route materializes the (K={K},)+y tangent stack as "
            f"expected: the rule has teeth", {"n_stack_outputs": len(hits)})]
    return [Finding(
        "tangent-materialization", "warning", entrypoint, family or "<site>",
        "standard route did NOT materialize a tangent stack: the fused "
        "no-stack check may be vacuous for this entry point", {})]


# ---------------------------------------------------------------------------
# rule 2: smem-budget
# ---------------------------------------------------------------------------

def check_smem_rows(entrypoint: str, rows: List[Dict]) -> List[Finding]:
    """An error for each instantiation over the H100 budget, and an info
    for each waived spill (``smem.SPILL_WAIVERS``)."""
    def data(row):
        return {k: row[k] for k in ("library", "reg", "stack", "local", "static_smem",
                                    "dynamic_smem", "threads")}
    out = [Finding("smem-budget", "error", entrypoint, row["kernel"],
                   "; ".join(row["over"]) + f" (budget {BUDGET})", data(row))
           for row in rows if not row["ok"]]
    out += [Finding("smem-budget", "info", entrypoint, row["kernel"],
                    f"spill waived ({row['stack']}-byte stack, {row['local']} bytes "
                    f"local): {row['waiver']}", data(row))
            for row in rows if row["waiver"] and (row["stack"] or row["local"])]
    return out


def check_smem_coverage(entrypoint: str, rows: List[Dict],
                        want_rows: Sequence[int]) -> List[Finding]:
    """Every kernel-table row is served by at least one instantiation, and
    each row has one that a traced call launched (its threads and dynamic
    shared memory measured)."""
    out = []
    served = {r for row in rows for r in row["rows"]}
    launched = {r for row in rows if row["launched"] for r in row["rows"]}
    for r in want_rows:
        if r not in served:
            out.append(Finding("smem-budget", "error", entrypoint, f"row {r}",
                               "no compiled instantiation serves this row", {}))
        elif r not in launched:
            out.append(Finding("smem-budget", "error", entrypoint, f"row {r}",
                               "no instantiation of this row was launched, so its "
                               "threads and dynamic shared memory are unmeasured", {}))
    return out


def check_smem_traced(entrypoint: str, records: Sequence,
                      launched: Dict[str, Dict]) -> List[Finding]:
    """Every recorded kernel call of a profiled run (``records``) shows in
    its trace (``launched``, ``smem.launches_from_trace``): a call the
    profiler missed left its block and dynamic shared memory unread."""
    from repro_torch.analysis.smem import untraced_calls
    return [Finding("smem-budget", "error", entrypoint, f"row {row}",
                    f"{n} kernel call(s) of this row ran but the profiler trace "
                    f"holds {seen} launch(es) of its kernels: their threads and "
                    f"dynamic shared memory are unmeasured",
                    {"calls": n, "traced": seen})
            for row, (n, seen) in untraced_calls(records, launched).items()]


# ---------------------------------------------------------------------------
# rule 3: transpose-reachability
# ---------------------------------------------------------------------------

def check_transpose_reachability(entrypoint: str, records: Sequence,
                                 error: Optional[str] = None) -> List[Finding]:
    """``records``: the calls made by a loss and its ``torch.autograd.grad``
    OUTSIDE ``forward_ad_region()``; any kernel call there is an error, and
    so is ``error``, the exception the reverse pass raised (a kernel's
    Function has no backward)."""
    out = [Finding(
        "transpose-reachability", "error", entrypoint, _site_name(c),
        "kernel entry point reached under reverse mode outside "
        "dispatch.forward_ad_region(): the kernels have no reverse rule",
        {"kernel": c.name, "forward_ad": c.forward_ad})
        for c in records]
    if error:
        out.append(Finding("transpose-reachability", "error", entrypoint, "<grad>",
                           f"reverse mode failed: {error}", {}))
    return out


# ---------------------------------------------------------------------------
# rule 4: donation (written in place)
# ---------------------------------------------------------------------------

def storage_map(tree, prefix="") -> Dict[str, tuple]:
    """{path: (data_ptr, bytes, shape, dtype)} of a nested dict / tuple of
    tensors, taken before and after a call."""
    import torch
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(storage_map(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            out.update(storage_map(t, f"{prefix}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[prefix or "/"] = (tree.data_ptr(), tree.numel() * tree.element_size(),
                              tuple(tree.shape), str(tree.dtype))
    return out


def check_donation(entrypoint: str, before: Dict[str, tuple],
                   after: Dict[str, tuple]) -> List[Finding]:
    """Each carried tensor (a path in both maps with the same shape and
    dtype) must come back in the same storage: written in place, not
    copied. A waiver for ``entrypoint`` downgrades the finding to info."""
    out = []
    waived = DONATION_WAIVERS.get(entrypoint)
    for path, (ptr, nbytes, shape, dtype) in sorted(before.items()):
        got = after.get(path)
        if got is None or got[2:] != (shape, dtype) or got[0] == ptr:
            continue
        out.append(Finding(
            "donation", "info" if waived else "error", entrypoint, path,
            (f"donation waived: {waived}" if waived else
             f"carried buffer ({nbytes / (1 << 20):.1f} MiB, shape {shape}) comes "
             f"back in new storage: write it in place"),
            {"bytes": nbytes, "shape": list(shape), "dtype": dtype,
             "waived": bool(waived)}))
    kept = [p for p, (ptr, *_) in before.items() if after.get(p, (None,))[0] == ptr]
    if not out and kept:
        out.append(Finding("donation", "info", entrypoint, "<carried>",
                           f"{len(kept)} carried buffers come back in their storage",
                           {"kept": len(kept)}))
    return out


# ---------------------------------------------------------------------------
# rule 5: dtype-policy
# ---------------------------------------------------------------------------

_WIDE = ("float32", "float64")


def check_dtype_policy(entrypoint: str, records: Sequence) -> List[Finding]:
    """Every recorded contraction epilogue's outputs (the jvps and the
    per-block partials it accumulates) are fp32 or fp64."""
    out = []
    for c in records:
        if not kc.is_contraction(c):
            continue
        for spec in c.outputs:
            if spec is not None and spec[1] not in _WIDE:
                out.append(Finding(
                    "dtype-policy", "error", entrypoint, _site_name(c),
                    f"contraction output accumulates in {spec[1]}, policy "
                    f"requires float32 (or float64)",
                    {"shape": list(spec[0]), "dtype": spec[1]}))
    return out


# the PTX and C++ spellings of a tensor-core product; the D (accumulator)
# type follows the shape in ``mma`` and ``wgmma``
_MMA = re.compile(r"\b(?:wgmma\.mma_async|mma)\.sync\.aligned\.(m\d+n\d+k\d+)"
                  r"(?:\.row\.col)?\.(\w+)|\bwgmma\.mma_async\.\w+\.aligned\."
                  r"(m\d+n\d+k\d+)\.(\w+)")
_WMMA_ACC = re.compile(r"fragment<\s*(?:nvcuda::)?wmma::accumulator[^>]*\b(half|__half|"
                       r"__nv_bfloat16)\s*>")
_HALF = ("f16", "bf16", "f16x2")


def check_csrc_accumulators(entrypoint: str = "csrc",
                            csrc: Optional[Path] = None) -> List[Finding]:
    """Scan the CUDA sources for a tensor-core product whose accumulator
    is half precision (``mma.sync`` / ``wgmma`` with an f16 or bf16 D
    type, a ``wmma`` accumulator fragment of half)."""
    from repro_torch.kernels import build
    csrc = Path(csrc) if csrc is not None else build.CSRC
    out, seen = [], 0
    for path in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            for m in _MMA.finditer(line):
                seen += 1
                dtype = m.group(2) or m.group(4)
                if dtype in _HALF:
                    out.append(Finding(
                        "dtype-policy", "error", entrypoint, f"{path.name}:{i}",
                        f"tensor-core product accumulates in {dtype}", {"line": line.strip()}))
            m = _WMMA_ACC.search(line)
            if m:
                seen += 1
                out.append(Finding("dtype-policy", "error", entrypoint, f"{path.name}:{i}",
                                   f"wmma accumulator fragment of {m.group(1)}",
                                   {"line": line.strip()}))
    if not seen:
        out.append(Finding("dtype-policy", "warning", entrypoint, str(csrc),
                           "no tensor-core product found in the sources: the "
                           "accumulator scan may be vacuous", {}))
    return out


def check_wire_dtypes(entrypoint: str = "wire.messages") -> List[Finding]:
    """The wire-payload dtype table carries the widths its names declare
    (fp32 = 4 bytes, fp16 / bf16 = 2) and round-trips through
    ``wire_dtype``."""
    from repro_torch.fl.runtime import messages
    declared = {"fp32": 4, "fp16": 2, "bf16": 2}
    out = []
    for name, width in declared.items():
        if name not in messages.WIRE_DTYPES:
            out.append(Finding("dtype-policy", "error", entrypoint, f"WIRE_DTYPES[{name}]",
                               f"wire dtype {name!r} missing from WIRE_DTYPES", {}))
            continue
        dt = np.dtype(messages.WIRE_DTYPES[name])
        if dt.itemsize != width:
            out.append(Finding(
                "dtype-policy", "error", entrypoint, f"WIRE_DTYPES[{name}]",
                f"wire dtype {name!r} is {dt} ({dt.itemsize}B), declared width is "
                f"{width}B", {"dtype": str(dt)}))
        if np.dtype(messages.wire_dtype(name)) != dt:
            out.append(Finding("dtype-policy", "error", entrypoint, f"wire_dtype({name})",
                               f"wire_dtype({name!r}) does not round-trip WIRE_DTYPES", {}))
    return out


# ---------------------------------------------------------------------------
# rule 6: telemetry-neutrality
# ---------------------------------------------------------------------------

def call_signature(records: Sequence) -> List[tuple]:
    """What a run launched, in order: (kernel, route, input and output
    shapes and dtypes)."""
    return [(c.name, c.route, c.inputs, c.outputs) for c in records]


def check_telemetry_neutrality(entrypoint: str, calls_off: Sequence, calls_on: Sequence,
                               outputs_equal: bool) -> List[Finding]:
    """The same entry point run with telemetry off and on: any difference
    in the recorded calls or the outputs means instrumentation reached the
    computation, an error; identity is recorded as info, so the rule is
    shown not to be vacuous on every lint run."""
    off, on = call_signature(calls_off), call_signature(calls_on)
    if off == on and outputs_equal:
        return [Finding("telemetry-neutrality", "info", entrypoint, "<calls>",
                        f"telemetry on runs the same {len(off)} kernel calls with "
                        f"bitwise-equal outputs", {"calls": len(off)})]
    diff_at = next((i for i, (a, b) in enumerate(zip(off, on)) if a != b),
                   min(len(off), len(on)))
    return [Finding(
        "telemetry-neutrality", "error", entrypoint, f"call {diff_at}",
        "telemetry on runs DIFFERENTLY from telemetry off"
        + ("" if outputs_equal else " (outputs differ)")
        + ": instrumentation reached the computation",
        {"first_diff_call": diff_at, "calls_off": len(off), "calls_on": len(on),
         "outputs_equal": bool(outputs_equal)})]
