"""Per-instantiation shared-memory and register budget of the CUDA kernels
on the H100. Stands for ``repro/analysis/vmem.py``.

The reference bounds each Pallas kernel's per-grid-step VMEM from its
traced BlockSpecs. On the H100 the limits are per block and per thread, so
the port keeps one row per compiled kernel instantiation of the libraries
built from ``csrc/*.cu`` (``kernels/build.py``, under ``build/kernels``):

- registers a thread, static shared memory, local (spill) and stack
  bytes: ``cuobjdump -res-usage`` of the built library;
- threads a block and the dynamic shared memory its launcher asks for:
  what the launch actually carried, read from a ``torch.profiler`` (CUPTI)
  trace of calls at the shapes the caller ran (its ``block`` and its
  ``shared memory``, static plus dynamic). An instantiation no traced call
  launched keeps its static columns and is marked not launched.

The budget (hopper-kernels guide): 232,448 bytes of shared memory a block,
at most 255 registers a thread and 65,536 a block, no local memory and no
stack, but for the spills ``SPILL_WAIVERS`` records. ``KERNEL_ROWS`` names, for each kernel function of each library,
the rows of the kernel table (PERF.md §6) it serves; every instantiation
must map to a row and rows 1-12 must all be served. Nothing here runs
without the card: on the CPU there is no built library and no table.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

SMEM_BLOCK_BYTES = 232_448      # opt-in shared memory a block (227 KiB)
REGS_THREAD_MAX = 255
REGS_BLOCK_MAX = 65_536
BUDGET = {"smem_block_bytes": SMEM_BLOCK_BYTES, "regs_thread": REGS_THREAD_MAX,
          "regs_block": REGS_BLOCK_MAX, "local_bytes": 0, "stack_bytes": 0}

# (library, kernel function, rows of PERF.md §6 it serves). The libraries
# are ``kernels/build.SOURCES``; ``sum_parts_kernel`` / ``sum_parts_f64_kernel``
# (``csrc/hopper.cuh``) add a contraction epilogue's per-block partials.
KERNEL_ROWS = (
    ("lora_dual", "lora_dual_mt_kernel", (1,)),
    ("lora_dual", "lora_mt_rank_kernel", (1,)),
    ("lora_dual", "lora_mt_tc_kernel", (1,)),
    ("lora_dual", "lora_mt_store_kernel", (1,)),
    ("lora_dual", "lora_dual_mt_jvps_kernel", (5,)),
    ("lora_dual", "lora_jvps_rank_kernel", (5,)),
    ("lora_dual", "lora_jvps_tc_kernel", (5,)),
    ("lora_dual", "sum_parts_kernel", (5,)),
    ("lora_dual_multi", "lora_dual_multi_kernel", (6,)),
    ("lora_dual_multi", "lora_multi_stream_kernel", (6,)),
    ("swa_attention", "swa_kernel", (2, 3, 4)),
    ("swa_attention", "swa_tc_kernel", (2,)),
    ("swa_attention", "swa_tc_mt_kernel", (3,)),
    ("swa_attention", "swa_tc_jvps_kernel", (4,)),
    ("swa_attention", "sum_parts_kernel", (4,)),
    ("wkv6_scan", "wkv6_primal_kernel", (7,)),
    ("wkv6_scan", "wkv6_kernel", (8, 9)),
    ("wkv6_scan", "sum_parts_kernel", (9,)),
    ("wkv6_chunk", "wkv6_chunk_kernel", (8, 9)),
    ("wkv6_chunk", "sum_parts_f64_kernel", (9,)),
    ("mamba2_scan", "mamba2_primal_kernel", (10,)),
    ("mamba2_scan", "mamba2_jvps_kernel", (11, 12)),
    ("mamba2_scan", "sum_parts_kernel", (12,)),
    ("mamba2_ssd", "mamba2_ssd_kernel", (11, 12)),
    ("mamba2_ssd", "sum_parts_f64_kernel", (12,)),
)
ALL_ROWS = tuple(range(1, 13))
# the kernel-table row of each entry point, by its launch-counter name (the
# name a recorded ``KernelCall`` carries)
CALL_ROWS = {"lora_dual_mt": 1, "swa_attention": 2, "swa_attention_mt": 3,
             "swa_attention_mt_jvps": 4, "lora_dual_mt_jvps": 5, "lora_dual_multi": 6,
             "wkv6_scan": 7, "wkv6_scan_mt": 8, "wkv6_scan_mt_jvps": 9,
             "mamba2_scan": 10, "mamba2_scan_mt": 11, "mamba2_scan_mt_jvps": 12}

# instantiations whose small register spill (an 8-24 byte stack frame) is
# kept, by template-id as ``name_key`` spells it: the one-block launch bound
# that removes it made the kernel slower (``scripts/route_timings.py``,
# PERF.md §6, PR 28). Each downgrades its stack and local-memory findings to
# info with the reason; every other over-budget finding stays an error.
SPILL_WAIVERS = {
    "lora_dual_mt_kernel<float,1>": (
        "simt LoRA tangents with an input tangent (fp32): 1.24x slower at one "
        "block an SM"),
    "lora_dual_mt_kernel<__nv_bfloat16,1>": (
        "simt LoRA tangents with an input tangent (unaligned bf16): shares the "
        "fp32 instantiation's bound, which made the fp32 ones 1.24-1.65x slower"),
    "mamba2_jvps_kernel<2,8>": (
        "recurrent mamba2 contraction (S > 32): 1.14x slower at T=64 at one "
        "block an SM"),
    "swa_tc_kernel<6,0>": (
        "attention primal at hd 96, a width no config has: the padded "
        "instantiation that does not spill is 1.12x slower at S=32"),
}

_RES = re.compile(r"REG:(\d+)\s+STACK:(\d+)\s+SHARED:(\d+)\s+LOCAL:(\d+)")


def kernel_function(mangled: str, library: str) -> str:
    """The kernel function of one of ``library``'s instantiations, from its
    mangled name: the longest of the library's kernel functions whose
    length-prefixed identifier (``13swa_tc_kernel``) the name holds."""
    names = [fn for lib, fn, _ in KERNEL_ROWS if lib == library]
    hits = [fn for fn in names if f"{len(fn)}{fn}" in mangled]
    return max(hits, key=len) if hits else mangled


def rows_of(library: str, function: str) -> tuple:
    """The kernel-table rows ``function`` of ``library`` serves; () if it
    is not in ``KERNEL_ROWS``."""
    return next((rows for lib, fn, rows in KERNEL_ROWS
                 if lib == library and fn == function), ())


def parse_res_usage(text: str) -> Dict[str, Dict[str, int]]:
    """{mangled function: {reg, stack, shared, local}} from the text of
    ``cuobjdump -res-usage``."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        m = _RES.search(line)
        if m and fn:
            out[fn] = dict(zip(("reg", "stack", "shared", "local"), map(int, m.groups())))
            fn = None
    return out


def cuobjdump(*args: str) -> str:
    """The standard output of ``cuobjdump`` (on the PATH, else beside
    nvcc) on ``args``."""
    from repro_torch.kernels import build
    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build._nvcc()),
                                                    "cuobjdump")
    return subprocess.run([exe, *args], capture_output=True, text=True, timeout=300,
                          check=True).stdout


def demangle(name: str) -> str:
    """``name`` demangled by the C++ runtime's ``__cxa_demangle``, the
    demangler the profiler's trace uses for kernel names (unchanged if it
    is not a mangled name)."""
    import ctypes
    lib = ctypes.CDLL("libstdc++.so.6")
    fn = lib.__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(0)
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        ctypes.CDLL("libc.so.6").free(ctypes.c_void_p(ptr))


def name_key(name: str) -> str:
    """A demangled name with spelling the demanglers differ in removed
    (whitespace, casts of template arguments, the anonymous namespace), so
    a trace's name and a library's instantiation compare equal."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    name = re.sub(r"\((?:int|bool|unsigned int|long)\)", "", name)
    name = name.replace("true", "1").replace("false", "0")
    return re.sub(r"\s+", "", name)


def res_usage(library: str) -> Dict[str, Dict]:
    """Each instantiation of a built library: {mangled name: {reg, stack,
    shared, local}}. Raises if the library was not built."""
    from repro_torch.kernels import build
    path = build._target(library)
    if not Path(path).exists():
        raise FileNotFoundError(f"{library}: no built library at {path}")
    return parse_res_usage(cuobjdump("-res-usage", str(path)))


def launches_from_trace(trace) -> Dict[str, Dict]:
    """{demangled kernel name: {threads, smem, regs, launches}} of the
    kernel launches in a Chrome trace of ``torch.profiler`` (a path, or the
    loaded JSON): the largest block and shared memory seen. ``smem`` is the
    trace's ``shared memory``, static plus dynamic."""
    if isinstance(trace, (str, Path)):
        with open(trace) as f:
            trace = json.load(f)
    out = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        args = ev.get("args", {})
        block = args.get("block")
        if block is None or "shared memory" not in args:
            raise KeyError(f"kernel event {ev.get('name')!r} carries no block / shared "
                           f"memory: {sorted(args)}")
        threads = int(block[0]) * int(block[1]) * int(block[2])
        row = out.setdefault(name_key(ev["name"]), {"threads": 0, "smem": 0, "regs": 0,
                                                    "launches": 0, "name": ev["name"]})
        row["threads"] = max(row["threads"], threads)
        row["smem"] = max(row["smem"], int(args["shared memory"]))
        row["regs"] = max(row["regs"], int(args.get("registers per thread", 0)))
        row["launches"] += 1
    return out


def spill_waiver(name: str) -> Optional[str]:
    """The ``SPILL_WAIVERS`` reason for a demangled instantiation name, or
    None."""
    key = name_key(name)
    return next((why for tid, why in SPILL_WAIVERS.items() if f"{tid}(" in key), None)


def check_row(row: Dict) -> List[str]:
    """What of the budget one row breaks (empty when it fits); a waived
    row's spill is not counted (``SPILL_WAIVERS``)."""
    over = []
    if row["reg"] > REGS_THREAD_MAX:
        over.append(f"{row['reg']} registers a thread > {REGS_THREAD_MAX}")
    if row["local"] > 0 and not row["waiver"]:
        over.append(f"{row['local']} bytes of local memory (spills)")
    if row["stack"] > 0 and not row["waiver"]:
        over.append(f"a {row['stack']}-byte stack frame")
    smem = row["static_smem"] + (row["dynamic_smem"] or 0)
    if smem > SMEM_BLOCK_BYTES:
        over.append(f"{smem} bytes of shared memory a block > {SMEM_BLOCK_BYTES}")
    if row["threads"] and row["reg"] * row["threads"] > REGS_BLOCK_MAX:
        over.append(f"{row['reg']} x {row['threads']} registers a block > {REGS_BLOCK_MAX}")
    if not row["rows"]:
        over.append("maps to no row of the kernel table")
    return over


def smem_table(usage: Dict[str, Dict[str, Dict]],
               launched: Optional[Dict[str, Dict]] = None) -> List[Dict]:
    """One row per instantiation: ``usage`` {library: ``res_usage``} (keyed
    by mangled name), ``launched`` a ``launches_from_trace`` of the calls
    that were run (keyed by ``name_key``)."""
    launched = launched or {}
    rows = []
    for library, fns in sorted(usage.items()):
        for mangled, u in sorted(fns.items()):
            name = demangle(mangled)
            run = launched.get(name_key(name))
            fn = kernel_function(mangled, library)
            row = {"kernel": name, "library": library, "function": fn,
                   "rows": list(rows_of(library, fn)),
                   "reg": u["reg"], "stack": u["stack"], "local": u["local"],
                   "static_smem": u["shared"], "launched": run is not None,
                   "threads": run["threads"] if run else None,
                   "dynamic_smem": max(run["smem"] - u["shared"], 0) if run else None,
                   "launches": run["launches"] if run else 0,
                   "waiver": spill_waiver(name)}
            row["over"] = check_row(row)
            row["ok"] = not row["over"]
            rows.append(row)
    return rows


def unmatched_launches(table: List[Dict], launched: Dict[str, Dict]) -> List[str]:
    """Launched kernels of the port's libraries (a kernel function of
    ``KERNEL_ROWS`` in the name) that no instantiation of the table
    matched: a join that failed."""
    seen = {name_key(row["kernel"]) for row in table}
    fns = {fn for _, fn, _ in KERNEL_ROWS}
    return sorted(r["name"] for k, r in launched.items()
                  if k not in seen and any(re.search(rf"\b{f}\b", r["name"]) for f in fns))


def untraced_calls(records, launched: Dict[str, Dict]) -> Dict[int, tuple]:
    """{row: (kernel calls, traced launches)} of each kernel-table row whose
    recorded kernel calls (``records``, ``KernelCall``s that ran the kernel)
    outnumber the launches of that row's kernel functions (the partial-sum
    epilogues aside) in ``launched``, a ``launches_from_trace`` of the same
    run: calls the profiler did not see, whose block and dynamic shared
    memory went unread."""
    want: Dict[int, int] = {}
    for c in records:
        if c.ran == "kernel":
            want[CALL_ROWS[c.name]] = want.get(CALL_ROWS[c.name], 0) + 1
    out = {}
    for row, n in sorted(want.items()):
        fns = {fn for _, fn, rows in KERNEL_ROWS
               if row in rows and not fn.startswith("sum_parts")}
        seen = sum(r["launches"] for r in launched.values()
                   if any(re.search(rf"\b{f}\b", r["name"]) for f in fns))
        if seen < n:
            out[row] = (n, seen)
    return out


def merge_launches(*launched: Dict[str, Dict]) -> Dict[str, Dict]:
    """Several ``launches_from_trace`` results as one: the largest block and
    shared memory of each kernel, its launches summed."""
    out = {}
    for one in launched:
        for key, r in one.items():
            if key not in out:
                out[key] = dict(r)
                continue
            m = out[key]
            for k in ("threads", "smem", "regs"):
                m[k] = max(m[k], r[k])
            m["launches"] += r["launches"]
    return out


def card_table(traces=()) -> List[Dict]:
    """The table of every instantiation of the seven built libraries, with
    the launches of ``traces`` (``torch.profiler`` Chrome traces) joined in."""
    from repro_torch.kernels import build
    usage = {lib: res_usage(lib) for lib in build.SOURCES}
    launched = merge_launches(*(launches_from_trace(t) for t in traces))
    table = smem_table(usage, launched)
    missed = unmatched_launches(table, launched)
    if missed:
        raise ValueError(f"launched kernels matched no built instantiation: {missed[:4]}")
    return table


def _defined_kernels(text: str) -> List[str]:
    names = []
    for m in re.finditer(r"__global__", text):
        seg = re.sub(r"__launch_bounds__\([^)]*\)|__cluster_dims__\([^)]*\)|\bvoid\b",
                     "", text[m.end():m.end() + 400])
        names.append(re.search(r"(\w+)\s*\(", seg).group(1))
    return names


def csrc_kernel_functions() -> Dict[str, List[str]]:
    """{library: the ``__global__`` kernel functions it can hold}, read from
    ``csrc``: those its source defines, and those of the quoted headers it
    includes that the source names."""
    from repro_torch.kernels import build
    out = {}
    for lib in build.SOURCES:
        src, *headers = build._inputs(build.CSRC / build.SOURCES[lib])
        text = src.read_text()
        names = set(_defined_kernels(text))
        for h in headers:
            names |= {n for n in _defined_kernels(h.read_text())
                      if re.search(rf"\b{n}\b", text)}
        out[lib] = sorted(names)
    return out
