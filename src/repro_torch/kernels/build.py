"""Build the CUDA kernels under ``repro_torch/csrc`` at first use.

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface for ``sm_90a``,
then loaded with ``ctypes``. Libraries are cached by a hash of the source,
every header it includes with quotes (``csrc/hopper.cuh``) and the flags,
in ``<repo>/build/kernels`` (listed in ``.gitignore``), so a fresh checkout
builds everything on its first call and nothing afterwards, and an edited
header rebuilds every source that includes it. Nothing here runs at import
time: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"lora_dual": "lora_dual_mt.cu", "lora_dual_multi": "lora_dual_multi.cu",
           "swa_attention": "swa_attention.cu", "mamba2_ssd": "mamba2_ssd.cu",
           "mamba2_scan": "mamba2_scan.cu", "wkv6_scan": "wkv6_scan.cu",
           "wkv6_chunk": "wkv6_chunk.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources whose many instantiations are optimized on every core
# (``-split-compile``): swa_attention's tensor-core kernels at 12 head widths,
# each padded and not, build in about half the time, to the same registers
# and times; the others keep one process each, as before
SPLIT_COMPILE = {"swa_attention"}

_libs: dict = {}
ptxas_logs: dict = {}     # name -> nvcc's -Xptxas -v report of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _inputs(path: Path, seen=None) -> list:
    """``path`` and, depth first, every file it includes with quotes
    (resolved beside the including file, as nvcc does), each once."""
    seen = [] if seen is None else seen
    path = path.resolve()
    if path in seen:
        return seen
    seen.append(path)
    for name in _INCLUDE.findall(path.read_bytes()):
        inc = path.parent / name.decode()
        if inc.exists():
            _inputs(inc, seen)
    return seen


def _flags(name: str) -> list:
    return NVCC_FLAGS + (["-split-compile=0"] if name in SPLIT_COMPILE else [])


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for path in _inputs(CSRC / SOURCES[name]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) in parallel; returns
    {name: library path}. Raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
