"""Build the CUDA kernels under ``repro_torch/csrc`` at first use.

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface for ``sm_90a``,
then loaded with ``ctypes``. Libraries are cached by source hash in
``<repo>/build/kernels`` (listed in ``.gitignore``), so a fresh checkout
builds everything on its first call and nothing afterwards. Nothing here
runs at import time: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"lora_dual": "lora_dual_mt.cu", "lora_dual_multi": "lora_dual_multi.cu",
           "swa_attention": "swa_attention.cu", "mamba2_scan": "mamba2_scan.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
ptxas_logs: dict = {}     # name -> nvcc's -Xptxas -v report of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / SOURCES[name]).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


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
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
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
