"""Queries over the kernel calls an entry point made. Stands for
``repro/analysis/jaxpr_walker.py``.

The reference walks a traced jaxpr for ``pallas_call`` equations; the port
has no trace to walk, so it records what actually runs: every call of a
kernel entry point (``kernels/*/ops.py``) while ``record_calls()`` is open
appends a ``KernelCall`` (``repro_torch.kernels.calls``) with the
kernel's name, whether the kernel or its plain version ran, its route,
the shapes and dtypes it read and wrote, and whether the forward-AD region
was open. A call's ``outputs`` are what it wrote to memory, the per-block
partials of a contraction epilogue included.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.kernels.calls import KernelCall, record_calls  # noqa: F401

# the kernel family (a ``kernels/`` package) of each entry point's name
FAMILIES = ("lora_dual", "swa_attention", "mamba2_scan", "wkv6_scan")


def kernel_name(call: KernelCall) -> str:
    """The kernel's launch-counter name, e.g. ``'swa_attention_mt_jvps'``."""
    return call.name


def kernel_family(call: KernelCall) -> str:
    return next((f for f in FAMILIES if call.name.startswith(f)), "other")


def calls(records: Sequence[KernelCall], family: Optional[str] = None,
          name: Optional[str] = None) -> List[KernelCall]:
    """The recorded calls, optionally only those of one kernel family
    (``'lora_dual'`` / ``'swa_attention'`` / ``'mamba2_scan'`` /
    ``'wkv6_scan'``) or of one kernel. Upstream (non-site) layers
    legitimately write their tangents, so site checks filter by family."""
    return [c for c in records
            if (family is None or kernel_family(c) == family)
            and (name is None or c.name == name)]


def is_contraction(call: KernelCall) -> bool:
    """A ``*_mt_jvps`` contraction epilogue."""
    return call.name.endswith("_mt_jvps")


def tangent_stack_size(K: int, y_shape) -> int:
    """Element count of the (K,) + y_shape tangent stack the contraction
    epilogues exist to remove."""
    n = int(K)
    for s in y_shape:
        n *= int(s)
    return n


def tangent_stack_outputs(records: Sequence[KernelCall], K: int, y_shape,
                          family: Optional[str] = None) -> List[tuple]:
    """Every (call, output spec) where a call WRITES a tensor at least as
    large as the (K,) + y_shape tangent stack. Site INPUT tangents of that
    size are unavoidable (they are kernel operands); the invariant targets
    what a call writes: the tangents a ``*_mt`` kernel stores and the
    ``*_mt_jvps`` epilogues replace with per-block partials."""
    stack = tangent_stack_size(K, y_shape)
    return [(c, spec) for c in calls(records, family)
            for spec, n in zip(c.outputs, c.numel("outputs")) if n >= stack]


def assert_no_tangent_stack(records: Sequence[KernelCall], K: int, y_shape,
                            family: Optional[str] = None) -> None:
    """Raise AssertionError if any recorded call wrote a tangent-stack-sized
    tensor."""
    for call, spec in tangent_stack_outputs(records, K, y_shape, family):
        raise AssertionError(
            f"{call.name} ({call.route}) writes a tangent-stack-sized tensor "
            f"{spec[0]} (>= K x y = {tangent_stack_size(K, y_shape)} elems)")
