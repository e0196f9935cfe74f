"""The forward-AD region and a recorder of the calls that reach a kernel
entry point.

``forward_ad_region()`` is the context the estimator opens around its jvp;
``kernels/dispatch`` reads it to send tangents to the multi-tangent
kernels. It lives here so the kernel entry points can stamp it on a
recorded call without importing the dispatch layer.

``record_calls()`` opens a recorder: while it is open, each call of a
``kernels/*/ops.py`` entry point (the twelve kernels' wrappers, at the
place their launch counters sit) appends one ``KernelCall``: which kernel,
whether the kernel or its plain version ran and by which route, the
shapes and dtypes of what it read and wrote, and whether
``forward_ad_region()`` was open. On the CPU the plain versions are
recorded at the same boundary, so whatever reads the records
(``repro_torch.analysis``) runs there too. With no recorder open a call
pays one ``None`` test.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Tuple

import torch

_fwd_region = contextvars.ContextVar("repro_torch_forward_ad_region", default=False)

# the open recorder's list, None while no record_calls() is open (read as
# ``calls.recording`` by the entry points)
recording: Optional[List["KernelCall"]] = None


@contextlib.contextmanager
def forward_ad_region():
    """Within this context LoRA-projection and attention tangents go to the
    multi-tangent kernels."""
    token = _fwd_region.set(True)
    try:
        yield
    finally:
        _fwd_region.reset(token)


def in_forward_ad_region() -> bool:
    return _fwd_region.get()


@dataclasses.dataclass(frozen=True)
class KernelCall:
    name: str         # the kernel's launch-counter name, e.g. "swa_attention_mt_jvps"
    ran: str          # "kernel" or "plain"
    route: str        # the kernel's route ("tc", "stream", "chunk", ...; "cuda"
                      # for a kernel with one), "plain" for the plain version
    inputs: Tuple     # ((shape, dtype), ...) of the tensors read; None if absent
    outputs: Tuple    # ((shape, dtype), ...) of the tensors written to device memory
    forward_ad: bool  # forward_ad_region() was open

    def numel(self, which="outputs"):
        """Element count of each recorded tensor, 0 for an absent one."""
        out = []
        for spec in getattr(self, which):
            n = 1
            for s in (spec[0] if spec else (0,)):
                n *= s
            out.append(n)
        return out


def _spec(t):
    if not isinstance(t, torch.Tensor):
        return None
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _flat(ts):
    if isinstance(ts, torch.Tensor) or ts is None:
        return (ts,)
    return tuple(ts)


def record(name: str, route: str, inputs, outputs) -> None:
    """Append one call to the open recorder (the entry points call this
    only when ``recording`` is not None). ``outputs``: the tensors the call
    wrote, its scratch buffers in device memory included."""
    recording.append(KernelCall(
        name=name, ran="plain" if route == "plain" else "kernel", route=route,
        inputs=tuple(_spec(t) for t in _flat(inputs)),
        outputs=tuple(_spec(t) for t in _flat(outputs)),
        forward_ad=_fwd_region.get()))


@contextlib.contextmanager
def record_calls():
    """Record every kernel entry-point call made inside the context; yields
    the list the calls are appended to. Recorders nest: an inner one takes
    the calls made while it is open."""
    global recording
    outer, recording = recording, []
    try:
        yield recording
    finally:
        recording = outer
