"""Memory probes: measured residency as ``memory`` telemetry events. Port
of ``repro/obs/memory.py``'s runtime side.

``live_array_bytes`` stands for ``jax.live_arrays()``'s total: on CUDA the
caching allocator's ``memory_allocated`` summed over the devices, on the
CPU the bytes of the distinct storages of the live tensors a ``gc`` walk
finds. ``device_memory_stats`` stands for ``Device.memory_stats()``: the
allocator's numbers under XLA's key names, keyed ``cuda:{i}``; without
CUDA it is empty, as the reference's CPU backend returns nothing.

Probing is host-side and read-only: reading the allocator's numbers
starts no kernel, adds no ``synchronize`` and allocates nothing on the
device. The reference's static side (``modeled_peak_bytes``,
``modeled_peak_of``: a liveness walk over compiled HLO) has no counterpart
in the port; ``sample`` still pairs a caller's modeled number with the
measurement.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

# XLA's memory_stats key <- torch.cuda.memory_stats key
_XLA_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
             ("peak_bytes_in_use", "allocated_bytes.all.peak"),
             ("bytes_reserved", "reserved_bytes.all.current"))


def _cuda_devices():
    """The CUDA devices this process has initialised (none on the CPU)."""
    if not torch.cuda.is_initialized():
        return range(0)
    return range(torch.cuda.device_count())


def live_array_bytes() -> int:
    """Total bytes of every live tensor in the process: the CUDA
    allocator's allocated bytes where CUDA is in use, else the distinct
    storages of the live CPU tensors."""
    devices = _cuda_devices()
    if len(devices):
        return sum(torch.cuda.memory_allocated(i) for i in devices)
    seen = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # deprecated module attributes answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):   # no storage (views
            continue                                  # of wrapper types)
        seen[st.data_ptr()] = st.nbytes()
    return int(sum(seen.values()))


def device_memory_stats() -> Dict[str, Dict]:
    """Per-device allocator stats under XLA's key names (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved``, ``bytes_limit``); empty
    without CUDA (the live-tensor total still applies)."""
    out = {}
    for i in _cuda_devices():
        stats = torch.cuda.memory_stats(i)
        rec = {xla: int(stats.get(key, 0)) for xla, key in _XLA_KEYS}
        rec["bytes_limit"] = int(torch.cuda.get_device_properties(i).total_memory)
        out[f"cuda:{i}"] = rec
    return out


class MemoryProbe:
    """Samples runtime residency into gauges + ``memory`` events.

    ``sample(label)`` records live-tensor bytes (and device stats when
    available); pass ``modeled_bytes`` to pair a modeled number with the
    measurement in the same event.
    """

    def __init__(self, telemetry):
        self.telemetry = telemetry
        self._g_live = telemetry.gauge("mem.live_array_bytes")
        self._g_modeled = telemetry.gauge("mem.modeled_peak_bytes")

    def sample(self, label: str,
               modeled_bytes: Optional[float] = None) -> Dict:
        rec = {"label": label, "live_bytes": live_array_bytes()}
        stats = device_memory_stats()
        if stats:
            rec["device_stats"] = stats
            rec["device_bytes_in_use"] = sum(
                s.get("bytes_in_use", 0) for s in stats.values())
        if modeled_bytes is not None:
            rec["modeled_peak_bytes"] = float(modeled_bytes)
            self._g_modeled.set(float(modeled_bytes))
        self._g_live.set(rec["live_bytes"])
        self.telemetry.event("memory", **rec)
        return rec
