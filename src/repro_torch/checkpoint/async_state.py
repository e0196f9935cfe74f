"""JSON-safe encoding of the async engine's virtual-time snapshot.

Copy of ``repro/checkpoint/async_state.py`` (host-only).

``AsyncFederationEngine.snapshot()`` captures the event heap and staleness
buffer with in-flight wire frames as RAW BYTES (the exact CRC-sealed frames
— restoring them byte-for-byte is what makes kill-and-resume bitwise even
for updates that were in flight when the process died). The run manifest's
``extra`` dict is JSON, so frames are transported as base64 strings:

    manifest.extra["async"] = encode_async_snapshot(engine.snapshot())
    engine.restore(decode_async_snapshot(manifest.extra["async"]))

Floats round-trip exactly (Python's json emits repr-precision binary64),
so the virtual clock and per-dispatch compute durations restore to the
identical bits the heap ordering depends on.
"""
from __future__ import annotations

import base64
from typing import Any, Dict

_BYTES_KEYS = ("frames",)     # heap payload keys holding lists of frames


def _encode_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(payload)
    for k in _BYTES_KEYS:
        if k in out:
            out[k] = [base64.b64encode(f).decode("ascii") for f in out[k]]
    return out


def _decode_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(payload)
    for k in _BYTES_KEYS:
        if k in out:
            out[k] = [base64.b64decode(f) for f in out[k]]
    return out


def encode_async_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Raw engine snapshot (bytes in place) -> JSON-safe dict."""
    out = dict(snap)
    out["heap"] = {
        "next_seq": snap["heap"]["next_seq"],
        "entries": [{"t": e["t"], "seq": e["seq"],
                     "payload": _encode_payload(e["payload"])}
                    for e in snap["heap"]["entries"]],
    }
    out["buffer"] = [
        {**e, "frame": base64.b64encode(e["frame"]).decode("ascii")}
        for e in snap["buffer"]]
    return out


def decode_async_snapshot(doc: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe dict -> raw engine snapshot (bytes restored)."""
    out = dict(doc)
    out["heap"] = {
        "next_seq": int(doc["heap"]["next_seq"]),
        "entries": [{"t": float(e["t"]), "seq": int(e["seq"]),
                     "payload": _decode_payload(e["payload"])}
                    for e in doc["heap"]["entries"]],
    }
    out["buffer"] = [
        {**e, "frame": base64.b64decode(e["frame"])}
        for e in doc["buffer"]]
    return out
