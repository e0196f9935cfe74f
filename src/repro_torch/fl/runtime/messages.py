"""Federation wire protocol: the two messages of one SPRY round.

Port of ``repro/fl/runtime/messages.py``: for the same numpy payload arrays
and header fields a frame is byte-identical to the reference's. Numpy has
no bfloat16 type here (the reference borrows jax's), so a bf16 payload is
held as raw 2-byte values (``BF16``, numpy ``V2``: the bf16 bit patterns,
rounded to nearest even by torch, as the reference's cast rounds) and named
``bfloat16`` on the wire, as the reference names it. ``from_delta`` and
``to_delta`` take and give the port's torch peft trees; the conversion to
and from numpy happens there only.

    server -> client   TaskAssignment   round seed ref + unit-mask id +
                                        hyperparams (the weights themselves
                                        travel via the model-distribution
                                        channel, not per-round)
    client -> server   ClientUpdate     per-epoch:     masked delta payload
                                        per-iteration: K jvp scalars + seed
                                                       ref (the paper's
                                                       Table-2 trick: the
                                                       server regenerates
                                                       the perturbations
                                                       from the shared seed)

Both messages serialize to a self-describing, integrity-sealed binary frame
(wire schema v2):

    MAGIC(4) | header_len uint32 LE | header json (utf-8) | raw buffers
    [| fixed trailer] | crc32 uint32 LE over everything preceding it

The magic's 4th byte is the wire VERSION and the header carries a redundant
``schema`` tag plus the raw-payload byte count (``blen``), so strict decode
can classify exactly what went wrong on a flaky uplink: ``WireError.kind``
is one of ``truncated`` / ``corrupt`` (checksum) / ``version_mismatch`` /
``bad_magic`` / ``schema_mismatch`` / ``shape_mismatch``. A frame that
decodes without raising is byte-for-byte the frame that was sent (CRC32
over the full body) — there is no silent third outcome, which is the
contract the engine's quarantine path is built on (the same mangled frames
classify as the reference's: tests/test_torch_runtime_wire.py).

``byte_size()`` is MEASURED from the actual serialized frame — the
reconciliation against the analytic ``fl/comm.py`` Table-2 parameter counts
is asserted in tests/test_torch_runtime_wire.py. Scalar payloads are quantized on the
wire with a configurable dtype (fp32 lossless / bf16 / fp16); fp32 framing
round-trips bit-exactly, which is what keeps the runtime's ideal-network
round bit-identical to the in-process round step.

Frames are encoded ONCE per message: ``to_bytes()`` memoizes the sealed
frame so ``byte_size()`` and the send path share a single serialization, and
``from_bytes`` seeds the cache with the received bytes (CRC-verified to be
exactly what was sealed). Mutating a message after encoding requires
``invalidate_encoding()`` — the engine's poison path does this.

``ClientUpdate.base_version`` is the async engine's staleness round tag:
the server model version the update was computed against. It is ``None``
on synchronous frames and only serialized when set, so sync frames are
byte-identical to wire schema v2 as shipped.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

# bf16 payloads: the raw 2-byte bit patterns (numpy has no bfloat16)
BF16 = np.dtype("V2")

WIRE_SCHEMA = 2          # header schema tag; bump with the magic version
MAGIC_ASSIGN = b"SPA2"
MAGIC_UPDATE = b"SPU2"

FAILURE_KINDS = ("truncated", "corrupt", "version_mismatch", "bad_magic",
                 "schema_mismatch", "shape_mismatch")


class WireError(ValueError):
    """A frame that failed strict decode, classified by ``kind``.

    truncated         frame shorter than its own declared layout
    corrupt           CRC32 mismatch or unparseable header (bit flips)
    version_mismatch  right message family, different wire version byte
    bad_magic         not one of our frames at all
    schema_mismatch   header's redundant schema tag disagrees
    shape_mismatch    lengths/meta internally inconsistent (trailing bytes,
                      buffer meta not matching the raw section, bad fields)
    """

    def __init__(self, kind: str, detail: str = ""):
        if kind not in FAILURE_KINDS:
            raise AssertionError(f"unknown failure kind {kind!r}")
        self.kind = kind
        super().__init__(f"[{kind}] {detail}" if detail else kind)

WIRE_DTYPES: Dict[str, np.dtype] = {
    "fp32": np.dtype(np.float32),
    "fp16": np.dtype(np.float16),
    "bf16": BF16,
}


def wire_dtype(name: str) -> np.dtype:
    try:
        return WIRE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown wire dtype {name!r}; available: {sorted(WIRE_DTYPES)}")


def to_wire(a, dt: np.dtype) -> np.ndarray:
    """An fp32 array or tensor quantized to the wire dtype ``dt`` (bf16:
    round to nearest even, as the reference's cast)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    if dt == BF16:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16)
    return np.asarray(a).astype(dt)


def as_float(a) -> np.ndarray:
    """A payload array as numbers: bf16 bit patterns widened to fp32
    (exact), every other dtype as it is."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
                << 16).view(np.float32)
    return a


def _encode_buffers(buffers):
    """buffers: list of np arrays -> (meta list, concatenated bytes)."""
    meta, blobs = [], []
    for b in buffers:
        b = np.ascontiguousarray(b)
        meta.append({"shape": list(b.shape),
                     "dtype": "bfloat16" if b.dtype == BF16 else b.dtype.name})
        blobs.append(b.tobytes())
    return meta, b"".join(blobs)


def _decode_buffers(meta, raw: bytes):
    out, off = [], 0
    if not isinstance(meta, list):
        raise WireError("shape_mismatch", "buffer meta is not a list")
    for m in meta:
        try:
            dt = BF16 if m["dtype"] == "bfloat16" else np.dtype(m["dtype"])
            shape = [int(s) for s in m["shape"]]
        except (KeyError, TypeError, ValueError) as e:
            raise WireError("shape_mismatch", f"bad buffer meta: {e}")
        if any(s < 0 for s in shape):
            raise WireError("shape_mismatch", f"negative dim in {shape}")
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + n > len(raw):
            raise WireError("truncated",
                            f"buffer needs {n} bytes, {len(raw) - off} left")
        out.append(np.frombuffer(raw[off:off + n], dtype=dt).reshape(shape))
        off += n
    if off != len(raw):
        raise WireError("shape_mismatch",
                        f"trailing bytes in frame: {len(raw) - off}")
    return out


def _frame(magic: bytes, header: dict, raw: bytes,
           trailer: bytes = b"") -> bytes:
    """Seal a frame: header gains the schema tag + raw byte count, and a
    CRC32 over the whole body rides as a 4-byte suffix."""
    header = dict(header)
    header["schema"] = WIRE_SCHEMA
    header["blen"] = len(raw)
    hj = json.dumps(header, separators=(",", ":")).encode()
    body = magic + np.uint32(len(hj)).tobytes() + hj + raw + trailer
    return body + np.uint32(zlib.crc32(body)).tobytes()


def _unframe(magic: bytes, data: bytes,
             trailer_len: int = 0) -> Tuple[dict, bytes, bytes]:
    """Strict decode of a sealed frame -> (header, raw, trailer).

    Classification order is structural-first so the taxonomy is useful:
    magic/version, declared lengths, header parse, schema tag, CRC. Every
    failure raises ``WireError``; success implies the bytes are exactly
    what the sender sealed (CRC32 over the full body).
    """
    data = bytes(data)
    if len(data) < 12 + trailer_len:
        raise WireError("truncated", f"{len(data)} bytes < minimum frame")
    got = data[:4]
    if got != magic:
        if got[:3] == magic[:3]:
            raise WireError("version_mismatch", f"{got!r} (want {magic!r})")
        raise WireError("bad_magic", f"{got!r} (want {magic!r})")
    hlen = int(np.frombuffer(data[4:8], np.uint32)[0])
    if 8 + hlen + trailer_len + 4 > len(data):
        raise WireError("truncated",
                        f"header claims {hlen} bytes, frame has {len(data)}")
    try:
        header = json.loads(data[8:8 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError("corrupt", f"unparseable header: {e}")
    if not isinstance(header, dict) or "schema" not in header:
        raise WireError("schema_mismatch", "header missing schema tag")
    if header["schema"] != WIRE_SCHEMA:
        raise WireError("schema_mismatch",
                        f"schema {header['schema']!r} != {WIRE_SCHEMA}")
    try:
        blen = int(header["blen"])
    except (KeyError, TypeError, ValueError):
        raise WireError("shape_mismatch", "header missing/bad blen")
    expected = 8 + hlen + blen + trailer_len + 4
    if len(data) < expected:
        raise WireError("truncated",
                        f"frame {len(data)} bytes < declared {expected}")
    if len(data) > expected:
        raise WireError("shape_mismatch",
                        f"frame {len(data)} bytes > declared {expected}")
    body, crc = data[:-4], data[-4:]
    if zlib.crc32(body) != int(np.frombuffer(crc, np.uint32)[0]):
        raise WireError("corrupt", "checksum mismatch")
    raw = data[8 + hlen:8 + hlen + blen]
    trailer = data[8 + hlen + blen:8 + hlen + blen + trailer_len]
    return header, raw, trailer


def decode_frame(data: bytes):
    """Strict decode of an unknown frame -> TaskAssignment | ClientUpdate.

    The single entry point the engine's quarantine path uses: either the
    decoded message is returned (bitwise-faithful, CRC-verified) or a
    ``WireError`` classifies the failure — never a silently-wrong value.
    """
    head = bytes(data[:4]) if len(data) >= 4 else bytes(data)
    if head == MAGIC_ASSIGN:
        return TaskAssignment.from_bytes(data)
    if head == MAGIC_UPDATE:
        return ClientUpdate.from_bytes(data)
    if len(data) < 12:
        raise WireError("truncated", f"{len(data)} bytes < minimum frame")
    for magic in (MAGIC_ASSIGN, MAGIC_UPDATE):
        if head[:3] == magic[:3]:
            raise WireError("version_mismatch", f"{head!r} (want {magic!r})")
    raise WireError("bad_magic", f"{head!r}")


# ---------------------------------------------------------------------------
# TaskAssignment (server -> client)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskAssignment:
    """One client's marching orders for one round.

    ``seed_id`` is the client's position in the round's fold_in chain (what
    the reference round step calls ``client_id = arange(M)``); ``client_id``
    is the logical population id (data shard / availability identity).
    ``unit_ids`` are indices into the round's UnitIndex — the unit-mask id.
    """
    round_idx: int
    client_id: int
    seed_id: int
    cohort_size: int
    seed: int                    # global algorithm seed; the chain is
                                 # fold_in(fold_in(key, round), seed_id)
    n_units: int                 # U — so the mask row can be rebuilt
    unit_ids: np.ndarray         # (n_assigned,) int32
    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _encoded: Optional[bytes] = dataclasses.field(
        default=None, repr=False, compare=False)

    def mask_row(self) -> np.ndarray:
        row = np.zeros((self.n_units,), np.float32)
        row[np.asarray(self.unit_ids, np.int64)] = 1.0
        return row

    def _encode(self) -> bytes:
        meta, raw = _encode_buffers(
            [np.asarray(self.unit_ids, np.int32)])
        header = {
            "round_idx": int(self.round_idx),
            "client_id": int(self.client_id),
            "seed_id": int(self.seed_id),
            "cohort_size": int(self.cohort_size),
            "seed": int(self.seed),
            "n_units": int(self.n_units),
            "hparams": self.hparams,
            "buffers": meta,
        }
        return _frame(MAGIC_ASSIGN, header, raw)

    def to_bytes(self) -> bytes:
        if self._encoded is None:
            self._encoded = self._encode()
        return self._encoded

    def invalidate_encoding(self) -> None:
        """Drop the memoized frame after mutating fields in place."""
        self._encoded = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "TaskAssignment":
        header, raw, _ = _unframe(MAGIC_ASSIGN, data)
        try:
            (unit_ids,) = _decode_buffers(header["buffers"], raw)
            out = cls(round_idx=int(header["round_idx"]),
                      client_id=int(header["client_id"]),
                      seed_id=int(header["seed_id"]),
                      cohort_size=int(header["cohort_size"]),
                      seed=int(header["seed"]),
                      n_units=int(header["n_units"]),
                      unit_ids=unit_ids.astype(np.int32),
                      hparams=header["hparams"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireError("shape_mismatch", f"bad assignment header: {e}")
        # CRC guarantees these bytes are exactly what was sealed, so the
        # received frame IS a faithful encoding — seed the cache with it
        out._encoded = bytes(data)
        return out

    def byte_size(self) -> int:
        return len(self.to_bytes())


# ---------------------------------------------------------------------------
# ClientUpdate (client -> server)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientUpdate:
    """One client's uplink for one round.

    mode='delta' (per-epoch): ``unit_payload`` maps unit id -> flat list of
    that unit's delta leaves (e.g. the LoRA (A,B) slices at one depth);
    ``head_payload`` carries the always-trained personalisation head.
    mode='jvp' (per-iteration): ``jvps`` carries the K scalars; the seed ref
    (round_idx, seed_id) is all the server needs to rebuild the gradient.

    ``base_version`` is the async staleness tag: the server model version
    this update was computed against (None on synchronous frames; the
    header field is only written when set, keeping sync frames byte-stable).
    """
    round_idx: int
    client_id: int
    seed_id: int
    mode: str                                      # 'delta' | 'jvp'
    wire: str = "fp32"
    unit_payload: Optional[Dict[int, list]] = None  # unit id -> [np arrays]
    head_payload: Optional[list] = None             # [np arrays] or None
    jvps: Optional[np.ndarray] = None               # (K,) in wire dtype
    loss: float = float("nan")                      # telemetry, not payload
    base_version: Optional[int] = None              # async round tag
    _encoded: Optional[bytes] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- construction from in-process trees ---------------------------------

    @classmethod
    def from_delta(cls, delta_tree, index, unit_ids, *, round_idx, client_id,
                   seed_id, wire="fp32", loss=float("nan"),
                   include_head=True) -> "ClientUpdate":
        """Extract the masked slices of a peft-shaped delta tree (torch
        tensors or numpy arrays, fp32).

        Only the leaves of the client's assigned ``unit_ids`` (plus the head)
        are packed — the rest of the tree is exactly zero by construction
        (the estimator masks the gradient), so the wire payload is lossless
        at fp32.
        """
        dt = wire_dtype(wire)
        unit_payload: Dict[int, list] = {}
        for uid in np.asarray(unit_ids, np.int64).tolist():
            group, target, layer = index.units[uid]
            leaves = tree_leaves(delta_tree[group][target])
            sel = [to_wire(l[layer] if layer >= 0 else l, dt) for l in leaves]
            unit_payload[int(uid)] = sel
        head_payload = None
        if include_head and "head" in delta_tree:
            head_payload = [to_wire(l, dt)
                            for l in tree_leaves(delta_tree["head"])]
        return cls(round_idx=round_idx, client_id=client_id, seed_id=seed_id,
                   mode="delta", wire=wire, unit_payload=unit_payload,
                   head_payload=head_payload, loss=loss)

    @classmethod
    def from_jvps(cls, jvps, *, round_idx, client_id, seed_id, wire="fp32",
                  loss=float("nan")) -> "ClientUpdate":
        return cls(round_idx=round_idx, client_id=client_id, seed_id=seed_id,
                   mode="jvp", wire=wire, jvps=to_wire(jvps, wire_dtype(wire)),
                   loss=loss)

    def to_delta(self, peft_template, index):
        """Expand the payload back into a peft-shaped fp32 torch tree on the
        template's device (zeros outside the assigned units). fp32 wire
        round-trips bit-exactly."""
        leaves = tree_leaves(peft_template)
        out = [np.zeros(tuple(l.shape), np.float32) for l in leaves]
        # flat positions through the same tree structure, so a subtree's
        # leaves map to indices without relying on leaf identity
        pos_tree = tree_unflatten_like(peft_template, list(range(len(leaves))))

        for uid, bufs in (self.unit_payload or {}).items():
            group, target, layer = index.units[int(uid)]
            for li, buf in zip(tree_leaves(pos_tree[group][target]), bufs):
                if layer >= 0:
                    out[li][layer] = as_float(buf)
                else:
                    out[li][...] = as_float(buf)
        if self.head_payload is not None and "head" in peft_template:
            for li, buf in zip(tree_leaves(pos_tree["head"]),
                               self.head_payload):
                out[li][...] = as_float(buf)
        return tree_unflatten_like(peft_template, [
            torch.from_numpy(o).to(l.device) for o, l in zip(out, leaves)])

    # -- serialization ------------------------------------------------------

    def _payload_buffers(self):
        bufs, layout = [], []
        if self.mode == "delta":
            for uid in sorted(self.unit_payload or {}):
                arrs = self.unit_payload[uid]
                layout.append({"unit": int(uid), "n": len(arrs)})
                bufs.extend(arrs)
            if self.head_payload is not None:
                layout.append({"unit": -1, "n": len(self.head_payload)})
                bufs.extend(self.head_payload)
        else:
            layout.append({"unit": -2, "n": 1})
            bufs.append(np.asarray(self.jvps))
        return bufs, layout

    def _encode(self) -> bytes:
        bufs, layout = self._payload_buffers()
        meta, raw = _encode_buffers(bufs)
        header = {
            "round_idx": int(self.round_idx),
            "client_id": int(self.client_id),
            "seed_id": int(self.seed_id),
            "mode": self.mode,
            "wire": self.wire,
            "layout": layout,
            "buffers": meta,
        }
        if self.base_version is not None:
            header["base_version"] = int(self.base_version)
        # loss telemetry rides as a FIXED 4-byte trailer (a json float field
        # would make the frame size value-dependent, breaking the shape-only
        # byte accounting the engine's streamed estimate relies on); the CRC
        # seals it along with the rest of the body
        trailer = np.float32(self.loss).tobytes()
        return _frame(MAGIC_UPDATE, header, raw, trailer)

    def to_bytes(self) -> bytes:
        if self._encoded is None:
            self._encoded = self._encode()
        return self._encoded

    def invalidate_encoding(self) -> None:
        """Drop the memoized frame after mutating fields in place (the
        engine's poison path mutates payloads post-construction)."""
        self._encoded = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "ClientUpdate":
        header, raw, trailer = _unframe(MAGIC_UPDATE, data, trailer_len=4)
        loss = float(np.frombuffer(trailer, np.float32)[0])
        try:
            bufs = _decode_buffers(header["buffers"], raw)
            bv = header.get("base_version")
            out = cls(round_idx=int(header["round_idx"]),
                      client_id=int(header["client_id"]),
                      seed_id=int(header["seed_id"]), mode=header["mode"],
                      wire=header["wire"], loss=loss,
                      base_version=None if bv is None else int(bv))
            layout = header["layout"]
        except (KeyError, TypeError, ValueError) as e:
            raise WireError("shape_mismatch", f"bad update header: {e}")
        if out.mode not in ("delta", "jvp"):
            raise WireError("shape_mismatch", f"unknown mode {out.mode!r}")
        off = 0
        if out.mode == "delta":
            out.unit_payload = {}
            try:
                for entry in layout:
                    chunk = bufs[off:off + entry["n"]]
                    off += entry["n"]
                    if entry["unit"] == -1:
                        out.head_payload = chunk
                    else:
                        out.unit_payload[int(entry["unit"])] = chunk
            except (KeyError, TypeError, ValueError) as e:
                raise WireError("shape_mismatch", f"bad layout: {e}")
        else:
            if len(bufs) != 1:
                raise WireError("shape_mismatch",
                                f"jvp update carries {len(bufs)} buffers")
            out.jvps = bufs[0]
        # CRC-verified: the received bytes are exactly the sealed frame
        out._encoded = bytes(data)
        return out

    # -- accounting ---------------------------------------------------------

    def byte_size(self) -> int:
        """Total measured frame size (header + payload)."""
        return len(self.to_bytes())

    def payload_byte_size(self, include_head: bool = True) -> int:
        """Raw payload bytes only (no framing/header overhead) — the number
        the Table-2 analytic parameter counts predict."""
        bufs, layout = self._payload_buffers()
        total = 0
        off = 0
        for entry in layout:
            chunk = bufs[off:off + entry["n"]]
            off += entry["n"]
            if entry["unit"] == -1 and not include_head:
                continue
            total += sum(np.asarray(b).nbytes for b in chunk)
        return total

    def n_payload_scalars(self, include_head: bool = True) -> int:
        bufs, layout = self._payload_buffers()
        total = 0
        off = 0
        for entry in layout:
            chunk = bufs[off:off + entry["n"]]
            off += entry["n"]
            if entry["unit"] == -1 and not include_head:
                continue
            total += sum(int(np.asarray(b).size) for b in chunk)
        return total
