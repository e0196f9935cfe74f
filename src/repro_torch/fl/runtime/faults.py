"""Seeded, deterministic fault injection for the federation runtime.

Copy of ``repro/fl/runtime/faults.py`` (host-only numpy): for the same
seeds every decision equals the reference's.

The chaos harness perturbs a round at configurable rates with every failure
mode the wire-integrity layer and the engine's quarantine path are built to
survive:

  * client crash mid-epoch   — the update is computed but never sent (the
                               partial-work case: device died / app killed);
                               per-device-tier ``crash_scale`` multiplies
                               the base rate (iot boards die more often than
                               flagship phones).
  * frame corruption         — random bit flips in the serialized frame
                               (caught by the CRC32 seal).
  * frame truncation         — the uplink cut the frame short.
  * frame duplication        — at-least-once delivery: the same frame lands
                               twice; the engine must dedupe by seed_id.
  * transient uplink loss    — the send fails; the client retries with
                               exponential backoff up to ``max_retries``
                               attempts, then gives up (update lost).
  * NaN / blow-up payloads   — a numerically-poisoned update that passes
                               the CRC (the bytes are intact — the *values*
                               are garbage); the engine's defensive
                               validation must reject it before
                               aggregation.

Every draw is keyed by ``SeedSequence([seed, tag, client, round, attempt])``
— stateless per call, like ``population._rng`` — so a resumed run replays
the exact same fault schedule and the kill-and-resume bitwise test holds
under chaos. Injection happens at the byte level on already-serialized
frames (corruption) or at the value level before serialization (poison), so
the clean path never touches this module.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def _rng(*entropy) -> np.random.Generator:
    """Deterministic per-key generator (order-sensitive integer entropy)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(e) & 0x7FFFFFFF for e in entropy]))


# entropy tags so independent fault draws never collide on the same stream
_T_CRASH, _T_LOSS, _T_CORRUPT, _T_MODE, _T_POISON, _T_DUP = (
    0xC4A5, 0x1055, 0xC0FF, 0x30DE, 0xBAD0, 0xD0B1)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Rates and knobs for one chaos schedule. All rates are per-client
    per-round probabilities in [0, 1]; 0 everywhere = clean network."""
    crash_rate: float = 0.0       # update computed but never transmitted
    corrupt_rate: float = 0.0     # frame bit-flip / truncation / duplication
    loss_rate: float = 0.0        # per-attempt transient uplink loss
    nan_rate: float = 0.0         # payload poisoned with NaN/Inf
    blowup_rate: float = 0.0      # payload scaled into norm-outlier range
    max_retries: int = 3          # uplink attempts per frame (>= 1)
    backoff_base: float = 0.5     # seconds; attempt i waits base * 2**i
    blowup_scale: float = 1e6     # multiplier for blow-up poisoning
    seed: int = 0                 # chaos seed (independent of algo seed)

    def __post_init__(self):
        for name in ("crash_rate", "corrupt_rate", "loss_rate", "nan_rate",
                     "blowup_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} not in [0, 1]")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")

    @property
    def any_faults(self) -> bool:
        return any(getattr(self, n) > 0.0 for n in
                   ("crash_rate", "corrupt_rate", "loss_rate", "nan_rate",
                    "blowup_rate"))

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultConfig":
        """Parse a CLI spec: ``k=v,k=v`` over the field names, or the
        presets ``off`` / ``mild`` / ``aggressive``."""
        presets = {
            "off": {},
            "mild": {"crash_rate": 0.05, "corrupt_rate": 0.05,
                     "loss_rate": 0.05, "nan_rate": 0.02},
            "aggressive": {"crash_rate": 0.2, "corrupt_rate": 0.25,
                           "loss_rate": 0.25, "nan_rate": 0.1,
                           "blowup_rate": 0.1},
        }
        spec = (spec or "off").strip()
        if spec in presets:
            return cls(seed=seed, **presets[spec])
        kwargs = {}
        valid = {f.name for f in dataclasses.fields(cls)}
        for part in spec.split(","):
            if not part.strip():
                continue
            try:
                k, v = part.split("=", 1)
            except ValueError:
                raise ValueError(f"bad fault spec component {part!r} "
                                 f"(want k=v)")
            k = k.strip()
            if k not in valid:
                raise ValueError(f"unknown fault knob {k!r}; "
                                 f"valid: {sorted(valid)}")
            kwargs[k] = int(v) if k in ("max_retries", "seed") else float(v)
        kwargs.setdefault("seed", seed)
        return cls(**kwargs)


@dataclasses.dataclass
class FaultCounters:
    """Host-side tally of what the injector actually did (one round)."""
    crashed: int = 0
    corrupted: int = 0
    truncated: int = 0
    duplicated: int = 0
    lost: int = 0            # frames that exhausted every retry
    retries: int = 0         # extra attempts beyond the first
    poisoned_nan: int = 0
    poisoned_blowup: int = 0
    backoff_s: float = 0.0   # total simulated backoff latency

    def merge(self, other: "FaultCounters") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class FaultInjector:
    """Applies a ``FaultConfig`` deterministically per (client, round).

    The injector never mutates inputs in place; corrupted frames are new
    byte strings, poisoned payloads are new arrays. Methods are pure in
    (config.seed, client_id, round_idx[, attempt]) so replay — including a
    crash-resume replay — reproduces the identical fault schedule.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self.counters = FaultCounters()

    # -- client-side faults -------------------------------------------------

    def crashes(self, client_id: int, round_idx: int,
                scale: float = 1.0) -> bool:
        """Did this client die mid-epoch? ``scale`` is the device tier's
        crash multiplier; the effective rate is clipped to [0, 1]."""
        rate = min(1.0, self.config.crash_rate * float(scale))
        if rate <= 0.0:
            return False
        hit = _rng(self.config.seed, _T_CRASH, client_id,
                   round_idx).random() < rate
        if hit:
            self.counters.crashed += 1
        return hit

    def poison_mode(self, client_id: int,
                    round_idx: int) -> Optional[str]:
        """'nan' | 'blowup' | None — drawn once per (client, round)."""
        cfg = self.config
        if cfg.nan_rate <= 0.0 and cfg.blowup_rate <= 0.0:
            return None
        u = _rng(cfg.seed, _T_POISON, client_id, round_idx).random()
        if u < cfg.nan_rate:
            self.counters.poisoned_nan += 1
            return "nan"
        if u < cfg.nan_rate + cfg.blowup_rate:
            self.counters.poisoned_blowup += 1
            return "blowup"
        return None

    def poison_array(self, arr: np.ndarray, mode: str) -> np.ndarray:
        """Apply a poison mode to one payload array (new array)."""
        out = np.array(arr, copy=True)
        if out.size == 0 or not np.issubdtype(out.dtype, np.floating):
            return out
        if mode == "nan":
            flat = out.reshape(-1)
            flat[: max(1, flat.size // 8)] = np.nan
        elif mode == "blowup":
            out = out * out.dtype.type(self.config.blowup_scale)
            if not np.any(out):       # all-zero payload: force an outlier
                out.reshape(-1)[0] = out.dtype.type(
                    self.config.blowup_scale)
        else:
            raise ValueError(f"unknown poison mode {mode!r}")
        return out

    # -- wire-level faults --------------------------------------------------

    def _mangle(self, frame: bytes, rng: np.random.Generator) -> bytes:
        """Bit-flip or truncate one frame (never both; never a no-op)."""
        buf = bytearray(frame)
        if rng.random() < 0.5 and len(buf) > 1:
            cut = int(rng.integers(1, len(buf)))
            self.counters.truncated += 1
            return bytes(buf[:cut])
        n_flips = int(rng.integers(1, 9))
        for _ in range(n_flips):
            pos = int(rng.integers(0, len(buf)))
            bit = int(rng.integers(0, 8))
            buf[pos] ^= 1 << bit
        self.counters.corrupted += 1
        return bytes(buf)

    def transmit(self, frame: bytes, client_id: int,
                 round_idx: int) -> Tuple[List[bytes], int, float]:
        """Push one serialized frame through the chaotic uplink.

        Returns ``(delivered_frames, attempts, backoff_seconds)``:
        ``delivered_frames`` holds what the server actually receives — empty
        if every retry was lost, 2+ entries if the frame was duplicated,
        possibly mangled bytes if it was corrupted in flight. ``attempts``
        counts transmissions (for bytes-up accounting: every attempt burns
        uplink bytes, delivered or not). Deterministic in
        (seed, client, round, attempt).
        """
        cfg = self.config
        attempts = 0
        backoff = 0.0
        delivered: List[bytes] = []
        for attempt in range(cfg.max_retries):
            attempts += 1
            if attempt > 0:
                self.counters.retries += 1
                backoff += cfg.backoff_base * (2.0 ** (attempt - 1))
            lost = (cfg.loss_rate > 0.0 and
                    _rng(cfg.seed, _T_LOSS, client_id, round_idx,
                         attempt).random() < cfg.loss_rate)
            if lost:
                continue
            rng = _rng(cfg.seed, _T_CORRUPT, client_id, round_idx, attempt)
            out = frame
            if cfg.corrupt_rate > 0.0 and rng.random() < cfg.corrupt_rate:
                out = self._mangle(out, rng)
            delivered.append(out)
            if (cfg.corrupt_rate > 0.0 and
                    _rng(cfg.seed, _T_DUP, client_id, round_idx,
                         attempt).random() < cfg.corrupt_rate / 2.0):
                self.counters.duplicated += 1
                delivered.append(out)
            break
        if not delivered:
            self.counters.lost += 1
        self.counters.backoff_s += backoff
        return delivered, attempts, backoff

    # -- bookkeeping --------------------------------------------------------

    def take_counters(self) -> FaultCounters:
        """Return and reset the tally (one engine round)."""
        out = self.counters
        self.counters = FaultCounters()
        return out
