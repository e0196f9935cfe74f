"""Crash-safe checkpointing: manifests, content hashes, resume.

Port of ``repro/checkpoint/manifest.py``: the same files, the same
manifest schema and the same content hash of an fp32 state, so a
checkpoint written by either package loads in the other.

A checkpoint is TWO files written in a strict order:

    state_<round>.npz      the pytree (atomic: tmp + fsync + os.replace)
    manifest.json          round idx, algorithm seed, host-RNG state,
                           metric history, a sha256 CONTENT hash of the
                           state tree, and the state filename — also
                           written atomically, and always LAST.

Because the manifest is replaced last, a crash at any instant leaves
``manifest.json`` pointing at a complete, hash-verified state file: either
the previous round's (the new state landed but the manifest didn't — the
round is simply re-run on resume) or the new one. The npz itself is never
byte-compared (zip members embed timestamps); integrity and the
kill-and-resume bitwise test both go through ``tree_content_hash``, which
hashes the sorted (key, dtype, shape, bytes) leaves — the actual numbers.

Determinism on resume comes from the manifest carrying everything the
training loop consumes host-side: the round index (the round key is
``fold_in(seed, round_idx)`` and every perturbation is drawn from a
generator seeded per key), the algorithm seed, and — for the in-process
path — the numpy Generator's ``bit_generator.state`` dict.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.io import (
    BF16,
    CheckpointError,
    _flatten_with_paths,
    _fsync_dir,
    _read_flat,
    _restore_flat,
    _save_flat,
)

MANIFEST_SCHEMA = "repro.checkpoint/v1"
MANIFEST_NAME = "manifest.json"


def _hash_flat(flat) -> str:
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(key.encode())
        # a bf16 leaf hashes under the reference's in-memory dtype string
        h.update(b"<V2" if arr.dtype == BF16 else arr.dtype.str.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.reshape(-1).view(np.uint8))     # the bytes, uncopied
    return h.hexdigest()


def tree_content_hash(tree) -> str:
    """sha256 over the tree's sorted (key, dtype, shape, bytes) leaves —
    a pure content identity, independent of npz container timestamps."""
    return _hash_flat(_flatten_with_paths(tree))


@dataclasses.dataclass
class RunManifest:
    """Everything resume needs to replay the trajectory bit-identically."""
    round_idx: int                   # rounds COMPLETED (resume starts here)
    algo_seed: int
    content_hash: str
    state_file: str                  # npz filename, relative to the dir
    rng_state: Optional[Dict[str, Any]] = None  # np bit_generator.state
    history: List[dict] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema: str = MANIFEST_SCHEMA

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True,
                          default=float)

    @classmethod
    def from_json(cls, text: str) -> "RunManifest":
        doc = json.loads(text)
        if doc.get("schema") != MANIFEST_SCHEMA:
            raise CheckpointError(
                f"unknown manifest schema {doc.get('schema')!r} "
                f"(want {MANIFEST_SCHEMA})")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - fields
        if unknown:
            raise CheckpointError(f"unknown manifest keys {sorted(unknown)}")
        return cls(**doc)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def write_manifest(ckpt_dir: str, manifest: RunManifest) -> str:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    _atomic_write_text(path, manifest.to_json())
    return path


def read_manifest(ckpt_dir: str) -> RunManifest:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            return RunManifest.from_json(f.read())
    except OSError as e:
        raise CheckpointError(f"no manifest at {path} ({e})")


def _gc(ckpt_dir: str, current_state: str, keep_last: int) -> None:
    """Drop all but the newest ``keep_last`` state files; never the one the
    manifest points at."""
    states = sorted(f for f in os.listdir(ckpt_dir)
                    if f.startswith("state_") and f.endswith(".npz"))
    for f in states[:-keep_last] if keep_last > 0 else []:
        if f != current_state:
            try:
                os.remove(os.path.join(ckpt_dir, f))
            except OSError:  # pragma: no cover - best-effort cleanup
                pass


def save_checkpoint(ckpt_dir: str, state, *, round_idx: int, algo_seed: int,
                    rng_state: Optional[dict] = None,
                    history: Optional[list] = None,
                    extra: Optional[dict] = None,
                    keep_last: int = 2) -> RunManifest:
    """Write one crash-safe checkpoint: state npz FIRST, manifest LAST."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state_file = f"state_{int(round_idx):06d}.npz"
    flat = _flatten_with_paths(state)     # one device-to-host copy
    _save_flat(os.path.join(ckpt_dir, state_file), flat)
    content_hash = _hash_flat(flat)
    manifest = RunManifest(
        round_idx=int(round_idx), algo_seed=int(algo_seed),
        content_hash=content_hash, state_file=state_file,
        rng_state=rng_state, history=list(history or []),
        extra=dict(extra or {}))
    write_manifest(ckpt_dir, manifest)
    _gc(ckpt_dir, state_file, keep_last)
    return manifest


def load_checkpoint(ckpt_dir: str, like) -> Tuple[Any, RunManifest]:
    """Restore (state, manifest), verifying the state's content hash."""
    manifest = read_manifest(ckpt_dir)
    state_path = os.path.join(ckpt_dir, manifest.state_file)
    if not os.path.exists(state_path):
        raise CheckpointError(
            f"manifest points at missing state {manifest.state_file}")
    arrays = _read_flat(state_path, like)
    got = _hash_flat(arrays)
    if got != manifest.content_hash:
        raise CheckpointError(
            f"state content hash {got[:12]} != manifest "
            f"{manifest.content_hash[:12]} — corrupt or tampered checkpoint")
    return _restore_flat(like, arrays), manifest
