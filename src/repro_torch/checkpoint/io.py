"""Minimal npz-based pytree checkpointing (model params + server state).

Port of ``repro/checkpoint/io.py``, in the reference's file format. Keys
are '/'-joined tree paths (dict keys, NamedTuple fields by name, sequence
indices); structure is reconstructed on load from the template tree.

  * Python-int leaves (``SpryState.round_idx``, ``ServerState.count``) are
    written as 0-d int32, the reference's dtype, so an fp32 state has the
    reference's key set and content hash.
  * bf16 tensors are written as the reference writes them: raw 2-byte
    values (numpy ``V2``, the bf16 bit patterns), and read back to
    ``torch.bfloat16`` bit for bit.
  * A restored leaf goes to the template leaf's device and dtype.

``save_pytree`` is ATOMIC: the npz is written to a same-directory ``*.tmp``
file, fsync'd, and ``os.replace``d into place, so a crash mid-write can
never leave a torn checkpoint at the target path. ``load_pytree`` is
STRICT: the stored key set must match the template's exactly (missing or
extra keys raise ``CheckpointError`` up front).
"""
from __future__ import annotations

import os

import numpy as np
import torch

BF16 = np.dtype("V2")      # bf16 bit patterns, as the reference stores them


class CheckpointError(ValueError):
    """A checkpoint that cannot be restored into the given template."""


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's leaf order: dict keys sorted,
    NamedTuple fields and sequence items in order; None is an empty
    subtree."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f in tree._fields for p in _paths(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _paths(x, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view(BF16)
        return leaf.numpy()
    if isinstance(leaf, (bool, int, np.integer)) and np.ndim(leaf) == 0:
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten_with_paths(tree):
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _restore(arr: np.ndarray, leaf):
    """One stored array in the template leaf's type, device and dtype."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype == BF16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, np.integer)) and np.ndim(leaf) == 0:
        return type(leaf)(arr)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _rebuild(like, leaves):
    """``like``'s structure with its leaves replaced in ``_paths`` order."""
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), leaves) for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


def _fsync_dir(dirpath: str) -> None:
    """Durably record the directory entry (rename) itself."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover - platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_flat(path: str, flat) -> None:
    path = path if path.endswith(".npz") else path + ".npz"
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    # np.savez appends .npz to *names* but writes file OBJECTS verbatim, so
    # handing it an open handle keeps the tmp path under our control
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def save_pytree(path: str, tree) -> None:
    """Atomically write ``tree`` to ``path`` (npz). tmp + fsync + rename."""
    _save_flat(path, _flatten_with_paths(tree))


def _read_flat(path: str, like):
    """The stored arrays by key, checked against the template's key set
    and leaf shapes (strict: a renamed field, a missing leaf, or a stale
    extra leaf fails BEFORE any leaf is restored)."""
    keyed = _paths(like)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        want = {k for k, _ in keyed}
        have = set(data.files)
        if want != have:
            missing, extra = sorted(want - have), sorted(have - want)
            raise CheckpointError(
                f"checkpoint/template key mismatch: missing {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}, extra {extra[:5]}"
                f"{'...' if len(extra) > 5 else ''}")
        arrays = {}
        for key, leaf in keyed:
            arr = arrays[key] = data[key]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise CheckpointError(f"shape mismatch for {key}: {arr.shape} vs "
                                      f"{tuple(np.shape(leaf))}")
    return arrays


def _restore_flat(like, arrays):
    return _rebuild(like, iter([_restore(arrays[key], leaf)
                                for key, leaf in _paths(like)]))


def load_pytree(path: str, like):
    """Load arrays saved by ``save_pytree`` (or the reference's) into the
    structure of ``like``: each leaf in the template leaf's type, device
    and dtype."""
    return _restore_flat(like, _read_flat(path, like))
