"""Carry the reference package's weights into the port.

``from_reference(cfg, base_np, peft_np, device)`` takes the JAX package's
``base`` and ``peft`` trees as nested dicts of numpy arrays (per-layer
leaves stacked under a leading L axis, as the reference keeps them) and
returns the port's trees on ``device`` (required: the port never picks a
device for the caller). Both packages use the same tree
layout and leaf names, so this is a dtype-preserving copy (bf16 leaves
stay bf16); it checks the stacked depth against ``cfg``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map, tree_paths


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def from_reference(cfg, base_np, peft_np, device):
    base = tree_map(lambda a: _to_torch(a, device), base_np)
    peft = tree_map(lambda a: _to_torch(a, device), peft_np)
    for what, tree in (("base", base["layers"]), ("peft", peft.get("layers", {}))):
        for path, leaf in tree_paths(tree):
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(f"{what} layers/{'/'.join(path)} has depth "
                                 f"{leaf.shape[0]}, config has {cfg.n_layers}")
    return base, peft
