"""Carry the reference package's weights into the port.

``from_reference(cfg, base_np, peft_np, device)`` takes the JAX package's
``base`` and ``peft`` trees as nested dicts of numpy arrays (per-layer
leaves stacked under a leading L axis, as the reference keeps them) and
returns the port's trees on ``device`` (required: the port never picks a
device for the caller); ``peft_from_reference(cfg, peft_np, device)`` does
the same for one PEFT tree alone (a served client's adapter). Both packages
use the same tree layout and leaf names, so this is a dtype-preserving copy
(bf16 leaves stay bf16, a MoE router fp32); it checks the stacked depth of
the decoder's ``layers`` against ``cfg.n_layers`` and of whisper's
``enc_layers`` against ``cfg.encoder_layers``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map, tree_paths


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # the reference's numpy bfloat16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _convert(cfg, what, tree_np, device):
    tree = tree_map(lambda a: _to_torch(a, device), tree_np)
    for group, depth in (("layers", cfg.n_layers), ("enc_layers", cfg.encoder_layers)):
        for path, leaf in tree_paths(tree.get(group, {})):
            if leaf.shape[0] != depth:
                raise ValueError(f"{what} {group}/{'/'.join(path)} has depth "
                                 f"{leaf.shape[0]}, config has {depth}")
    return tree


def peft_from_reference(cfg, peft_np, device):
    return _convert(cfg, "peft", peft_np, device)


def from_reference(cfg, base_np, peft_np, device):
    return (_convert(cfg, "base", base_np, device),
            peft_from_reference(cfg, peft_np, device))
