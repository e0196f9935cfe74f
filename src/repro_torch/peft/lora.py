"""PEFT parameter trees: LoRA on the target projections plus the
classifier head. Port of the ``lora`` and ``head`` paths of
``repro/peft/lora.py``:

    peft = {
      "layers": {target: {"A": (L, din, r), "B": (L, r, dout)}},   # stacked
      "head":   {"w": (D, C), "b": (C,)},   # trained by ALL clients
    }

Only this tree is trainable / perturbed / communicated; it is passed
functionally (a dict of fp32 tensors), so the loss is a function of it
alone.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def target_dims(cfg, target: str):
    """(din, dout) of the matrix a LoRA pair adapts."""
    d, hd = cfg.d_model, cfg.hd
    table = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "wi": (d, cfg.d_ff),
        "wg": (d, cfg.d_ff),
        "wd": (cfg.d_ff, d),
    }
    return table[target]


def init_peft(cfg, gen, spry_cfg):
    """LoRA pairs (A LeCun-normal, B zero: identity at init) on each target
    of every layer, plus the classifier head, drawn from ``gen``."""
    r, L = spry_cfg.lora_rank, cfg.n_layers
    layers = {}
    for t in spry_cfg.lora_targets:
        din, dout = target_dims(cfg, t)
        layers[t] = {
            "A": dense_init(gen, (L, din, r)),
            "B": torch.zeros((L, r, dout), device=gen.device),
        }
    peft = {"layers": layers}
    if cfg.n_classes:
        peft["head"] = {
            "w": dense_init(gen, (cfg.d_model, cfg.n_classes)),
            "b": torch.zeros((cfg.n_classes,), device=gen.device),
        }
    return peft
