"""Gated MLP (GeGLU / SwiGLU) block. Port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init, maybe_lora, proj


def mlp_params(cfg, gen, layers=None):
    d, f = cfg.d_model, cfg.d_ff
    stack = (layers,) if layers else ()
    p = {
        "wi": dense_init(gen, stack + (d, f), dtype=cfg.dtype),
        "wg": dense_init(gen, stack + (d, f), dtype=cfg.dtype),
        "wd": dense_init(gen, stack + (f, d), dtype=cfg.dtype),
    }
    if cfg.use_bias:
        p["wi_b"] = torch.zeros(stack + (f,), dtype=cfg.dtype, device=gen.device)
        p["wd_b"] = torch.zeros(stack + (d,), dtype=cfg.dtype, device=gen.device)
    return p


def mlp_block(cfg, p, x, peft_layer=None, lora_scale=1.0):
    up = proj(x, p["wi"], p.get("wi_b"), maybe_lora(peft_layer, "wi"), lora_scale)
    gate = proj(x, p["wg"], None, maybe_lora(peft_layer, "wg"), lora_scale)
    h = activation(cfg, gate) * up
    if peft_layer is not None and "ia3_ff" in peft_layer:   # IA3 on the gated hidden
        h = h * peft_layer["ia3_ff"]["s"].to(h.dtype)
    return proj(h, p["wd"], p.get("wd_b"), maybe_lora(peft_layer, "wd"), lora_scale)
