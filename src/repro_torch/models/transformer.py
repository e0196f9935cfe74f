"""Decoder-only transformer stack (dense family).

Port of ``repro/models/transformer.py``: ``init_base``, ``embed_tokens``,
``unembed`` and the train ``forward``. The reference's ``lax.scan`` over
stacked layers becomes a plain loop over layer slices of the same stacked
tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    layer_slice,
    norm_params,
    rope_tables_for,
)
from repro_torch.models.mlp import mlp_block, mlp_params


def init_base(cfg, gen):
    """Frozen base weights as a dict of per-layer-stacked tensors, drawn
    from ``gen`` on its device."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    layers = {
        "attn": attn.attn_params(cfg, gen, layers=L),
        "ln1": norm_params(cfg, d, layers=L, device=gen.device),
        "ln2": norm_params(cfg, d, layers=L, device=gen.device),
        "mlp": mlp_params(cfg, gen, layers=L),
    }
    base = {
        "embed": dense_init(gen, (V, d), in_axis=-1, dtype=cfg.dtype),
        "layers": layers,
        "final_norm": norm_params(cfg, d, device=gen.device),
    }
    if not cfg.tie_embeddings:
        base["lm_head"] = dense_init(gen, (d, V), dtype=cfg.dtype)
    return base


def embed_tokens(cfg, base, tokens):
    h = base["embed"][tokens.long()]
    if cfg.tie_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def unembed(cfg, base):
    return base["embed"].T if cfg.tie_embeddings else base["lm_head"]


def forward(cfg, base, peft, tokens, lora_scale=1.0):
    """Train forward -> (hidden (B,S,D), aux_loss). One loop over layers;
    every layer applies the reference layer body's ops in the same order."""
    h = embed_tokens(cfg, base, tokens)
    peft_layers = (peft or {}).get("layers", {})
    rope_cs = rope_tables_for(cfg, h)
    for i in range(cfg.n_layers):
        lp = layer_slice(base["layers"], i)
        pl = layer_slice(peft_layers, i) or None
        hn = apply_norm(cfg, h, lp["ln1"])
        h = h + attn.attn_block_prefill(cfg, lp["attn"], hn, pl, lora_scale,
                                        is_global=cfg.is_global_layer(i),
                                        rope_cs=rope_cs)
        hn = apply_norm(cfg, h, lp["ln2"])
        h = h + mlp_block(cfg, lp["mlp"], hn, pl, lora_scale)
    h = apply_norm(cfg, h, base["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)
