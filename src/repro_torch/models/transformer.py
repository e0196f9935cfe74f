"""Decoder-only transformer stack (dense family).

Port of ``repro/models/transformer.py``: ``init_base``, ``embed_tokens``,
``unembed``, the train ``forward`` and its split pieces (``split_site``,
``mixer_site``, ``split_forward``, ``split_post``). The reference's
``lax.scan`` over stacked layers becomes a plain loop over layer slices of
the same stacked tensors.
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


def _layer_tail(cfg, h, lp, pl, lora_scale):
    """ln2 + MLP + residual: the back half of a layer once its attention
    output has been added to the residual."""
    hn = apply_norm(cfg, h, lp["ln2"])
    return h + mlp_block(cfg, lp["mlp"], hn, pl, lora_scale)


def _slices(base, peft, i):
    return (layer_slice(base["layers"], i),
            layer_slice((peft or {}).get("layers", {}), i) or None)


def forward(cfg, base, peft, tokens, lora_scale=1.0):
    """Train forward -> (hidden (B,S,D), aux_loss), as the split composition
    ``split_forward`` -> ``mixer_site`` -> ``split_post``: the first L-1
    layers in a loop, the final one unrolled around its attention mixer. The
    registry's split losses run exactly these pieces, so a ``SplitLoss`` and
    the plain loss compute the same ops (bitwise-equal values)."""
    site_args, ctx = split_forward(cfg, base, peft, tokens, lora_scale=lora_scale)
    y = mixer_site(cfg, site_args)
    return split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def split_site(cfg):
    """Site kind and static kwargs of the final layer's mixer."""
    is_global = bool(cfg.is_global_layer(cfg.n_layers - 1))
    return "swa", {"window": None if is_global else cfg.window}


def mixer_site(cfg, site_args):
    """The final layer's mixer on the split site args (region-gated, see
    ``attention.swa_mixer_site``)."""
    return attn.swa_mixer_site(cfg, site_args, split_site(cfg)[1]["window"])


def split_forward(cfg, base, peft, tokens, lora_scale=1.0):
    """First L-1 layers, then the final layer up to its attention mixer ->
    (site_args, ctx): site_args = (q, k, v) in kernel layout (B,H,S,hd) /
    (B,KV,S,hd), ctx = {"h": residual stream, "aux": aux loss}."""
    h = embed_tokens(cfg, base, tokens)
    rope_cs = rope_tables_for(cfg, h)
    for i in range(cfg.n_layers - 1):
        lp, pl = _slices(base, peft, i)
        hn = apply_norm(cfg, h, lp["ln1"])
        h = h + attn.attn_block_prefill(cfg, lp["attn"], hn, pl, lora_scale,
                                        is_global=cfg.is_global_layer(i),
                                        rope_cs=rope_cs)
        h = _layer_tail(cfg, h, lp, pl, lora_scale)
    lp, pl = _slices(base, peft, cfg.n_layers - 1)
    hn = apply_norm(cfg, h, lp["ln1"])
    q, k, v = attn.attn_site_qkv(cfg, lp["attn"], hn, pl, lora_scale,
                                 rope_cs=rope_cs)
    site_args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return site_args, {"h": h, "aux": torch.zeros((), dtype=torch.float32,
                                                   device=h.device)}


def split_post(cfg, base, y, ctx, peft, lora_scale=1.0):
    """Post-head: final mixer output (B,H,S,hd) -> (final hidden, aux).
    The fused estimator reverses it once."""
    lp, pl = _slices(base, peft, cfg.n_layers - 1)
    h = ctx["h"] + attn.attn_finish(cfg, lp["attn"], y.transpose(1, 2), pl,
                                    lora_scale)
    h = _layer_tail(cfg, h, lp, pl, lora_scale)
    h = apply_norm(cfg, h, base["final_norm"])
    return h, ctx["aux"] / cfg.n_layers
