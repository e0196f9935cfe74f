"""PEFT parameter trees: LoRA (default), IA3, BitFit or the classifier
head alone (the paper's Appendix G ablation). Port of
``repro/peft/lora.py``:

    peft = {
      "layers":     {target: {"A": (L, din, r), "B": (L, r, dout)}},   # lora
                    {"ia3_kv": {"s": (L, KV*hd)}, "ia3_ff": {"s": (L, d_ff)}}  # ia3
                    {"bias1": {"b": (L, D)}, "bias2": {"b": (L, D)}}   # bitfit
      "enc_layers": {...},                  # whisper's encoder (stacked)
      "shared":     {target: {"A": (din, r), "B": (r, dout)}},  # zamba2, lora
      "head":       {"w": (D, C), "b": (C,)},   # trained by ALL clients
    }

``classifier_only`` keeps the head alone. IA3 scales k and v
(``attention.qkv``) and the gated MLP hidden (``mlp.mlp_block``); BitFit
adds its biases to the residual after attention and after the MLP in the
train forward (``transformer``), not in serving. A family whose forward
does not read a leaf leaves it at a zero estimate, as the reference does.

Only this tree is trainable / perturbed / communicated; it is passed
functionally (a dict of fp32 tensors), so the loss is a function of it
alone.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init
from repro_torch.utils.pytree import tree_leaves


def default_lora_targets(cfg):
    if cfg.family == "ssm":           # rwkv6 projections
        return ("wr", "wv")
    if cfg.family == "hybrid":        # mamba2 projections
        return ("in_proj", "out_proj")
    return ("wq", "wv")


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
        # rwkv6
        "wr": (d, d),
        # mamba2
        "in_proj": (d, 2 * (cfg.ssm.expand * d) if cfg.ssm else 2 * d),
        "out_proj": ((cfg.ssm.expand * d) if cfg.ssm else d, d),
    }
    if cfg.family == "ssm" and target in ("wk", "wv", "wo"):
        return (d, d)
    return table[target]


def peft_layer_groups(cfg):
    """(group name, n_layers) of each group of stacked per-layer PEFT
    parameters."""
    groups = [("layers", cfg.n_layers)]
    if cfg.encoder_layers:
        groups.append(("enc_layers", cfg.encoder_layers))
    return groups


def _lora_pair(gen, din, dout, r, stack=()):
    return {"A": dense_init(gen, stack + (din, r)),
            "B": torch.zeros(stack + (r, dout), device=gen.device)}


def _per_layer(kind, cfg, L, device):
    """One group's stacked IA3 scales (ones: identity at init) or BitFit
    biases (zeros)."""
    if kind == "ia3":
        return {"ia3_kv": {"s": torch.ones((L, cfg.n_kv_heads * cfg.hd), device=device)},
                "ia3_ff": {"s": torch.ones((L, cfg.d_ff), device=device)}}
    return {"bias1": {"b": torch.zeros((L, cfg.d_model), device=device)},
            "bias2": {"b": torch.zeros((L, cfg.d_model), device=device)}}


def init_peft(cfg, gen, spry_cfg):
    """The ``spry_cfg.peft`` tree on ``gen``'s device, plus the classifier
    head (LeCun-normal w, zero b) drawn from ``gen`` for every kind:

    - ``lora``: pairs (A LeCun-normal, B zero: identity at init) on each
      target of every layer of each ``peft_layer_groups`` group (whisper's
      encoder too), and one unstacked pair set on the hybrid family's
      shared attention block (``wq``, ``wv``);
    - ``ia3``: per-layer scales of k/v and of the MLP hidden, ones;
    - ``bitfit``: per-layer residual biases, zeros;
    - ``classifier_only``: the head alone.

    Any other kind raises ValueError."""
    kind = spry_cfg.peft
    peft = {}
    if kind == "lora":
        targets = spry_cfg.lora_targets or default_lora_targets(cfg)
        # for ssm/hybrid families, remap the generic defaults
        if cfg.family in ("ssm", "hybrid") and tuple(targets) == ("wq", "wv"):
            targets = default_lora_targets(cfg)
        r = spry_cfg.lora_rank
        peft = {group: {t: _lora_pair(gen, *target_dims(cfg, t), r, stack=(L,))
                        for t in targets}
                for group, L in peft_layer_groups(cfg)}
        if cfg.family == "hybrid":
            peft["shared"] = {t: _lora_pair(gen, *target_dims(cfg, t), r)
                              for t in ("wq", "wv")}
    elif kind in ("ia3", "bitfit"):
        peft = {group: _per_layer(kind, cfg, L, gen.device)
                for group, L in peft_layer_groups(cfg)}
    elif kind != "classifier_only":
        raise ValueError(f"unknown peft kind {kind!r}")
    if cfg.n_classes:
        peft["head"] = {
            "w": dense_init(gen, (cfg.d_model, cfg.n_classes)),
            "b": torch.zeros((cfg.n_classes,), device=gen.device),
        }
    return peft


def count_trainable(peft) -> int:
    """Number of trainable scalars in a PEFT tree."""
    return sum(leaf.numel() for leaf in tree_leaves(peft))
