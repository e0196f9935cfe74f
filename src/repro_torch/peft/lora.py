"""PEFT parameter trees: LoRA on the target projections plus the
classifier head. Port of the ``lora`` and ``head`` paths of
``repro/peft/lora.py``:

    peft = {
      "layers":     {target: {"A": (L, din, r), "B": (L, r, dout)}},   # stacked
      "enc_layers": {...},                  # whisper's encoder (stacked)
      "shared":     {target: {"A": (din, r), "B": (r, dout)}},         # zamba2
      "head":       {"w": (D, C), "b": (C,)},   # trained by ALL clients
    }

Only this tree is trainable / perturbed / communicated; it is passed
functionally (a dict of fp32 tensors), so the loss is a function of it
alone.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


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


def init_peft(cfg, gen, spry_cfg):
    """LoRA pairs (A LeCun-normal, B zero: identity at init) on each target
    of every layer of each ``peft_layer_groups`` group (whisper's encoder
    too), one unstacked pair set on the hybrid family's shared attention
    block (``wq``, ``wv``), plus the classifier head, drawn from
    ``gen``. Only ``spry_cfg.peft == "lora"`` is ported; the reference's
    ia3, bitfit and classifier_only trees raise here."""
    if spry_cfg.peft != "lora":
        raise NotImplementedError(
            f"peft {spry_cfg.peft!r} is not ported to repro_torch yet (lora "
            f"only); run it with the JAX package")
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
    if cfg.n_classes:
        peft["head"] = {
            "w": dense_init(gen, (cfg.d_model, cfg.n_classes)),
            "b": torch.zeros((cfg.n_classes,), device=gen.device),
        }
    return peft
