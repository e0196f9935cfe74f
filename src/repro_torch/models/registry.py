"""Family registry and task losses. Port of the dense entries of
``repro/models/registry.py``.

    model = get_model(cfg)
    base  = model.init_base(cfg, gen)
    h,aux = model.forward(cfg, base, peft, batch)
    loss  = lm_loss(cfg, base, peft, batch) / cls_loss(...)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.common import chunked_lm_loss, classification_loss


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_base: Callable
    forward: Callable          # (cfg, base, peft, batch) -> (hidden, aux)
    unembed: Callable


def _tf_forward(cfg, base, peft, batch, lora_scale=1.0):
    return transformer.forward(cfg, base, peft, batch["tokens"],
                               lora_scale=lora_scale)


_FAMILIES = {
    "dense": ModelFns(transformer.init_base, _tf_forward, transformer.unembed),
}


def get_model(cfg) -> ModelFns:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return _FAMILIES[cfg.family]


def lm_loss(cfg, base, peft, batch, lora_scale=1.0):
    """Causal-LM next-token loss (targets rolled left, last position
    invalid)."""
    model = get_model(cfg)
    h, aux = model.forward(cfg, base, peft, batch, lora_scale=lora_scale)
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones(targets.shape, dtype=torch.float32, device=h.device)
    valid[:, -1] = 0.0
    loss = chunked_lm_loss(h, model.unembed(cfg, base), targets, valid)
    return loss + 0.01 * aux


def cls_loss(cfg, base, peft, batch, lora_scale=1.0):
    """Sequence-classification loss with the trainable ``peft['head']``."""
    model = get_model(cfg)
    h, aux = model.forward(cfg, base, peft, batch, lora_scale=lora_scale)
    loss, _ = classification_loss(h, peft["head"], batch["labels"])
    return loss + 0.01 * aux


def cls_logits(cfg, base, peft, batch, lora_scale=1.0):
    model = get_model(cfg)
    h, _ = model.forward(cfg, base, peft, batch, lora_scale=lora_scale)
    return h[:, -1, :].float() @ peft["head"]["w"] + peft["head"]["b"]


def get_loss_fn(task: str):
    return {"lm": lm_loss, "cls": cls_loss}[task]
