"""Family registry and task losses. Port of the dense and hybrid entries
of ``repro/models/registry.py``.

    model = get_model(cfg)
    base  = model.init_base(cfg, gen)
    h,aux = model.forward(cfg, base, peft, batch)
    loss  = lm_loss(cfg, base, peft, batch) / cls_loss(...)
    split = get_loss_fn(task, split=True)(cfg, base, batch)   # a SplitLoss
    cache = model.init_cache(cfg, batch, seq_len, device=dev)
    logits, cache = model.decode_step(cfg, base, peft, cache, token, pos)

Serving is ported for the dense family; the hybrid family's serving
functions raise ``NotImplementedError`` until its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models import hybrid, transformer
from repro_torch.models.common import chunked_lm_loss, classification_loss


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_base: Callable
    forward: Callable          # (cfg, base, peft, batch) -> (hidden, aux)
    unembed: Callable
    # split forward (the final layer unrolled up to its mixer, the fused
    # jvp-contraction site):
    #   split_forward (cfg, base, peft, batch, lora_scale) -> (site_args, ctx)
    #   split_post    (cfg, base, y, ctx, peft, batch, lora_scale) -> (h, aux)
    #   split_site    cfg -> (site kind, static site kwargs)
    #   mixer_site    (cfg, site_args) -> y
    # ``forward`` is the composition pre -> mixer_site -> post.
    split_forward: Optional[Callable] = None
    split_post: Optional[Callable] = None
    split_site: Optional[Callable] = None
    mixer_site: Optional[Callable] = None
    # serving:
    #   init_cache  (cfg, batch, seq_len, [kv_int8], device=) -> cache
    #   decode_step (cfg, base, peft, cache, token, pos) -> (logits, cache)
    #   prefill     (cfg, base, peft, cache, tokens) -> (last logits, cache)
    # each writes the cache in place and returns it
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None
    supports_kv_int8: bool = False       # init_cache accepts kv_int8=True


def _tf_forward(cfg, base, peft, batch, lora_scale=1.0):
    return transformer.forward(cfg, base, peft, batch["tokens"],
                               lora_scale=lora_scale)


def _tf_split_forward(cfg, base, peft, batch, lora_scale=1.0):
    return transformer.split_forward(cfg, base, peft, batch["tokens"],
                                     lora_scale=lora_scale)


def _tf_split_post(cfg, base, y, ctx, peft, batch, lora_scale=1.0):
    return transformer.split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def _hybrid_forward(cfg, base, peft, batch, lora_scale=1.0):
    return hybrid.forward(cfg, base, peft, batch["tokens"], lora_scale=lora_scale)


def _hybrid_split_forward(cfg, base, peft, batch, lora_scale=1.0):
    return hybrid.split_forward(cfg, base, peft, batch["tokens"],
                                lora_scale=lora_scale)


def _hybrid_split_post(cfg, base, y, ctx, peft, batch, lora_scale=1.0):
    return hybrid.split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def _hybrid_serving(name):
    def not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"hybrid.{name} is not ported yet (the hybrid-serving slice); "
            f"run it with python -m repro.launch.serve")
    return not_ported


_FAMILIES = {
    "dense": ModelFns(transformer.init_base, _tf_forward, transformer.unembed,
                      split_forward=_tf_split_forward,
                      split_post=_tf_split_post,
                      split_site=transformer.split_site,
                      mixer_site=transformer.mixer_site,
                      init_cache=transformer.init_cache,
                      decode_step=transformer.decode_step,
                      prefill=transformer.prefill, supports_kv_int8=True),
    "hybrid": ModelFns(hybrid.init_base, _hybrid_forward, hybrid.unembed,
                       split_forward=_hybrid_split_forward,
                       split_post=_hybrid_split_post,
                       split_site=hybrid.split_site,
                       mixer_site=hybrid.mixer_site,
                       init_cache=_hybrid_serving("init_cache"),
                       decode_step=_hybrid_serving("decode_step"),
                       prefill=_hybrid_serving("prefill")),
}


def get_model(cfg) -> ModelFns:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and hybrid only)")
    return _FAMILIES[cfg.family]


def _lm_head(cfg, base, model, h, aux, batch):
    """Causal-LM next-token loss (targets rolled left, last position
    invalid)."""
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones(targets.shape, dtype=torch.float32, device=h.device)
    valid[:, -1] = 0.0
    loss = chunked_lm_loss(h, model.unembed(cfg, base), targets, valid)
    return loss + 0.01 * aux


def lm_loss(cfg, base, peft, batch, lora_scale=1.0):
    model = get_model(cfg)
    h, aux = model.forward(cfg, base, peft, batch, lora_scale=lora_scale)
    return _lm_head(cfg, base, model, h, aux, batch)


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


def _split_loss(cfg, base, batch, head_fn, lora_scale):
    from repro_torch.core.forward_grad import SplitLoss
    model = get_model(cfg)
    kind, site_kwargs = model.split_site(cfg)

    def pre(p):
        return model.split_forward(cfg, base, p, batch, lora_scale=lora_scale)

    def post(y, ctx, p):
        h, aux = model.split_post(cfg, base, y, ctx, p, batch,
                                  lora_scale=lora_scale)
        return head_fn(model, h, aux, p)

    # the model's region-gated mixer as the site primal: the SplitLoss runs
    # exactly the ops of ``model.forward`` (= the plain loss)
    return SplitLoss(pre, kind, post,
                     site_fn=lambda args: model.mixer_site(cfg, args),
                     **site_kwargs)


def split_lm_loss(cfg, base, batch, lora_scale=1.0):
    """``lm_loss`` as a ``SplitLoss`` of the peft tree, bitwise equal to the
    plain loss; under ``fused_contraction=True`` its final attention site
    contracts the K tangent outputs in-kernel."""
    return _split_loss(cfg, base, batch,
                       lambda model, h, aux, p: _lm_head(cfg, base, model, h,
                                                         aux, batch),
                       lora_scale)


def split_cls_loss(cfg, base, batch, lora_scale=1.0):
    """``cls_loss`` as a ``SplitLoss`` (the trainable head is read from the
    peft tree inside the post-head)."""
    def head(model, h, aux, p):
        loss, _ = classification_loss(h, p["head"], batch["labels"])
        return loss + 0.01 * aux
    return _split_loss(cfg, base, batch, head, lora_scale)


def get_loss_fn(task: str, split: bool = False):
    """Plain loss closures ``loss(cfg, base, peft, batch, lora_scale)``, or
    with ``split=True`` the builders ``builder(cfg, base, batch,
    lora_scale) -> SplitLoss``."""
    if split:
        return {"lm": split_lm_loss, "cls": split_cls_loss}[task]
    return {"lm": lm_loss, "cls": cls_loss}[task]
