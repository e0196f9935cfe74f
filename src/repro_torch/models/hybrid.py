"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block
(its weights reused at every application) after every
``cfg.hybrid_attn_every``-th layer.

Port of the training half of ``repro/models/hybrid.py``: ``init_base``,
``embed_tokens``, ``unembed``, the train ``forward`` and its split pieces
(``split_site``, ``mixer_site``, ``split_forward``, ``split_post``). The
reference's ``lax.scan`` over stacked layers becomes a plain loop over
layer slices, and its ``lax.cond`` on the layer index a plain ``if``.
Serving (``forward_scanned``, ``init_cache``, ``prefill``, ``decode_step``)
comes with the serving slice.
"""
from __future__ import annotations

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
from repro_torch.models.ssm import (
    mamba2_finish,
    mamba2_mix,
    mamba2_mixer_site,
    mamba2_params,
    mamba2_preamble,
)


def init_base(cfg, gen):
    """Frozen base weights drawn from ``gen`` on its device."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    dev = gen.device
    return {
        "embed": dense_init(gen, (V, d), in_axis=-1, dtype=cfg.dtype),
        "layers": {
            "mix": mamba2_params(cfg, gen, layers=L),
            "ln1": norm_params(cfg, d, layers=L, device=dev),
        },
        "shared": {
            "attn": attn.attn_params(cfg, gen),
            "mlp": mlp_params(cfg, gen),
            "ln1": norm_params(cfg, d, device=dev),
            "ln2": norm_params(cfg, d, device=dev),
        },
        "final_norm": norm_params(cfg, d, device=dev),
        "lm_head": dense_init(gen, (d, V), dtype=cfg.dtype),
    }


def embed_tokens(cfg, base, tokens):
    return base["embed"][tokens.long()]


def unembed(cfg, base):
    return base["lm_head"]


def _shared_block_prefill(cfg, shared, shared_peft, h, lora_scale, rope_cs=None):
    hn = apply_norm(cfg, h, shared["ln1"])
    h = h + attn.attn_block_prefill(cfg, shared["attn"], hn, shared_peft,
                                    lora_scale, is_global=False, rope_cs=rope_cs)
    hn = apply_norm(cfg, h, shared["ln2"])
    return h + mlp_block(cfg, shared["mlp"], hn)


def _peft_parts(peft):
    return (peft or {}).get("layers", {}), (peft or {}).get("shared") or None


def _layer(cfg, base, peft_layers, shared_peft, lora_scale, rope_cs, h, i):
    """One full hybrid layer: the mamba2 mixer, then the shared block when
    layer i is an application site."""
    lp = layer_slice(base["layers"], i)
    pl = layer_slice(peft_layers, i) or None
    hn = apply_norm(cfg, h, lp["ln1"])
    h = h + mamba2_mix(cfg, lp["mix"], hn, pl, lora_scale)[0]
    every = cfg.hybrid_attn_every
    if i % every == every - 1:
        h = _shared_block_prefill(cfg, base["shared"], shared_peft, h,
                                  lora_scale, rope_cs)
    return h


def forward(cfg, base, peft, tokens, lora_scale=1.0):
    """Train forward -> (hidden (B,S,D), aux), as the split composition
    ``split_forward`` -> ``mixer_site`` -> ``split_post`` (L-1 layers in a
    loop, the final one unrolled around its LAST mixer): the registry's
    split losses run exactly these ops."""
    site_args, ctx = split_forward(cfg, base, peft, tokens, lora_scale=lora_scale)
    y = mixer_site(cfg, site_args)
    return split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def _final_is_attn(cfg) -> bool:
    """True when the final layer ends with the shared attention block (its
    mixer is then the swa site); otherwise the mamba2 recurrence is."""
    every = cfg.hybrid_attn_every
    return ((cfg.n_layers - 1) % every) == (every - 1)


def split_site(cfg):
    if _final_is_attn(cfg):
        return "swa", {"window": cfg.window}
    return "mamba2", {}


def mixer_site(cfg, site_args):
    """The final layer's last mixer on the split site args (region-gated,
    see ``attention.swa_mixer_site`` / ``ssm.mamba2_mixer_site``)."""
    if _final_is_attn(cfg):
        return attn.swa_mixer_site(cfg, site_args, cfg.window)
    return mamba2_mixer_site(site_args)


def split_forward(cfg, base, peft, tokens, lora_scale=1.0):
    """First L-1 layers, then the final layer up to its LAST mixer: the
    shared attention block when the final layer is an application site
    (site_args (q, k, v) in kernel layout, ctx {"h"}), the mamba2
    recurrence otherwise (site_args (xh * dt, bmat, cmat, decay), ctx
    {"h", "z", "xh"})."""
    h = embed_tokens(cfg, base, tokens)
    peft_layers, shared_peft = _peft_parts(peft)
    rope_cs = rope_tables_for(cfg, h)
    L = cfg.n_layers
    for i in range(L - 1):
        h = _layer(cfg, base, peft_layers, shared_peft, lora_scale, rope_cs, h, i)
    lp = layer_slice(base["layers"], L - 1)
    pl = layer_slice(peft_layers, L - 1) or None
    hn = apply_norm(cfg, h, lp["ln1"])
    if _final_is_attn(cfg):
        h = h + mamba2_mix(cfg, lp["mix"], hn, pl, lora_scale)[0]
        hn = apply_norm(cfg, h, base["shared"]["ln1"])
        q, k, v = attn.attn_site_qkv(cfg, base["shared"]["attn"], hn, shared_peft,
                                     lora_scale, rope_cs=rope_cs)
        return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), {"h": h}
    xh, dt, bmat, cmat, decay, z, _ = mamba2_preamble(cfg, lp["mix"], hn, pl,
                                                      lora_scale)
    return (xh * dt[..., None], bmat, cmat, decay), {"h": h, "z": z, "xh": xh}


def split_post(cfg, base, y, ctx, peft, lora_scale=1.0):
    """Post-head: final mixer output -> (final hidden, aux). The fused
    estimator reverses it once."""
    peft_layers, shared_peft = _peft_parts(peft)
    h = ctx["h"]
    if _final_is_attn(cfg):
        shared = base["shared"]
        h = h + attn.attn_finish(cfg, shared["attn"], y.transpose(1, 2),
                                 shared_peft, lora_scale)
        hn = apply_norm(cfg, h, shared["ln2"])
        h = h + mlp_block(cfg, shared["mlp"], hn)
    else:
        L = cfg.n_layers
        lp = layer_slice(base["layers"], L - 1)
        pl = layer_slice(peft_layers, L - 1) or None
        h = h + mamba2_finish(cfg, lp["mix"], y, ctx["z"], ctx["xh"], h.dtype,
                              pl, lora_scale)
    h = apply_norm(cfg, h, base["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)
