"""RWKV6 ("Finch") full model stack: the attention-free ssm family.

Port of ``repro/models/rwkv_model.py``: ``init_base``, ``embed_tokens``,
``unembed``, the train ``forward`` and its split pieces (``split_site``,
``mixer_site``, ``split_forward``, ``split_post``), the one-loop
``forward_scanned`` (a test oracle, as in the reference), and serving
(``init_cache``, ``prefill``, ``decode_step``). The reference's ``lax.scan``
over stacked layers becomes a plain loop over layer slices.

Serving keeps an explicit state: each layer threads its WKV state and its
two token-shift rows through the plain recurrence (``wkv6_scan_ref``), as
the reference's serve path does, and writes them back into the cache in
place.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_norm, dense_init, layer_slice, norm_params
from repro_torch.models.ssm import (
    rwkv6_channel_mix,
    rwkv6_finish,
    rwkv6_params,
    rwkv6_site_args,
    rwkv6_time_mix,
    wkv6_mixer_site,
)


def init_base(cfg, gen):
    """Frozen base weights drawn from ``gen`` on its device."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    dev = gen.device
    return {
        "embed": dense_init(gen, (V, d), in_axis=-1, dtype=cfg.dtype),
        "layers": {
            "mix": rwkv6_params(cfg, gen, layers=L),
            "ln1": norm_params(cfg, d, layers=L, device=dev),
            "ln2": norm_params(cfg, d, layers=L, device=dev),
        },
        "final_norm": norm_params(cfg, d, device=dev),
        "lm_head": dense_init(gen, (d, V), dtype=cfg.dtype),
    }


def embed_tokens(cfg, base, tokens):
    return base["embed"][tokens.long()]


def unembed(cfg, base):
    return base["lm_head"]


def _layer(cfg, base, peft_layers, lora_scale, h, i):
    """One full RWKV6 layer (time mix, then channel mix), shared by the L-1
    prefix layers of ``split_forward``."""
    lp = layer_slice(base["layers"], i)
    pl = layer_slice(peft_layers, i) or None
    hn = apply_norm(cfg, h, lp["ln1"])
    h = h + rwkv6_time_mix(cfg, lp["mix"], hn, pl, lora_scale)[0]
    hn = apply_norm(cfg, h, lp["ln2"])
    return h + rwkv6_channel_mix(cfg, lp["mix"], hn)[0]


def forward_scanned(cfg, base, peft, tokens, lora_scale=1.0):
    """The train forward as ONE loop over all L layers (no split at the
    final mixer): the reference keeps it as an oracle for ``forward``."""
    h = embed_tokens(cfg, base, tokens)
    peft_layers = (peft or {}).get("layers", {})
    for i in range(cfg.n_layers):
        h = _layer(cfg, base, peft_layers, lora_scale, h, i)
    h = apply_norm(cfg, h, base["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward(cfg, base, peft, tokens, lora_scale=1.0):
    """Train forward -> (hidden (B,S,D), aux), as the split composition
    ``split_forward`` -> ``mixer_site`` -> ``split_post`` (L-1 layers in a
    loop, the final one unrolled around its WKV6 recurrence): the
    registry's split losses run exactly these ops."""
    site_args, ctx = split_forward(cfg, base, peft, tokens, lora_scale=lora_scale)
    y = mixer_site(cfg, site_args)
    return split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def split_site(cfg):
    return "wkv6", {}


def mixer_site(cfg, site_args):
    """The final layer's WKV6 recurrence on the split site args
    (region-gated, see ``ssm.wkv6_mixer_site``)."""
    return wkv6_mixer_site(site_args)


def split_forward(cfg, base, peft, tokens, lora_scale=1.0):
    """First L-1 layers, then the final layer up to its WKV6 recurrence:
    site_args = (r, k, v, w, u), ctx {"h": the residual stream, "g": the
    gate stream} for the post-mixer tail."""
    h = embed_tokens(cfg, base, tokens)
    peft_layers = (peft or {}).get("layers", {})
    L = cfg.n_layers
    for i in range(L - 1):
        h = _layer(cfg, base, peft_layers, lora_scale, h, i)
    lp = layer_slice(base["layers"], L - 1)
    pl = layer_slice(peft_layers, L - 1) or None
    hn = apply_norm(cfg, h, lp["ln1"])
    site_args, g = rwkv6_site_args(cfg, lp["mix"], hn, pl, lora_scale)
    return site_args, {"h": h, "g": g}


def split_post(cfg, base, y, ctx, peft, lora_scale=1.0):
    """Post-head: the WKV6 mixer output (B,S,H,hd) fp32 -> (final hidden,
    aux). The fused estimator reverses it once."""
    L = cfg.n_layers
    lp = layer_slice(base["layers"], L - 1)
    pl = layer_slice((peft or {}).get("layers", {}), L - 1) or None
    h, g = ctx["h"], ctx["g"]
    h = h + rwkv6_finish(cfg, lp["mix"], y, g, h.dtype, pl, lora_scale)
    hn = apply_norm(cfg, h, lp["ln2"])
    h = h + rwkv6_channel_mix(cfg, lp["mix"], hn)[0]
    h = apply_norm(cfg, h, base["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# Serving: explicit (wkv, token-shift) state a layer
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, *, device):
    """Recurrent state on ``device``: ``wkv`` (L,B,H,hd,hd) fp32 and the
    time- and channel-mix token-shift rows ``shift_tm`` / ``shift_cm``
    (L,B,1,D) in the model's dtype. Its size does not depend on
    ``seq_len``."""
    hd = cfg.ssm.head_dim
    L, D = cfg.n_layers, cfg.d_model
    return {
        "wkv": torch.zeros((L, batch, D // hd, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((L, batch, 1, D), dtype=cfg.dtype, device=device),
        "shift_cm": torch.zeros((L, batch, 1, D), dtype=cfg.dtype, device=device),
    }


def _stateful_layers(cfg, base, peft, cache, h, lora_scale):
    """All L layers over h (B,S,D) from the cache's states; each layer's
    final (wkv, shift) states are written back in place, the shift rows
    cast to the cache's dtype. Returns the final-normed hidden stream."""
    peft_layers = (peft or {}).get("layers", {})
    for i in range(cfg.n_layers):
        lp = layer_slice(base["layers"], i)
        pl = layer_slice(peft_layers, i) or None
        s_tm, s_cm = cache["shift_tm"][i], cache["shift_cm"][i]
        hn = apply_norm(cfg, h, lp["ln1"])
        tm, wkv, last_tm = rwkv6_time_mix(cfg, lp["mix"], hn, pl, lora_scale,
                                          state=cache["wkv"][i], shift_prev=s_tm)
        h = h + tm
        hn = apply_norm(cfg, h, lp["ln2"])
        cm, last_cm = rwkv6_channel_mix(cfg, lp["mix"], hn, shift_prev=s_cm)
        h = h + cm
        cache["wkv"][i].copy_(wkv)
        s_tm.copy_(last_tm)
        s_cm.copy_(last_cm)
    return apply_norm(cfg, h, base["final_norm"])


def prefill(cfg, base, peft, cache, tokens, lora_scale=1.0):
    """Fused prompt ingestion: one multi-token recurrence pass a layer
    instead of P ``decode_step`` calls. The recurrence is an exact
    per-token scan either way, so the cache ends where the decode loop
    would have left it. Returns (last-token logits (B,V) fp32, cache)."""
    h = _stateful_layers(cfg, base, peft, cache, embed_tokens(cfg, base, tokens),
                         lora_scale)
    return (h[:, -1, :] @ unembed(cfg, base)).float(), cache


def decode_step(cfg, base, peft, cache, token, pos, lora_scale=1.0):
    """token (B,1) int -> (logits (B,V) fp32, cache). ``pos`` (an int or a
    (B,) tensor) is ignored: the state carries all the history."""
    h = _stateful_layers(cfg, base, peft, cache, embed_tokens(cfg, base, token),
                         lora_scale)
    return (h[:, 0, :] @ unembed(cfg, base)).float(), cache
