"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block
(its weights reused at every application) after every
``cfg.hybrid_attn_every``-th layer.

Port of ``repro/models/hybrid.py``: ``init_base``, ``embed_tokens``,
``unembed``, the train ``forward`` and its split pieces (``split_site``,
``mixer_site``, ``split_forward``, ``split_post``), the one-loop
``forward_scanned`` (a test oracle, as in the reference), and serving
(``n_attn_sites``, ``init_cache``, ``prefill``, ``decode_step``). The
reference's ``lax.scan`` over stacked layers becomes a plain loop over
layer slices, and its ``lax.cond`` on the layer index a plain ``if``.

Serving keeps a mamba2 state and conv tail a layer (threaded through the
plain recurrence, ``mamba2_scan_ref``) and one K/V ring a shared-attention
application site (``layer // hybrid_attn_every``), written in place.
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


def n_attn_sites(cfg) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


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


def _shared_tail(cfg, shared, h, a):
    """The shared block after its attention output ``a``: the residual,
    then the MLP."""
    h = h + a
    return h + mlp_block(cfg, shared["mlp"], apply_norm(cfg, h, shared["ln2"]))


def _shared_block_prefill(cfg, shared, shared_peft, h, lora_scale, rope_cs=None):
    hn = apply_norm(cfg, h, shared["ln1"])
    return _shared_tail(cfg, shared, h, attn.attn_block_prefill(
        cfg, shared["attn"], hn, shared_peft, lora_scale, is_global=False,
        rope_cs=rope_cs))


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


def forward_scanned(cfg, base, peft, tokens, lora_scale=1.0):
    """The train forward as ONE loop over all L layers (no split at the
    final mixer): the reference keeps it as an oracle for ``forward``."""
    h = embed_tokens(cfg, base, tokens)
    peft_layers, shared_peft = _peft_parts(peft)
    rope_cs = rope_tables_for(cfg, h)
    for i in range(cfg.n_layers):
        h = _layer(cfg, base, peft_layers, shared_peft, lora_scale, rope_cs, h, i)
    h = apply_norm(cfg, h, base["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


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


# ---------------------------------------------------------------------------
# Serving: mamba2 (ssm, conv) state a layer, a K/V ring a shared-attention site
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, *, device):
    """``ssm`` (L,B,H,hd,N) fp32, ``conv`` (L,B,K-1,d_inner) and the
    shared block's rings ``attn_k`` / ``attn_v`` (sites,B,W,KV,hd) with W =
    min(window, seq_len), in the model's dtype, on ``device``."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    L, W = cfg.n_layers, min(cfg.window, seq_len)
    ring = (n_attn_sites(cfg), batch, W, cfg.n_kv_heads, cfg.hd)
    return {
        "ssm": torch.zeros((L, batch, d_inner // s.head_dim, s.head_dim,
                            s.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, s.conv_kernel - 1, d_inner),
                            dtype=cfg.dtype, device=device),
        "attn_k": torch.zeros(ring, dtype=cfg.dtype, device=device),
        "attn_v": torch.zeros(ring, dtype=cfg.dtype, device=device),
    }


def _stateful_layers(cfg, base, peft, cache, h, lora_scale, shared_block):
    """All L layers over h (B,S,D) from the cache's mamba2 states, written
    back in place; after each application site's mixer,
    ``shared_block(h, site)`` runs the shared block and updates that site's
    ring. Returns the final-normed hidden stream."""
    peft_layers, _ = _peft_parts(peft)
    every = cfg.hybrid_attn_every
    for i in range(cfg.n_layers):
        lp = layer_slice(base["layers"], i)
        pl = layer_slice(peft_layers, i) or None
        hn = apply_norm(cfg, h, lp["ln1"])
        mix, ssm_s, conv_s = mamba2_mix(cfg, lp["mix"], hn, pl, lora_scale,
                                        state=cache["ssm"][i],
                                        conv_state=cache["conv"][i])
        h = h + mix
        cache["ssm"][i].copy_(ssm_s)
        cache["conv"][i].copy_(conv_s)
        if i % every == every - 1:
            h = shared_block(h, i // every)
    return apply_norm(cfg, h, base["final_norm"])


def prefill(cfg, base, peft, cache, tokens, lora_scale=1.0):
    """Fused prompt ingestion: one multi-token pass instead of P
    ``decode_step`` calls. The mamba2 recurrence and conv are exact
    per-token scans either way; each site runs chunked prefill attention
    and captures the roped K/V rows the decode loop would have inserted,
    slot s keeping the LAST prompt position p < P with p % W == s. Returns
    (last-token logits (B,V) fp32, cache)."""
    P = tokens.shape[1]
    h = embed_tokens(cfg, base, tokens)
    shared, shared_peft = base["shared"], _peft_parts(peft)[1]
    rope_cs = rope_tables_for(cfg, h)
    W = cache["attn_k"].shape[2]
    slots = torch.arange(min(P, W), device=tokens.device)
    gather = slots + W * ((P - 1 - slots) // W)

    def shared_block(h, site):
        hn = apply_norm(cfg, h, shared["ln1"])
        a, k, v = attn.attn_block_prefill_kv(cfg, shared["attn"], hn, shared_peft,
                                             lora_scale, is_global=False,
                                             rope_cs=rope_cs)
        cache["attn_k"][site, :, :len(slots)] = k[:, gather].to(cfg.dtype)
        cache["attn_v"][site, :, :len(slots)] = v[:, gather].to(cfg.dtype)
        return _shared_tail(cfg, shared, h, a)

    h = _stateful_layers(cfg, base, peft, cache, h, lora_scale, shared_block)
    return (h[:, -1, :] @ unembed(cfg, base)).float(), cache


def decode_step(cfg, base, peft, cache, token, pos, lora_scale=1.0):
    """token (B,1) int; ``pos`` an int or a (B,) tensor (continuous
    batching: each row ropes at its own position and writes its own ring
    slot). Returns (logits (B,V) fp32, cache)."""
    shared, shared_peft = base["shared"], _peft_parts(peft)[1]

    def shared_block(h, site):
        hn = apply_norm(cfg, h, shared["ln1"])
        a, _, _ = attn.attn_block_decode(cfg, shared["attn"], hn, shared_peft,
                                         lora_scale, cache["attn_k"][site],
                                         cache["attn_v"][site], pos,
                                         is_global=False)
        return _shared_tail(cfg, shared, h, a)

    h = _stateful_layers(cfg, base, peft, cache, embed_tokens(cfg, base, token),
                         lora_scale, shared_block)
    return (h[:, 0, :] @ unembed(cfg, base)).float(), cache
