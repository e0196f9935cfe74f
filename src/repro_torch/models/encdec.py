"""Whisper-style encoder-decoder (the audio family). Port of
``repro/models/encdec.py``. The mel/conv frontend is a stub: the encoder
reads precomputed frame embeddings (B, encoder_seq, d_model).

The encoder's self-attention is non-causal and the decoder's
cross-attention reads the encoder's output (``memory``); both stay plain
torch, also inside the estimator (the reference runs them outside any
kernel). The decoder's causal self-attention is the mixer site: its final
layer's is the split forward's site, and inside the estimator's forward-AD
region every decoder layer's goes through ``dispatch.swa_attend``. LoRA
pairs of ``peft["enc_layers"]`` adapt the encoder's projections, those of
``peft["layers"]`` the decoder's self-attention and its cross-attention's
``wq`` / ``wo``. Positions are sinusoidal (``rope_theta`` 0); the output
head is the embedding, tied. The serving cache keeps ``memory``, which the
caller fills once per request (``encode``): prefill and decode read it and
never recompute it.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    layer_slice,
    norm_params,
    sinusoidal_positions,
)
from repro_torch.models.mlp import mlp_block, mlp_params


def init_base(cfg, gen):
    """Frozen base weights, drawn from ``gen`` on its device."""
    d, V = cfg.d_model, cfg.vocab
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    dev = gen.device
    enc_layers = {
        "attn": attn.attn_params(cfg, gen, layers=Le),
        "mlp": mlp_params(cfg, gen, layers=Le),
        "ln1": norm_params(cfg, d, layers=Le, device=dev),
        "ln2": norm_params(cfg, d, layers=Le, device=dev),
    }
    dec_layers = {
        "self_attn": attn.attn_params(cfg, gen, layers=Ld),
        "cross_attn": attn.attn_params(cfg, gen, layers=Ld),
        "mlp": mlp_params(cfg, gen, layers=Ld),
        "ln1": norm_params(cfg, d, layers=Ld, device=dev),
        "ln2": norm_params(cfg, d, layers=Ld, device=dev),
        "ln3": norm_params(cfg, d, layers=Ld, device=dev),
    }
    return {
        "embed": dense_init(gen, (V, d), in_axis=-1, dtype=cfg.dtype),
        "enc_layers": enc_layers,
        "enc_norm": norm_params(cfg, d, device=dev),
        "layers": dec_layers,
        "final_norm": norm_params(cfg, d, device=dev),
    }


def unembed(cfg, base):
    return base["embed"].T      # the decoder's output head is the embedding


def _slices(base, peft, group, i):
    return (layer_slice(base[group], i),
            layer_slice((peft or {}).get(group, {}), i) or None)


def encode(cfg, base, frames, peft=None, lora_scale=1.0):
    """frames (B, F, D), the frontend stub's embeddings -> memory (B, F, D)."""
    h = frames.to(cfg.dtype) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)
    for i in range(cfg.encoder_layers):
        lp, pl = _slices(base, peft, "enc_layers", i)
        hn = apply_norm(cfg, h, lp["ln1"])
        h = h + attn.attn_block_prefill(cfg, lp["attn"], hn, pl, lora_scale,
                                        causal=False)
        hn = apply_norm(cfg, h, lp["ln2"])
        h = h + mlp_block(cfg, lp["mlp"], hn, pl, lora_scale)
    return apply_norm(cfg, h, base["enc_norm"])


def _cross_and_mlp(cfg, h, memory, lp, pl, lora_scale):
    """ln2 + cross-attention + residual, then ln3 + MLP + residual: a
    decoder layer after its self-attention."""
    hn = apply_norm(cfg, h, lp["ln2"])
    h = h + attn.cross_attn_block(cfg, lp["cross_attn"], hn, memory, pl, lora_scale)
    hn = apply_norm(cfg, h, lp["ln3"])
    return h + mlp_block(cfg, lp["mlp"], hn, pl, lora_scale)


def _decoder_layer(cfg, h, memory, lp, pl, lora_scale):
    hn = apply_norm(cfg, h, lp["ln1"])
    h = h + attn.attn_block_prefill(cfg, lp["self_attn"], hn, pl, lora_scale)
    return _cross_and_mlp(cfg, h, memory, lp, pl, lora_scale)


def _decoder_embed(cfg, base, tokens):
    h = base["embed"][tokens.long()]
    return h + sinusoidal_positions(tokens.shape[1], cfg.d_model, h.device).to(h.dtype)


def forward_scanned(cfg, base, peft, tokens, frames=None, lora_scale=1.0,
                    memory=None):
    """Reference train forward: all L decoder layers in one loop (the
    reference's one ``lax.scan``), the test oracle for ``forward``."""
    if memory is None:
        memory = encode(cfg, base, frames, peft, lora_scale)
    h = _decoder_embed(cfg, base, tokens)
    for i in range(cfg.n_layers):
        lp, pl = _slices(base, peft, "layers", i)
        h = _decoder_layer(cfg, h, memory, lp, pl, lora_scale)
    return (apply_norm(cfg, h, base["final_norm"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def forward(cfg, base, peft, tokens, frames=None, lora_scale=1.0):
    """Teacher-forced decoder pass -> (hidden (B,S,D), aux 0), as the split
    composition ``split_forward`` -> ``mixer_site`` -> ``split_post``."""
    site_args, ctx = split_forward(cfg, base, peft, tokens, frames=frames,
                                   lora_scale=lora_scale)
    y = mixer_site(cfg, site_args)
    return split_post(cfg, base, y, ctx, peft, lora_scale=lora_scale)


def split_site(cfg):
    return "swa", {"window": None}


def mixer_site(cfg, site_args):
    """The final decoder layer's causal self-attention mixer (region-gated,
    see ``attention.swa_mixer_site``)."""
    return attn.swa_mixer_site(cfg, site_args, None)


def split_forward(cfg, base, peft, tokens, frames=None, lora_scale=1.0):
    """Encoder and the first L-1 decoder layers, then the final decoder
    layer up to its self-attention mixer -> (site_args, ctx): site_args =
    (q, k, v) in kernel layout, ctx = {"h": residual stream, "memory"}."""
    memory = encode(cfg, base, frames, peft, lora_scale)
    h = _decoder_embed(cfg, base, tokens)
    for i in range(cfg.n_layers - 1):
        lp, pl = _slices(base, peft, "layers", i)
        h = _decoder_layer(cfg, h, memory, lp, pl, lora_scale)
    lp, pl = _slices(base, peft, "layers", cfg.n_layers - 1)
    hn = apply_norm(cfg, h, lp["ln1"])
    q, k, v = attn.attn_site_qkv(cfg, lp["self_attn"], hn, pl, lora_scale)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), {
        "h": h, "memory": memory}


def split_post(cfg, base, y, ctx, peft, lora_scale=1.0):
    """Post-head: self-attention mixer output (B,H,S,hd) -> (final hidden,
    aux 0); the final layer's cross-attention and MLP live here, reversed
    once by the fused estimator."""
    lp, pl = _slices(base, peft, "layers", cfg.n_layers - 1)
    h = ctx["h"] + attn.attn_finish(cfg, lp["self_attn"], y.transpose(1, 2), pl,
                                    lora_scale)
    h = _cross_and_mlp(cfg, h, ctx["memory"], lp, pl, lora_scale)
    return (apply_norm(cfg, h, base["final_norm"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


# ---------------------------------------------------------------------------
# Serving: the cache keeps the encoder's memory
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, *, device):
    """{"k", "v"}: (L, B, seq_len, KV, hd) self-attention rows; "memory":
    (B, encoder_seq, D), the encoder's output, zeros until the caller
    encodes a request's frames into it."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "memory": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                  dtype=cfg.dtype, device=device)}


def prefill(cfg, base, peft, cache, tokens, lora_scale=1.0):
    """Fused decoder prompt ingestion: one causal pass over the prompt,
    cross-attending to ``cache["memory"]``. Returns (last-token logits
    (B,V) fp32, cache) with rows 0..P-1 of the self-attention cache written
    in place (the cache is full-length: ``serve.can_fuse_prefill`` sends a
    prompt longer than it to the token loop)."""
    P = tokens.shape[1]
    h = _decoder_embed(cfg, base, tokens)
    memory = cache["memory"]
    for i in range(cfg.n_layers):
        lp, pl = _slices(base, peft, "layers", i)
        hn = apply_norm(cfg, h, lp["ln1"])
        a, k, v = attn.attn_block_prefill_kv(cfg, lp["self_attn"], hn, pl, lora_scale)
        h = _cross_and_mlp(cfg, h + a, memory, lp, pl, lora_scale)
        cache["k"][i, :, :P] = k.to(cache["k"].dtype)
        cache["v"][i, :, :P] = v.to(cache["v"].dtype)
    h = apply_norm(cfg, h, base["final_norm"])
    return (h[:, -1, :] @ unembed(cfg, base)).float(), cache


def decode_step(cfg, base, peft, cache, token, pos, lora_scale=1.0):
    """token (B,1); pos an int or a (B,) tensor (each row at its own
    position: its row of the cache-length sinusoidal table, equal to the
    scalar case's). Returns (logits (B,V) fp32, cache), the new rows
    written in place."""
    h = base["embed"][token.long()]
    table = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, h.device)
    if isinstance(pos, torch.Tensor):
        h = h + table[pos.long()][:, None, :].to(h.dtype)
    else:
        h = h + table[pos][None, None, :].to(h.dtype)
    memory = cache["memory"]
    for i in range(cfg.n_layers):
        lp, pl = _slices(base, peft, "layers", i)
        hn = apply_norm(cfg, h, lp["ln1"])
        a, _, _ = attn.attn_block_decode(cfg, lp["self_attn"], hn, pl, lora_scale,
                                         cache["k"][i], cache["v"][i], pos)
        h = _cross_and_mlp(cfg, h + a, memory, lp, pl, lora_scale)
    h = apply_norm(cfg, h, base["final_norm"])
    return (h[:, 0, :] @ unembed(cfg, base)).float(), cache
