"""Decoder-only transformer stack (dense family).

Port of ``repro/models/transformer.py``: ``init_base``, ``embed_tokens``,
``unembed``, the train ``forward`` and its split pieces (``split_site``,
``mixer_site``, ``split_forward``, ``split_post``), and serving's
``prefill``, ``init_cache`` and ``decode_step``. The reference's
``lax.scan`` over stacked layers becomes a plain loop over layer slices of
the same stacked tensors. Where the reference donates the KV cache to its
jitted prefill and decode, these write the cache in place and return it.
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


# ---------------------------------------------------------------------------
# Serving: fused prefill, KV cache, decode
# ---------------------------------------------------------------------------

def _mixed_pattern(cfg) -> bool:
    flags = [cfg.is_global_layer(i) for i in range(cfg.n_layers)]
    return any(flags) and not all(flags)


def _quantize_kv(x):
    """x (..., hd) -> (int8, scale (..., 1)): per-vector absmax."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()).to(dtype)


def _write_rows(cache, k, v, index):
    """cache[name][index] = the new rows (quantized on insert for an int8
    cache), in place."""
    if "k_scale" in cache:
        for name, rows in (("k", k), ("v", v)):
            q, scale = _quantize_kv(rows)
            cache[name][index] = q
            cache[name + "_scale"][index] = scale.to(cache[name + "_scale"].dtype)
    else:
        cache["k"][index] = k.to(cache["k"].dtype)
        cache["v"][index] = v.to(cache["v"].dtype)


def prefill(cfg, base, peft, cache, tokens, lora_scale=1.0):
    """Fused prompt ingestion: one chunked-attention pass over the prompt
    instead of P ``decode_step`` calls. Returns (last-token logits (B,V)
    fp32, cache) with the cache holding, in place, exactly the rows the
    token-by-token decode loop would have written (ring aware: when the
    prompt is longer than a sliding-window cache, each slot keeps its LAST
    occupant). Applies no BitFit biases, as ``decode_step``.

    int8-KV caches get their rows quantized on insert, but are not
    decode-loop equivalent (the loop attends to quantized history while
    this pass attends to exact K/V): ``launch/serve.can_fuse_prefill``
    sends them to the token loop."""
    B, P = tokens.shape
    h = embed_tokens(cfg, base, tokens)
    rope_cs = rope_tables_for(cfg, h)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp, pl = _slices(base, peft, i)
        hn = apply_norm(cfg, h, lp["ln1"])
        a, k, v = attn.attn_block_prefill_kv(cfg, lp["attn"], hn, pl, lora_scale,
                                             is_global=cfg.is_global_layer(i),
                                             rope_cs=rope_cs)
        h = _layer_tail(cfg, h + a, lp, pl, lora_scale)
        ks.append(k)
        vs.append(v)
    h = apply_norm(cfg, h, base["final_norm"])
    logits = (h[:, -1, :] @ unembed(cfg, base)).float()
    # slot s <- the LAST prompt position p < P with p % Sc == s (identity
    # placement while P <= Sc; ring semantics beyond)
    Sc = cache["k"].shape[2]
    slots = torch.arange(min(P, Sc), device=tokens.device)
    last_pos = slots + Sc * ((P - 1 - slots) // Sc)
    n = len(slots)
    _write_rows(cache, torch.stack(ks)[:, :, last_pos], torch.stack(vs)[:, :, last_pos],
                (slice(None), slice(None), slice(0, n)))
    return logits, cache


def cache_len(cfg, seq_len: int) -> int:
    if cfg.attn_pattern == "swa":
        return min(cfg.window, seq_len)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, kv_int8: bool = False, *, device):
    """KV cache {"k", "v"}: (L, B, Sc, KV, hd) on ``device``. kv_int8=True
    stores int8 entries and per-(token, head) absmax scales in the model's
    dtype, halving the cache's bytes."""
    shape = (cfg.n_layers, batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    if kv_int8:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=cfg.dtype, device=device),
                "v_scale": torch.zeros(sshape, dtype=cfg.dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(cfg, base, peft, cache, token, pos, lora_scale=1.0):
    """token (B,1) int; pos an int (the whole batch at one position) or a
    (B,) tensor (continuous batching: each row at its own position, writing
    its own ring slot). Returns (logits (B,V) fp32, cache).

    The layers read the cache and return only the new token's K/V rows; all
    layers' rows are inserted with one in-place write after the layer loop.
    Mixed local:global stacks pass each layer's window length (huge for
    global layers)."""
    h = embed_tokens(cfg, base, token)
    mixed = _mixed_pattern(cfg)
    quantized = "k_scale" in cache
    k_news, v_news = [], []
    for i in range(cfg.n_layers):
        lp, pl = _slices(base, peft, i)
        kc, vc = cache["k"][i], cache["v"][i]
        if quantized:
            kc = _dequantize_kv(kc, cache["k_scale"][i], cfg.dtype)
            vc = _dequantize_kv(vc, cache["v_scale"][i], cfg.dtype)
        hn = apply_norm(cfg, h, lp["ln1"])
        if mixed:
            window = {"window_len": 2 ** 30 if cfg.is_global_layer(i) else cfg.window}
        else:
            window = {"is_global": bool(cfg.is_global_layer(0))}
        a, k_new, v_new = attn.attn_block_decode_nocopy(
            cfg, lp["attn"], hn, pl, lora_scale, kc, vc, pos, **window)
        h = _layer_tail(cfg, h + a, lp, pl, lora_scale)
        k_news.append(k_new[:, 0])
        v_news.append(v_new[:, 0])
    h = apply_norm(cfg, h, base["final_norm"])
    logits = (h[:, 0, :] @ unembed(cfg, base)).float()
    Sc = cache["k"].shape[2]
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(token.shape[0], device=token.device)
        index = (slice(None), rows, pos.long() % Sc)
    else:
        index = (slice(None), slice(None), pos % Sc)
    _write_rows(cache, torch.stack(k_news), torch.stack(v_news), index)
    return logits, cache
