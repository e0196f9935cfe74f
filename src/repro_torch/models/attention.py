"""GQA attention: the train/prefill half and the dense family's decode.
Port of ``repro/models/attention.py``.

Outside the estimator (eval, ``cls_logits``, serving's prefill and decode)
attention is plain torch ops, as in the reference (its
``use_kernel_mixers()`` is false there). Inside the estimator's forward-AD
region the mixer goes through ``dispatch.swa_attend``: the flash kernel for
the primal and the multi-tangent kernel for all K tangents.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.common import dense_init, maybe_lora, proj, rope, rope_at

NEG_INF = -1e30


def attn_params(cfg, gen, layers=None):
    d, hd = cfg.d_model, cfg.hd
    shapes = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    stack = (layers,) if layers else ()
    p = {}
    for name, shape in shapes.items():
        p[name] = dense_init(gen, stack + shape, in_axis=-2, dtype=cfg.dtype)
        if cfg.use_bias:
            p[name + "_b"] = torch.zeros(stack + (shape[1],), dtype=cfg.dtype,
                                         device=gen.device)
    return p


def _sdpa(q, k, v, keep, scale):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), keep: (Sq,Sk) bool."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attend_prefill(q, k, v, *, window=None, causal=True, q_chunk=512):
    """Chunked causal attention, (B,S,H,hd) layout; window=W attends to the
    last W keys only, with keys sliced to the (window + chunk) band."""
    B, S_orig, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, S_orig)
    pad = (-S_orig) % q_chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    S = S_orig + pad
    banded = window is not None and (window + q_chunk) < S
    band = (window + q_chunk) if banded else S
    outs = []
    for ci in range(S // q_chunk):
        start_q = ci * q_chunk
        qc = q[:, start_q:start_q + q_chunk]
        if banded:
            start_k = min(max(start_q + q_chunk - band, 0), S - band)
            kc, vc = k[:, start_k:start_k + band], v[:, start_k:start_k + band]
        else:
            start_k = 0
            kc, vc = k, v
        kpos = start_k + torch.arange(kc.shape[1], device=q.device)
        qpos = start_q + torch.arange(q_chunk, device=q.device)
        if causal:
            keep = kpos[None, :] <= qpos[:, None]
        else:
            keep = torch.ones((q_chunk, kpos.shape[0]), dtype=torch.bool,
                              device=q.device)
        if window is not None:
            keep = keep & (kpos[None, :] > qpos[:, None] - window)
        keep = keep & (kpos[None, :] < S_orig)
        outs.append(_sdpa(qc, kc, vc, keep, scale))
    return torch.cat(outs, dim=1)[:, :S_orig]


def qkv(cfg, p, x, peft_layer, lora_scale):
    B, S, _ = x.shape
    hd = cfg.hd
    q = proj(x, p["wq"], p.get("wq_b"), maybe_lora(peft_layer, "wq"), lora_scale)
    k = proj(x, p["wk"], p.get("wk_b"), maybe_lora(peft_layer, "wk"), lora_scale)
    v = proj(x, p["wv"], p.get("wv_b"), maybe_lora(peft_layer, "wv"), lora_scale)
    return (q.reshape(B, S, cfg.n_heads, hd), k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def attn_site_qkv(cfg, p, x, peft_layer, lora_scale, *, rope_cs=None):
    """Roped (q, k, v) in model layout (B,S,H,hd)."""
    q, k, v = qkv(cfg, p, x, peft_layer, lora_scale)
    if cfg.rope_theta:
        q = rope(q, rope_cs)
        k = rope(k, rope_cs)
    return q, k, v


def swa_mixer_site(cfg, args, window):
    """Causal GQA mixer on kernel-layout args (q (B,H,S,hd); k,v
    (B,KV,S,hd)): the dispatched op inside the estimator's forward-AD
    region, the chunked ``attend_prefill`` otherwise."""
    q, k, v = args
    if dispatch.in_forward_ad_region():
        return dispatch.swa_attend(q, k, v, window)
    out = attend_prefill(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         window=window, causal=True)
    return out.transpose(1, 2)


def attn_finish(cfg, p, out, peft_layer, lora_scale):
    """Mixer output (B,S,H,hd) -> output projection (B,S,D)."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return proj(out, p["wo"], p.get("wo_b"), maybe_lora(peft_layer, "wo"),
                lora_scale)


def attn_block_prefill_kv(cfg, p, x, peft_layer, lora_scale, *, is_global=True,
                          rope_cs=None):
    """``attn_block_prefill`` that also returns the roped (k, v) rows:
    exactly what decode would have inserted into the KV cache for these
    positions (the fused-prefill serve path)."""
    q, k, v = attn_site_qkv(cfg, p, x, peft_layer, lora_scale, rope_cs=rope_cs)
    window = None if is_global else cfg.window
    out = swa_mixer_site(cfg, (q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)), window).transpose(1, 2)
    return attn_finish(cfg, p, out, peft_layer, lora_scale), k, v


def attn_block_prefill(cfg, p, x, peft_layer, lora_scale, *, is_global=True,
                       rope_cs=None):
    return attn_block_prefill_kv(cfg, p, x, peft_layer, lora_scale,
                                 is_global=is_global, rope_cs=rope_cs)[0]


def _repeat_kv(t, rep):
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=2)


def attn_block_decode_nocopy(cfg, p, x, peft_layer, lora_scale, k_cache, v_cache,
                             pos, *, is_global=True, window_len=None):
    """One-token decode that does not write the cache: x (B,1,D), caches
    (B,Sc,KV,hd) -> (out, k_new, v_new). The caller inserts all layers' new
    rows with one write after the layer loop.

    ``pos`` is an int (every row at one position) or a (B,) tensor (each row
    at its own). The new token's score is appended after the cache scores;
    for ring buffers the slot it is about to overwrite is the entry falling
    out of the window, so that slot is masked out of the cache part.
    ``window_len`` (a per-layer window, huge for global layers) overrides
    ``is_global``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    rep = H // cfg.n_kv_heads
    q, k_new, v_new = qkv(cfg, p, x, peft_layer, lora_scale)
    per_row = isinstance(pos, torch.Tensor)
    if cfg.rope_theta:
        pos_arr = pos[:, None] if per_row else torch.full((1, 1), pos,
                                                          device=x.device)
        q = rope_at(q, pos_arr, cfg.rope_theta)
        k_new = rope_at(k_new, pos_arr, cfg.rope_theta)
    Sc = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    if window_len is not None:
        window = window_len
    else:
        window = None if is_global else cfg.window
        if window is not None and window >= Sc:
            window = None   # the ring already bounds the visible set

    vc = _repeat_kv(v_cache, rep)
    s_cache = torch.einsum("bqhd,bkhd->bhqk", q,
                           _repeat_kv(k_cache, rep)).float() * scale
    idx = torch.arange(Sc, device=x.device)
    if per_row:
        valid = idx[None, :] < torch.clamp(pos, max=Sc)[:, None]   # past tokens
        valid = valid & (idx[None, :] != (pos % Sc)[:, None])      # slot overwritten
        if window is not None:
            valid = valid & (idx[None, :] > (pos - window)[:, None])
        valid = valid[:, None, None, :]
    else:
        valid = (idx < min(pos, Sc)) & (idx != pos % Sc)
        if window is not None:
            valid = valid & (idx > pos - window)
    s_cache = s_cache.masked_fill(~valid, NEG_INF)
    s_new = torch.einsum("bqhd,bkhd->bhqk", q, _repeat_kv(k_new, rep)).float() * scale
    p_all = torch.softmax(torch.cat([s_cache, s_new], dim=-1), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p_all[..., :Sc], vc)
    out = out + torch.einsum("bhqk,bkhd->bqhd", p_all[..., Sc:],
                             _repeat_kv(v_new, rep))
    out = out.reshape(B, 1, H * hd)
    out = proj(out, p["wo"], p.get("wo_b"), maybe_lora(peft_layer, "wo"),
               lora_scale)
    return out, k_new, v_new
