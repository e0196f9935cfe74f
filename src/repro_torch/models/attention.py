"""GQA attention, train/prefill half. Port of ``repro/models/attention.py``.

Outside the estimator (eval, ``cls_logits``) attention is the plain
chunked ``attend_prefill``, as in the reference. Inside the estimator's
forward-AD region the mixer goes through ``dispatch.swa_attend``: the flash
kernel for the primal and the multi-tangent kernel for all K tangents.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.common import dense_init, maybe_lora, proj, rope

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


def attn_block_prefill(cfg, p, x, peft_layer, lora_scale, *, is_global=True,
                       rope_cs=None):
    q, k, v = attn_site_qkv(cfg, p, x, peft_layer, lora_scale, rope_cs=rope_cs)
    window = None if is_global else cfg.window
    out = swa_mixer_site(cfg, (q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)), window).transpose(1, 2)
    return attn_finish(cfg, p, out, peft_layer, lora_scale)
