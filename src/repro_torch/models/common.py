"""Shared model primitives: init, norms, activations, RoPE, projections,
losses.

Port of ``repro/models/common.py``. Mixed-dtype arithmetic follows JAX's
promotion explicitly (torch refuses a bf16 @ fp32 product), so each cast
below stands where the reference promotes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import lora_proj, lora_proj_multi


# ---------------------------------------------------------------------------
# Initialisation (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------

_DRAW_BYTES_MAX = 2 ** 34     # 16 GiB of fp32: a larger draw is made a slice at a time


def dense_init(gen, shape, in_axis=-2, dtype=torch.float32):
    """LeCun-normal drawn in fp32 on the generator's device, then cast. A
    layer-stacked leaf whose fp32 draw would pass 16 GiB (gemma3-27b's MLP
    weights, 29 GB each) is drawn one leading-axis slice at a time into its
    output, so the init holds one layer's draw beside the weights made so
    far, not the whole leaf's (which would not fit on one 80 GB card).
    Every smaller leaf is drawn whole: a draw a slice at a time gives other
    values, and the card limits of the configs whose leaves are all smaller
    (the serving engines' SERVE_BF16_ATOL and SERVE_FP32_ATOL in
    chip_smoke.py, and the readings beside them) were read on the whole
    draws' weights, so one path for all would need each re-read."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    if len(shape) > 2 and 4 * math.prod(shape) > _DRAW_BYTES_MAX:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            x = torch.randn(shape[1:], generator=gen, device=gen.device)
            out[i] = (x / math.sqrt(fan_in)).to(dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def layernorm(x, w, b, eps=1e-6):
    """Population variance in fp32, cast back (as the reference)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def norm_params(cfg, d, layers=None, device=None):
    shape = (layers, d) if layers else (d,)
    p = {"w": torch.ones(shape, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, device=device)
    return p


def activation(cfg, x):
    if cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# RoPE (split-half rotation)
# ---------------------------------------------------------------------------

def rope_tables(theta, seq, hd, device=None):
    """(cos, sin), each (S, hd/2) fp32, for positions 0..S-1."""
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=device) / (hd // 2))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, tables):
    """x: (B, S, H, hd) rotated by precomputed (cos, sin) tables."""
    cos, sin = tables
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def rope_at(x, positions, theta):
    """x: (B, S, H, hd) rotated at explicit integer ``positions`` (B or 1,
    S): the reference's table-free ``rope`` (decode, each row at its own
    position)."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=x.device) / (hd // 2))
    ang = positions.float()[..., None] * freqs                  # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def rope_tables_for(cfg, h):
    if not cfg.rope_theta:
        return None
    return rope_tables(cfg.rope_theta, h.shape[1], cfg.hd, device=h.device)


def layer_slice(tree, i):
    """Per-layer slice of a stacked parameter tree ({} stays {})."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Dense (+LoRA) projection
# ---------------------------------------------------------------------------

def proj(x, w, b=None, lora=None, lora_scale=1.0):
    """y = x @ W (+ b) (+ s * (x@A)@B). The LoRA path routes through
    ``kernels/dispatch.lora_proj``, whose forward-mode rule runs the
    multi-tangent kernel inside the estimator. A multi-adapter entry
    {"A": (P, din, r), "B": (P, r, dout), "idx": (B,)} (the serving
    engine's) makes row b read adapter page idx[b] through
    ``dispatch.lora_proj_multi``."""
    if lora is not None and "idx" in lora:
        y = lora_proj_multi(x, lora["idx"], w, lora["A"], lora["B"],
                            float(lora_scale))
    elif lora is not None:
        y = lora_proj(x, w, lora["A"], lora["B"], float(lora_scale))
    else:
        y = x @ w
    if b is not None:
        y = y + b
    return y


def maybe_lora(peft_layer, name):
    if peft_layer is None:
        return None
    return peft_layer.get(name)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def chunked_lm_loss(h, unembed, targets, valid=None, chunk=512):
    """Next-token CE over S in chunks (the (B,S,V) logits never exist at
    once). h: (B,S,D), unembed: (D,V), targets: (B,S) already shifted."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    if valid is None:
        valid = torch.ones(targets.shape, dtype=torch.float32, device=h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (h[:, sl] @ unembed).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, sl, None].long())[..., 0]
        vc = valid[:, sl].float()
        total = total + ((logz - gold) * vc).sum()
        count = count + vc.sum()
    return total / torch.clamp(count, min=1.0)


def classification_loss(h, head, labels):
    """Last-token pooled CE with the trainable head (fp32, as the
    reference's bf16 x fp32 promotion)."""
    pooled = h[:, -1, :]
    logits = pooled.float() @ head["w"] + head["b"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return nll.mean(), logits


def accuracy_from_logits(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).float())
