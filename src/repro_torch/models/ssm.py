"""Recurrent sequence mixers: RWKV6 ("Finch") and Mamba2. Port of
``repro/models/ssm.py``: the recurrences from a fresh state (training) and
from an explicit carried state (``state=``, ``shift_prev=``,
``conv_state=``: serving's prefill and decode).

RWKV6 (data-dependent decay):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        (per head, S in R^{hd x hd})
    y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
with w_t = exp(-exp(w0 + lora(x_t))) in (0,1) elementwise.

Mamba2 (scalar-per-head decay):
    h_t = exp(-softplus(a) * dt_t) h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t C_t + D * x_t

Outside the estimator (eval, backprop baselines, serving) each recurrence
is the plain sequential scan, as in the reference. Inside the estimator's
forward-AD region, from a fresh state, it goes through the dispatched op
(``dispatch.wkv6_mix`` / ``dispatch.mamba2_mix``): the scan kernel for the
primal and the multi-tangent kernel for all K tangents.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan_ref
from repro_torch.kernels.wkv6_scan.ops import wkv6_scan_ref
from repro_torch.models.common import dense_init, maybe_lora, proj


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def rwkv6_params(cfg, gen, layers=None):
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    H = d // hd
    stack = (layers,) if layers else ()
    dev = gen.device
    r_decay = 64  # decay-LoRA rank (Finch's low-rank data-dependent decay)
    return {
        # time-mix projections
        "wr": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        "wk": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        "wv": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        "wg": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        "wo": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        # data-dependent decay (low-rank)
        "w_lora_a": dense_init(gen, stack + (d, r_decay), dtype=cfg.dtype),
        "w_lora_b": dense_init(gen, stack + (r_decay, d), dtype=cfg.dtype) * 0.1,
        "w0": torch.zeros(stack + (d,), device=dev) + 0.5,
        # token-shift interpolation factors per projection (r,k,v,g,w)
        "mu": torch.rand(stack + (5, d), generator=gen, device=dev),
        # per-head bonus
        "u": dense_init(gen, stack + (H, hd)),
        # group norm over heads
        "ln_w": torch.ones(stack + (d,), device=dev),
        "ln_b": torch.zeros(stack + (d,), device=dev),
        # channel-mix
        "cm_wr": dense_init(gen, stack + (d, d), dtype=cfg.dtype),
        "cm_wk": dense_init(gen, stack + (d, cfg.d_ff), dtype=cfg.dtype),
        "cm_wv": dense_init(gen, stack + (cfg.d_ff, d), dtype=cfg.dtype),
    }


def _token_shift(x, prev):
    """Shift right by one along S; ``prev`` is the carried last token
    (B,1,D) or zeros for a fresh sequence."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6_recurrence(r, k, v, w, u, state):
    """Sequential WKV scan. r,k,v,w: (B,S,H,hd); u: (H,hd); state:
    (B,H,hd,hd). Returns (y (B,S,H,hd), new state)."""
    return wkv6_scan_ref(r, k, v, w, u, state)


def rwkv6_site_args(cfg, p, x, peft_layer=None, lora_scale=1.0,
                    shift_prev=None):
    """Time-mix projections up to the WKV recurrence: the mixer-site
    operands ((r, k, v, w) (B,S,H,hd) fp32 + u (H,hd)) and the gate stream
    ``g`` the post-mixer tail needs. Shared by ``rwkv6_time_mix`` and the
    rwkv split forward (whose declared site is the recurrence)."""
    B, S, D = x.shape
    hd = cfg.ssm.head_dim
    H = D // hd
    prev = (shift_prev if shift_prev is not None
            else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device))
    xs = _token_shift(x, prev)
    mu = p["mu"]                                             # (5, D)

    def lerp(i):
        return (x + (xs - x) * mu[i]).to(x.dtype)

    r = proj(lerp(0), p["wr"], lora=maybe_lora(peft_layer, "wr"), lora_scale=lora_scale)
    k = proj(lerp(1), p["wk"], lora=maybe_lora(peft_layer, "wk"), lora_scale=lora_scale)
    v = proj(lerp(2), p["wv"], lora=maybe_lora(peft_layer, "wv"), lora_scale=lora_scale)
    g = proj(lerp(3), p["wg"], lora=maybe_lora(peft_layer, "wg"), lora_scale=lora_scale)
    # data-dependent decay in fp32, in (0,1)
    dw = (lerp(4) @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + dw.float()))          # (B,S,D)

    def hsplit(t):
        return t.reshape(B, S, H, hd)
    return (hsplit(r).float(), hsplit(k).float(), hsplit(v).float(), hsplit(w),
            p["u"]), g


def rwkv6_finish(cfg, p, y, g, out_dtype, peft_layer=None, lora_scale=1.0):
    """Group norm + gate + output projection on the mixer output y
    ((B,S,H,hd) fp32): the time-mix tail after the WKV recurrence (the
    split forward's post side)."""
    B, S, H, hd = y.shape
    mean = y.mean(-1, keepdim=True)
    var = torch.square(y - mean).mean(-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, H * hd)
    y = (y * p["ln_w"] + p["ln_b"]).to(out_dtype) * F.silu(g)
    return proj(y, p["wo"], lora=maybe_lora(peft_layer, "wo"),
                lora_scale=lora_scale)


def wkv6_mixer_site(args):
    """Fresh-state WKV6 recurrence on the ``rwkv6_site_args`` operands: the
    dispatched op inside the estimator's forward-AD region, the plain
    sequential recurrence otherwise. The rwkv split forward declares this
    call its fused-contraction site."""
    if dispatch.in_forward_ad_region():
        return dispatch.wkv6_mix(*args)
    return wkv6_scan_ref(*args)[0]


def rwkv6_time_mix(cfg, p, x, peft_layer=None, lora_scale=1.0, state=None,
                   shift_prev=None):
    """x: (B,S,D). state: (B,H,hd,hd) or None (zeros). Returns (out,
    new_state, last_x); new_state is None on the forward-gradient fast path
    (fresh state inside the forward-AD region), whose losses never read
    it."""
    (r, k, v, w, u), g = rwkv6_site_args(cfg, p, x, peft_layer, lora_scale,
                                         shift_prev)
    if state is None and dispatch.in_forward_ad_region():
        # one primal state walk for all K tangents
        y = dispatch.wkv6_mix(r, k, v, w, u)
    else:
        y, state = wkv6_recurrence(r, k, v, w, u, state)
    out = rwkv6_finish(cfg, p, y, g, x.dtype, peft_layer, lora_scale)
    return out, state, x[:, -1:, :]


def rwkv6_channel_mix(cfg, p, x, shift_prev=None):
    B, S, D = x.shape
    prev = (shift_prev if shift_prev is not None
            else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device))
    xs = _token_shift(x, prev)
    r = torch.sigmoid(x @ p["cm_wr"])
    k = torch.square(torch.relu(xs @ p["cm_wk"]))
    return (r * (k @ p["cm_wv"])).to(x.dtype), x[:, -1:, :]


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    op for op. (``F.softplus`` returns x itself above its threshold of 20,
    and log1p(exp(x)) below it.)"""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_params(cfg, gen, layers=None):
    d = cfg.d_model
    s = cfg.ssm
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    N = s.state_dim
    stack = (layers,) if layers else ()
    dev = gen.device
    return {
        "in_proj": dense_init(gen, stack + (d, 2 * d_inner), dtype=cfg.dtype),
        "conv_w": dense_init(gen, stack + (s.conv_kernel, d_inner), dtype=cfg.dtype),
        "w_dt": dense_init(gen, stack + (d, H), dtype=cfg.dtype),
        "dt_bias": torch.zeros(stack + (H,), device=dev),
        "w_b": dense_init(gen, stack + (d, N), dtype=cfg.dtype),
        "w_c": dense_init(gen, stack + (d, N), dtype=cfg.dtype),
        "a_log": torch.zeros(stack + (H,), device=dev),
        "d_skip": torch.ones(stack + (H,), device=dev),
        "out_proj": dense_init(gen, stack + (d_inner, d), dtype=cfg.dtype),
    }


def _causal_depthwise_conv(x, w, conv_state=None):
    """x: (B,S,C), w: (K,C). Returns (y, new_conv_state (B,K-1,C)). Taps
    are summed in the reference's order, tap 0 first."""
    K = w.shape[0]
    S = x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                     # (B, S+K-1, C)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, -(K - 1):]


def mamba2_preamble(cfg, p, x, peft_layer=None, lora_scale=1.0,
                    conv_state=None):
    """in_proj + depthwise conv + dt/B/C/decay streams: ``mamba2_mix`` up
    to the state recurrence. Returns (xh, dt, bmat, cmat, decay, z,
    conv_state); shared with the hybrid split forward, whose final site is
    the recurrence over ``xh * dt``."""
    B, S, D = x.shape
    s = cfg.ssm
    d_inner = s.expand * D
    hd = s.head_dim
    H = d_inner // hd

    zx = proj(x, p["in_proj"], lora=maybe_lora(peft_layer, "in_proj"),
              lora_scale=lora_scale)
    z, xb = torch.chunk(zx, 2, dim=-1)
    xb, conv_state = _causal_depthwise_conv(xb, p["conv_w"], conv_state)
    xb = F.silu(xb)

    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"])       # (B,S,H)
    a = -torch.exp(p["a_log"])                                  # (H,)
    decay = torch.exp(a[None, None] * dt)                       # (B,S,H)
    bmat = (x @ p["w_b"]).float()                               # (B,S,N)
    cmat = (x @ p["w_c"]).float()                               # (B,S,N)
    xh = xb.reshape(B, S, H, hd).float()
    return xh, dt, bmat, cmat, decay, z, conv_state


def mamba2_finish(cfg, p, y, z, xh, out_dtype, peft_layer=None,
                  lora_scale=1.0):
    """Skip connection + gate + output projection on the mixer output y
    ((B,S,H,hd) fp32): the mamba2 tail after the recurrence (the split
    forward's post side)."""
    B, S, H, hd = y.shape
    y = y + p["d_skip"][None, None, :, None] * xh
    y = (y.reshape(B, S, H * hd) * F.silu(z.float())).to(out_dtype)
    return proj(y, p["out_proj"], lora=maybe_lora(peft_layer, "out_proj"),
                lora_scale=lora_scale)


def mamba2_mixer_site(args):
    """Fresh-state recurrence on (xdt, bmat, cmat, decay): the dispatched op
    inside the estimator's forward-AD region, the plain scan otherwise. The
    hybrid split forward declares this call its fused-contraction site when
    the final layer's last mixer is the recurrence."""
    if dispatch.in_forward_ad_region():
        return dispatch.mamba2_mix(*args)
    return mamba2_scan_ref(*args)[0]


def mamba2_mix(cfg, p, x, peft_layer=None, lora_scale=1.0, state=None,
               conv_state=None):
    """x: (B,S,D). state: (B,H,hd,N) or None (zeros). Returns (out, state,
    conv_state); state is None on the forward-gradient fast path (fresh
    state inside the forward-AD region), whose losses never read it."""
    xh, dt, bmat, cmat, decay, z, conv_state = mamba2_preamble(
        cfg, p, x, peft_layer, lora_scale, conv_state)
    # the dt multiply hoisted out of the scan (an exact elementwise identity),
    # inline so that xh * dt and its K tangents are freed before the finish
    if state is None and dispatch.in_forward_ad_region():
        # one primal walk for all K tangents
        y = dispatch.mamba2_mix(xh * dt[..., None], bmat, cmat, decay)
    else:
        y, state = mamba2_scan_ref(xh * dt[..., None], bmat, cmat, decay, state)
    out = mamba2_finish(cfg, p, y, z, xh, x.dtype, peft_layer, lora_scale)
    return out, state, conv_state
