"""State-space sequence mixers: the Mamba2 half of ``repro/models/ssm.py``
(the RWKV6 half comes with the rwkv6 family's slice).

Outside the estimator (eval, backprop baselines) the recurrence is the
plain scan, as in the reference. Inside the estimator's forward-AD region,
from a fresh state, it goes through ``dispatch.mamba2_mix``: the scan
kernel for the primal and the multi-tangent kernel for all K tangents.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan_ref
from repro_torch.models.common import dense_init, maybe_lora, proj


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
