"""Forward-mode rules that route LoRA projections and attention mixers to
the multi-tangent kernels. Port of ``repro/kernels/dispatch.py``
(``lora_proj``, ``swa_attend``, ``forward_ad_region``).

The reference pairs ``jax.custom_jvp`` with ``custom_vmap``; here each op is
a ``torch.autograd.Function`` with a ``jvp`` staticmethod, and its tangent
part is a second ``Function`` whose ``vmap`` staticmethod maps K stacked
tangents to ONE T=K call of the multi-tangent kernel. Under the estimator's
``torch.func.vmap(torch.func.jvp(loss))`` the primal ops see unbatched
tensors and run once, and each site's K tangents become one launch.

There is no backend switch: a wrapper given CPU tensors runs its plain
PyTorch version, given CUDA tensors it launches its kernel or raises.
``forward_ad_region()`` (a contextvar set by the estimator) decides whether
the tangent kernels are used at all: outside it the LoRA rule computes its
tangent with plain ops and the model keeps its plain attention path, as the
reference does. The kernels have no reverse-mode rule.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels.lora_dual.ops import (
    lora_dual_mt_tangents,
    lora_dual_mt_tangents_ref,
)
from repro_torch.kernels.swa_attention.ops import (
    swa_attention,
    swa_attention_mt_tangents,
)

_fwd_region = contextvars.ContextVar("repro_torch_forward_ad_region", default=False)


@contextlib.contextmanager
def forward_ad_region():
    """Within this context LoRA-projection and attention tangents go to the
    multi-tangent kernels."""
    token = _fwd_region.set(True)
    try:
        yield
    finally:
        _fwd_region.reset(token)


def in_forward_ad_region() -> bool:
    return _fwd_region.get()


def _stack(t, dim, size):
    """A tangent with its batch axis first (broadcast if unbatched),
    contiguous for the kernel."""
    if t is None:
        return None
    t = t.movedim(dim, 0) if dim is not None else t.expand((size,) + t.shape)
    return t.contiguous()


def _primal_batched(name):
    raise NotImplementedError(
        f"{name}: a batched primal is not supported; vmap the tangents only")


# ---------------------------------------------------------------------------
# LoRA projection
# ---------------------------------------------------------------------------

def _lora_terms(x, a, b, scale):
    """s*(x@A)@B in A's dtype (fp32 master LoRA weights)."""
    return (x.to(a.dtype) @ a) @ b * scale


class _LoraTangent(torch.autograd.Function):
    """ydot of the LoRA projection for one tangent (forward) or K stacked
    tangents (vmap -> one T=K kernel call)."""

    @staticmethod
    def forward(x, w, a, b, xd, ad, bd, scale):
        return lora_dual_mt_tangents(
            x, None if xd is None else xd.contiguous()[None], w, a,
            ad.contiguous()[None], b, bd.contiguous()[None], scale)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, w, a, b, xd, ad, bd, scale):
        if any(d is not None for d in in_dims[:4]):
            _primal_batched("lora_proj")
        n = info.batch_size
        return lora_dual_mt_tangents(
            x, _stack(xd, in_dims[4], n), w, a, _stack(ad, in_dims[5], n), b,
            _stack(bd, in_dims[6], n), scale), 0


class _LoraProj(torch.autograd.Function):
    @staticmethod
    def forward(x, w, a, b, scale):
        y = x @ w
        return y + _lora_terms(x, a, b, scale).to(y.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, a, b, scale = inputs
        ctx.save_for_forward(x, w, a, b)
        ctx.scale = scale

    @staticmethod
    def jvp(ctx, xd, wd, ad, bd, _):
        x, w, a, b = ctx.saved_tensors
        ad = torch.zeros_like(a) if ad is None else ad
        bd = torch.zeros_like(b) if bd is None else bd
        if in_forward_ad_region():
            yd = _LoraTangent.apply(x.contiguous(), w, a.contiguous(),
                                    b.contiguous(), xd, ad, bd, ctx.scale)
        else:
            yd = lora_dual_mt_tangents_ref(
                x, None if xd is None else xd[None], w, a, ad[None], b,
                bd[None], ctx.scale)[0]
        if wd is not None:  # frozen W in SPRY; kept for AD completeness
            yd = yd + (x @ wd).to(yd.dtype)
        return yd

    @staticmethod
    def vmap(info, in_dims, *args):
        _primal_batched("lora_proj")


def lora_proj(x, w, a, b, scale):
    """y = x@W + s*(x@A)@B with the multi-tangent forward-mode rule."""
    return _LoraProj.apply(x, w, a, b, scale)


# ---------------------------------------------------------------------------
# Causal (sliding-window) GQA attention
# ---------------------------------------------------------------------------

class _SwaTangent(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, qd, kd, vd, window):
        return swa_attention_mt_tangents(
            q, k, v, qd.contiguous()[None], kd.contiguous()[None],
            vd.contiguous()[None], window)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, qd, kd, vd, window):
        if any(d is not None for d in in_dims[:3]):
            _primal_batched("swa_attend")
        n = info.batch_size
        return swa_attention_mt_tangents(
            q, k, v, _stack(qd, in_dims[3], n), _stack(kd, in_dims[4], n),
            _stack(vd, in_dims[5], n), window), 0


class _SwaAttend(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, window):
        return swa_attention(q.contiguous(), k.contiguous(), v.contiguous(), window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window = inputs
        ctx.save_for_forward(q, k, v)
        ctx.window = window

    @staticmethod
    def jvp(ctx, qd, kd, vd, _):
        q, k, v = (t.contiguous() for t in ctx.saved_tensors)
        qd, kd, vd = (torch.zeros_like(p) if t is None else t
                      for p, t in ((q, qd), (k, kd), (v, vd)))
        return _SwaTangent.apply(q, k, v, qd, kd, vd, ctx.window)

    @staticmethod
    def vmap(info, in_dims, *args):
        _primal_batched("swa_attend")


def swa_attend(q, k, v, window):
    """Causal (sliding-window) GQA attention in kernel layout: q (B,H,S,hd);
    k,v (B,KV,S,hd). Primal through the flash kernel, tangents through the
    multi-tangent kernel."""
    return _SwaAttend.apply(q, k, v, window)
