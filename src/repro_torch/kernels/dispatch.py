"""Forward-mode rules that route LoRA projections, attention mixers and
mamba2 recurrences to the multi-tangent kernels, and the cotangent-known
contraction ops of the fused-contraction route. Port of
``repro/kernels/dispatch.py`` (``lora_proj``, ``lora_proj_multi``,
``swa_attend``, ``mamba2_mix``, ``forward_ad_region``,
``lora_jvp_contract``, ``swa_jvp_contract``, ``mamba2_jvp_contract``).

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
reference does.

Reverse mode never reaches a kernel: ``lora_proj`` has a ``backward`` in
plain ops (the fused route reverses the post-head through it, and the
backprop baselines reverse the whole model), and outside the forward-AD
region the model's attention is plain ``attend_prefill``. ``swa_attend``
stays forward-only.

The contraction ops compute <gy, ydot> for a site whose output cotangent
gy is known: one tangent in ``forward``, K stacked tangents in ``vmap`` as
ONE T=K call of the ``*_mt_jvps`` epilogue, which never writes the (K, ...)
tangent output.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels.lora_dual.ops import (
    lora_dual_mt_jvps,
    lora_dual_mt_tangents,
    lora_dual_mt_tangents_ref,
    lora_dual_multi,
)
from repro_torch.kernels.mamba2_scan.ops import (
    mamba2_scan,
    mamba2_scan_mt_jvps,
    mamba2_scan_mt_tangents,
)
from repro_torch.kernels.swa_attention.ops import (
    swa_attention,
    swa_attention_mt_jvps,
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


def _one(t):
    """A single tangent as a T=1 stack for the kernel."""
    return None if t is None else t.contiguous()[None]


def _stack(t, dim, size):
    """A tangent with its batch axis first (broadcast if unbatched),
    contiguous for the kernel."""
    if t is None:
        return None
    t = t.movedim(dim, 0) if dim is not None else t.expand((size,) + t.shape)
    return t.contiguous()


def _materialize(t, like):
    """A missing tangent (the primal does not depend on the trainable tree,
    e.g. layer 0's B/C/decay) as explicit zeros, as the reference's
    ``_materialize``; the kernel still runs on it."""
    return torch.zeros_like(like) if t is None else t


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
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale

    @staticmethod
    def backward(ctx, gy):
        """Reverse mode in plain ops: gradients for x, A and B, and for the
        frozen W only when it requires one."""
        x, w, a, b = ctx.saved_tensors
        K, N = w.shape
        x2 = x.reshape(-1, K)
        g2 = gy.reshape(-1, N)
        gu = (g2.to(a.dtype) @ b.T) * ctx.scale                 # (M, r)
        gx = gw = ga = gb = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ w.T + (gu @ a.T).to(g2.dtype)).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = x2.T @ g2
        if ctx.needs_input_grad[2]:
            ga = x2.to(a.dtype).T @ gu
        if ctx.needs_input_grad[3]:
            gb = (x2.to(a.dtype) @ a).T @ g2.to(a.dtype) * ctx.scale
        return gx, gw, ga, gb, None

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
    """y = x@W + s*(x@A)@B with the multi-tangent forward-mode rule and a
    plain reverse-mode rule."""
    return _LoraProj.apply(x, w, a, b, scale)


def lora_proj_multi(x, idx, w, a_stack, b_stack, scale):
    """Serving's multi-adapter projection: row b of ``x`` (B, ..., K)
    projects through adapter page ``idx[b]`` of the (P, K, r) / (P, r, N)
    page stacks, one pass over the frozen W for the whole batch (the
    ``lora_dual_multi`` kernel on CUDA tensors, its plain version on CPU
    ones). The reference's ``custom_vmap`` only collapses JAX's per-row vmap
    into this one call; here the batch is one call already. No gradient,
    as in the reference: asking for one raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, a_stack, b_stack)):
        raise NotImplementedError("lora_proj_multi has no gradient (serving only)")
    return lora_dual_multi(x.contiguous(), idx, w, a_stack, b_stack, float(scale))


class _LoraContract(torch.autograd.Function):
    """<gy, ydot> of a LoRA projection for one tangent (forward) or K
    stacked tangents (vmap -> one T=K ``lora_dual_mt_jvps`` call)."""

    @staticmethod
    def forward(gy, x, w, a, b, xd, ad, bd, scale):
        return lora_dual_mt_jvps(x, w, a, _one(ad), b, _one(bd), gy, scale,
                                 xdots=_one(xd))[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, gy, x, w, a, b, xd, ad, bd, scale):
        if any(d is not None for d in in_dims[:5]):
            _primal_batched("lora_jvp_contract")
        n = info.batch_size
        return lora_dual_mt_jvps(
            x, w, a, _stack(ad, in_dims[6], n), b, _stack(bd, in_dims[7], n), gy,
            scale, xdots=_stack(xd, in_dims[5], n)), 0


def lora_jvp_contract(gy, x, w, a, b, ad, bd, xd=None, *, scale=1.0):
    """jvp partial <gy, ydot> of a LoRA projection site against its known
    output cotangent gy, for tangents (xd, ad, bd); ``xd=None`` removes the
    input-tangent terms (the projection's input carries no tangent)."""
    return _LoraContract.apply(gy.contiguous(), x.contiguous(), w.contiguous(),
                               a.contiguous(), b.contiguous(), xd, ad, bd,
                               float(scale))


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


class _SwaContract(torch.autograd.Function):
    """<gy, outd> of the attention mixer for one tangent (forward) or K
    stacked tangents (vmap -> one T=K ``swa_attention_mt_jvps`` call)."""

    @staticmethod
    def forward(gy, q, k, v, qd, kd, vd, window):
        return swa_attention_mt_jvps(q, k, v, _one(qd), _one(kd), _one(vd), gy,
                                     window)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, gy, q, k, v, qd, kd, vd, window):
        if any(d is not None for d in in_dims[:4]):
            _primal_batched("swa_jvp_contract")
        n = info.batch_size
        return swa_attention_mt_jvps(
            q, k, v, _stack(qd, in_dims[4], n), _stack(kd, in_dims[5], n),
            _stack(vd, in_dims[6], n), gy, window), 0


def swa_jvp_contract(gy, q, k, v, qd, kd, vd, window):
    """jvp partial <gy, outd> of an attention site (kernel layout) against
    its known output cotangent gy (B,H,S,hd)."""
    return _SwaContract.apply(gy.contiguous(), q.contiguous(), k.contiguous(),
                              v.contiguous(), qd, kd, vd, window)


# ---------------------------------------------------------------------------
# Mamba2 state recurrence (fresh state, the training path)
# ---------------------------------------------------------------------------

class _Mamba2Tangent(torch.autograd.Function):
    """ydot of the recurrence for one tangent (forward) or K stacked
    tangents (vmap -> one T=K ``mamba2_scan_mt_tangents`` call)."""

    @staticmethod
    def forward(xdt, bm, cm, dec, xd, bd, cd, dd):
        return mamba2_scan_mt_tangents(xdt, bm, cm, dec, _one(xd), _one(bd),
                                       _one(cd), _one(dd))[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, xdt, bm, cm, dec, xd, bd, cd, dd):
        if any(d is not None for d in in_dims[:4]):
            _primal_batched("mamba2_mix")
        n = info.batch_size
        return mamba2_scan_mt_tangents(
            xdt, bm, cm, dec, _stack(xd, in_dims[4], n), _stack(bd, in_dims[5], n),
            _stack(cd, in_dims[6], n), _stack(dd, in_dims[7], n)), 0


class _Mamba2Mix(torch.autograd.Function):
    @staticmethod
    def forward(xdt, bm, cm, dec):
        return mamba2_scan(xdt.contiguous(), bm.contiguous(), cm.contiguous(),
                           dec.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, xd, bd, cd, dd):
        prim = tuple(t.contiguous() for t in ctx.saved_tensors)
        tang = (_materialize(t, p) for t, p in zip((xd, bd, cd, dd), prim))
        return _Mamba2Tangent.apply(*prim, *tang)

    @staticmethod
    def vmap(info, in_dims, *args):
        _primal_batched("mamba2_mix")


def mamba2_mix(xdt, bmat, cmat, decay):
    """y (B,S,H,hd) of the Mamba2 recurrence from a fresh state: xdt
    (B,S,H,hd) fp32 (the dt-premultiplied input), bmat/cmat (B,S,N), decay
    (B,S,H). Primal through the scan kernel, tangents through the
    multi-tangent kernel."""
    return _Mamba2Mix.apply(xdt, bmat, cmat, decay)


class _Mamba2Contract(torch.autograd.Function):
    """<gy, ydot> of the recurrence for one tangent (forward) or K stacked
    tangents (vmap -> one T=K ``mamba2_scan_mt_jvps`` call)."""

    @staticmethod
    def forward(gy, xdt, bm, cm, dec, xd, bd, cd, dd):
        return mamba2_scan_mt_jvps(xdt, bm, cm, dec, _one(xd), _one(bd),
                                   _one(cd), _one(dd), gy)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, gy, xdt, bm, cm, dec, xd, bd, cd, dd):
        if any(d is not None for d in in_dims[:5]):
            _primal_batched("mamba2_jvp_contract")
        n = info.batch_size
        return mamba2_scan_mt_jvps(
            xdt, bm, cm, dec, _stack(xd, in_dims[5], n), _stack(bd, in_dims[6], n),
            _stack(cd, in_dims[7], n), _stack(dd, in_dims[8], n), gy), 0


def mamba2_jvp_contract(gy, xdt, bmat, cmat, decay, xd, bd, cd, dd):
    """jvp partial <gy, ydot> of a mamba2 site against its known output
    cotangent gy (B,S,H,hd); K stacked tangents make ONE
    ``mamba2_scan_mt_jvps`` launch, which writes no (K,B,S,H,hd) output."""
    prim = tuple(t.contiguous() for t in (xdt, bmat, cmat, decay))
    tang = (_materialize(t, p) for t, p in zip((xd, bd, cd, dd), prim))
    return _Mamba2Contract.apply(gy.float().contiguous(), *prim, *tang)
