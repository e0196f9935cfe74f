"""Forward-mode AD gradient estimation (paper §2, Eq. 1-3).

Port of ``repro/core/forward_grad.py`` (all four ``forward_gradient``
routes on both estimator routes, ``SplitLoss`` and ``reconstruct_gradient``):

    jvp      = J_f(w) · v           — directional derivative along v
    grad_est = jvp * v              — unbiased estimator of ∇f, v ~ N(0, I)

K perturbations are stacked on a leading tangent axis. The batched route
runs ``torch.func.vmap`` over ``torch.func.jvp``: the primal runs once per
estimate and, through ``kernels/dispatch``, each LoRA projection and
attention site launches ONE multi-tangent kernel for all K tangents.

Random numbers. Perturbation i of an estimate with integer key ``key``
comes from a ``torch.Generator`` on the tree's device seeded with
``fold_in(key, i)``, drawing one standard normal per leaf in sorted-key
leaf order. So perturbation i does not depend on how the K are grouped
(every route sees the same v_i), and the server regenerates the client's
exact perturbations from the key alone. Tests can inject perturbations
(``perturbations=``, a stacked tree) to feed both packages the same noise.

``tangent_batch``:
    None / >=K  one batched pass (one primal, one kernel launch per site)
    1           sequential full jvp passes, the primal recomputed K times
    1<b<K       ceil(K/b) groups of b tangents, K padded to a multiple of b
                with masked-out lanes. Each group recomputes the primal: the
                reference linearizes once, but ``torch.func.linearize``
                traces through make_fx, which cannot carry the kernels'
                ctypes calls.

Fused contraction. With ``fused_contraction=True`` and a ``SplitLoss`` (a
loss that declares its final mixer site, ``loss(p) = post(site(args), ctx,
p)`` with ``(args, ctx) = pre(p)``), the post-head is reversed ONCE for the
cotangents (gy, g_ctx, g_p), and each tangent's site term <gy, ydot_t> comes
from the dispatch layer's ``*_jvp_contract`` ops, whose vmap rule makes ONE
``*_mt_jvps`` epilogue call for all K: the site's (K, ...) tangent output
is never formed. One function under ``vmap`` over the stacked tangents does
it all: the jvp of ``pre`` (its primal runs once, unbatched), the site
primal, the ``vjp`` of the post-head (unbatched inputs, so it runs once),
then the contraction. The jvp scalars equal the standard route's up to
float reassociation; the loss is bitwise the same.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
from torch.func import jvp, vjp, vmap

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import forward_ad_region
from repro_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """Derive a child key from (key, data): splitmix64 of the pair. Plays
    the role of ``jax.random.fold_in`` for the port's integer keys."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E5) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _device(tree):
    return tree_leaves(tree)[0].device


def masked_perturbation(key, peft, mask_tree=None):
    """v ~ N(0, I) over the trainable tree (fp32), zeroed outside the
    client's assigned units."""
    gen = torch.Generator(device=_device(peft))
    gen.manual_seed(key)
    v = tree_unflatten_like(peft, [
        torch.randn(leaf.shape, generator=gen, device=leaf.device)
        for leaf in tree_leaves(peft)])
    if mask_tree is not None:
        v = tree_map(lambda vi, m: vi * m, v, mask_tree)
    return v


def stacked_perturbations(key, peft, indices, mask_tree=None, injected=None):
    """Perturbations ``fold_in(key, i) for i in indices`` stacked on a
    leading tangent axis. With ``injected`` (a stacked tree of at least
    max(indices)+1 rows) row i is taken from it instead; indices past its
    end (padded lanes) get zeros."""
    if injected is not None:          # rebuilt in peft's own key order
        n = tree_leaves(injected)[0].shape[0]
        vs = tree_map(lambda _, x: torch.stack(
            [x[i] if i < n else torch.zeros_like(x[0]) for i in indices]),
            peft, injected)
        if mask_tree is not None:
            vs = tree_map(lambda vi, m: vi * m, vs, mask_tree)
        return vs
    per = [masked_perturbation(fold_in(key, i), peft, mask_tree) for i in indices]
    return tree_map(lambda *xs: torch.stack(xs), *per)


def _combine(jvps, vs, k_total):
    """g = (1/K) Σ_i jvps[i] · vs[i]. Shared by the client estimator and the
    server reconstruction so the two are bit-identical."""
    return tree_map(
        lambda v: torch.tensordot(jvps, v, dims=([0], [0])) / k_total, vs)


# ---------------------------------------------------------------------------
# Split losses: a declared final mixer site for the fused-contraction route
# ---------------------------------------------------------------------------

class SplitLoss:
    """A loss with a declared final mixer site:

        loss(p) = post(site(site_args), ctx, p),  (site_args, ctx) = pre(p)

    ``kind`` selects the site op and its contraction epilogue:

        'lora'  site_args = (x, w, a, b), static ``scale``
                -> dispatch.lora_proj / lora_jvp_contract
        'swa'   site_args = (q, k, v), static ``window``
                -> dispatch.swa_attend / swa_jvp_contract

    ('wkv6' and 'mamba2', the recurrent families' sites, come with the port
    of those families.) ``ctx`` is any side output of ``pre`` the post-head
    also needs (None if none). Calling the object evaluates the composition,
    so it is a drop-in ``loss_fn``. ``x_has_tangent=False`` (lora only)
    declares that x does not depend on the trainable tree, which removes
    the input-tangent terms from the epilogue. ``site_fn`` overrides the
    site primal (the registry passes the model's own mixer, so the split
    loss runs exactly the plain loss's ops)."""

    def __init__(self, pre: Callable, kind: str, post: Callable, *,
                 scale: float = 1.0, window: Optional[int] = None,
                 x_has_tangent: bool = True, site_fn: Optional[Callable] = None):
        if kind in ("wkv6", "mamba2"):
            raise NotImplementedError(
                f"SplitLoss kind {kind!r} is not ported yet: it comes with the "
                f"{'rwkv6 (ssm)' if kind == 'wkv6' else 'zamba2 (hybrid)'} "
                f"family's slice of repro_torch")
        if kind not in ("lora", "swa"):
            raise ValueError(f"unknown site kind {kind!r}")
        self.pre = pre
        self.kind = kind
        self.post = post
        self.scale = scale
        self.window = window
        self.x_has_tangent = x_has_tangent
        self.site_fn = site_fn

    def site(self, args):
        if self.site_fn is not None:
            return self.site_fn(args)
        if self.kind == "lora":
            return dispatch.lora_proj(*args, self.scale)
        return dispatch.swa_attend(*args, self.window)

    def __call__(self, p):
        args, ctx = self.pre(p)
        return self.post(self.site(args), ctx, p)


def _tree_vdot(g, t):
    """Σ_leaves <g, t> in fp32, leaves in leaf order (0.0 for empty trees)."""
    total = None
    for a, b in zip(tree_leaves(g), tree_leaves(t)):
        d = torch.sum(a.float() * b.float())
        total = d if total is None else total + d
    return torch.zeros(()) if total is None else total


def _site_contract(loss_fn, gy, site_args, argdots):
    """<gy, site tangent> through the kind's contraction op."""
    if loss_fn.kind == "lora":
        x, w, a, b = site_args
        xd, wd, ad, bd = argdots
        val = dispatch.lora_jvp_contract(
            gy, x, w, a, b, ad, bd, xd=xd if loss_fn.x_has_tangent else None,
            scale=loss_fn.scale)
        # frozen-W term <gy, x @ wd> = <x^T gy, wd>: wd is exact zeros when W
        # is frozen, kept so the arithmetic is the reference's
        zw = torch.einsum("...k,...n->kn", x.float(), gy.float())
        return val + _tree_vdot(zw, wd)
    return dispatch.swa_jvp_contract(gy, *site_args, *argdots, loss_fn.window)


def fused_jvps(loss_fn: SplitLoss, peft32, vs):
    """(loss, jvps (K,)) on the fused-contraction route for the stacked
    tangents ``vs``: one primal of ``pre``, one site primal, one reversal of
    the post-head and one contraction-epilogue launch for all K."""
    def pre(p):          # torch.func takes no None output: ctx rides in a dict
        args, ctx = loss_fn.pre(p)
        return args, {} if ctx is None else {"ctx": ctx}

    def post(y, ctx, p):
        return loss_fn.post(y, ctx.get("ctx"), p)

    def one(v):
        with forward_ad_region():
            (site_args, ctx), (argdots, ctxdot) = jvp(pre, (peft32,), (v,))
            # the site primal in the region, as on the standard route, so a
            # region-gated site_fn takes the same branch (loss bitwise equal)
            y = loss_fn.site(site_args)
        loss, post_vjp = vjp(post, y, ctx, peft32)
        gy, g_ctx, g_p = post_vjp(torch.ones_like(loss))
        val = _site_contract(loss_fn, gy, site_args, argdots)
        return loss, val + _tree_vdot(g_ctx, ctxdot) + _tree_vdot(g_p, v)
    return vmap(one, out_dims=(None, 0))(vs)


# losses already warned about when fused_contraction was asked for but the
# loss declares no site, keyed by the function's definition site
_warned_unsplit_losses: set = set()


def _unsplit_key(loss_fn):
    fn = getattr(loss_fn, "func", loss_fn)       # unwrap functools.partial
    code = getattr(fn, "__code__", None)
    if code is not None:
        return (code.co_filename, code.co_firstlineno)
    return (type(fn).__module__, type(fn).__qualname__)


def _warn_unsplit_fallback(loss_fn):
    key = _unsplit_key(loss_fn)
    if key in _warned_unsplit_losses:
        return
    _warned_unsplit_losses.add(key)
    fn = getattr(loss_fn, "func", loss_fn)
    name = (getattr(fn, "__name__", None) or getattr(loss_fn, "__name__", None)
            or type(loss_fn).__name__)
    warnings.warn(
        f"fused_contraction=True was requested but loss {name!r} does not "
        f"declare a final mixer site (not a SplitLoss); taking the standard "
        f"materializing tangent route instead. Build the loss with "
        f"repro_torch.models.registry.get_loss_fn(task, split=True) to run "
        f"the fused jvp-contraction epilogues.", stacklevel=3)


def _jvp_one(loss_fn, peft32, v):
    with forward_ad_region():
        return jvp(loss_fn, (peft32,), (v,))


def _jvp_stacked(loss_fn, peft32, vs):
    """(loss, jvps (K,)) for stacked tangents with ONE primal pass."""
    with forward_ad_region():
        return vmap(lambda v: jvp(loss_fn, (peft32,), (v,)),
                    out_dims=(None, 0))(vs)


def forward_gradient(loss_fn, peft, key, k_perturbations=1, mask_tree=None,
                     jvp_clip=None, tangent_batch=None, perturbations=None,
                     fused_contraction=False):
    """Forward-gradient estimate of ∇_peft loss_fn -> (loss, grad, jvps (K,)).

    ``loss_fn`` is a function of the peft tree only. ``key`` is the
    estimate's integer key; ``perturbations`` optionally injects the K
    stacked (unmasked or masked) perturbations. ``fused_contraction`` takes
    the fused route when ``loss_fn`` is a ``SplitLoss`` (K=1 and
    ``tangent_batch=1`` then go through the batched and chunked paths);
    any other loss keeps the standard route with a one-time warning."""
    peft32 = tree_map(lambda x: x.float(), peft)
    K = int(k_perturbations)
    tb = K if tangent_batch is None else max(1, min(int(tangent_batch), K))
    fused = fused_contraction and isinstance(loss_fn, SplitLoss)
    if fused_contraction and not fused:
        _warn_unsplit_fallback(loss_fn)
    stacked = fused_jvps if fused else _jvp_stacked
    draw = lambda idx: stacked_perturbations(  # noqa: E731
        key, peft32, idx, mask_tree, perturbations)

    def clip(jvps):
        return jvps if jvp_clip is None else torch.clamp(jvps, -jvp_clip, jvp_clip)

    if K == 1 and not fused:
        vs = draw([0])
        loss, jv = _jvp_one(loss_fn, peft32, tree_map(lambda x: x[0], vs))
        jvps = clip(jv.reshape(1).float())
        return loss, _combine(jvps, vs, 1), jvps

    if tb == 1 and not fused:
        g = tree_map(torch.zeros_like, peft32)
        jvps = []
        loss_acc = 0.0
        for i in range(K):
            v = tree_map(lambda x: x[0], draw([i]))
            loss, jv = _jvp_one(loss_fn, peft32, v)
            jv = clip(jv.float())
            g = tree_map(lambda gi, vi: gi + jv * vi, g, v)
            jvps.append(jv)
            loss_acc = loss_acc + loss
        return loss_acc / K, tree_map(lambda x: x * (1.0 / K), g), torch.stack(jvps)

    if tb >= K:
        vs = draw(list(range(K)))
        loss, jvps = stacked(loss_fn, peft32, vs)
        jvps = clip(jvps.float())
        return loss, _combine(jvps, vs, K), jvps

    # chunked: ceil(K/tb) groups, padded lanes masked out of the combine
    g = tree_map(torch.zeros_like, peft32)
    jvps_all = []
    for start in range(0, K, tb):
        idx = list(range(start, start + tb))
        vs_g = draw(idx)
        loss, jvps_g = stacked(loss_fn, peft32, vs_g)
        live = torch.tensor([float(i < K) for i in idx], device=jvps_g.device)
        jvps_g = clip(jvps_g.float()) * live
        g = tree_map(torch.add, g, _combine(jvps_g, vs_g, K))
        jvps_all.append(jvps_g)
    return loss, g, torch.cat(jvps_all)[:K]


def reconstruct_gradient(peft_template, key, jvps, mask_tree=None,
                         perturbations=None):
    """Server-side rebuild from the jvp scalars and the shared key (per-
    iteration mode, paper §3.2): the same perturbations and the same
    ``_combine`` as the client's batched estimate, so bit-identical."""
    K = jvps.shape[0]
    template32 = tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                          peft_template)
    vs = stacked_perturbations(key, template32, list(range(K)), mask_tree,
                               perturbations)
    return _combine(jvps, vs, K)
