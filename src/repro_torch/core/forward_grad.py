"""Forward-mode AD gradient estimation (paper §2, Eq. 1-3).

Port of ``repro/core/forward_grad.py`` (all four ``forward_gradient``
routes and ``reconstruct_gradient``):

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
"""
from __future__ import annotations

import torch
from torch.func import jvp, vmap

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
    if injected is not None:
        n = tree_leaves(injected)[0].shape[0]
        vs = tree_map(lambda x: torch.stack(
            [x[i] if i < n else torch.zeros_like(x[0]) for i in indices]),
            injected)
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


def _jvp_one(loss_fn, peft32, v):
    with forward_ad_region():
        return jvp(loss_fn, (peft32,), (v,))


def _jvp_stacked(loss_fn, peft32, vs):
    """(loss, jvps (K,)) for stacked tangents with ONE primal pass."""
    with forward_ad_region():
        return vmap(lambda v: jvp(loss_fn, (peft32,), (v,)),
                    out_dims=(None, 0))(vs)


def forward_gradient(loss_fn, peft, key, k_perturbations=1, mask_tree=None,
                     jvp_clip=None, tangent_batch=None, perturbations=None):
    """Forward-gradient estimate of ∇_peft loss_fn -> (loss, grad, jvps (K,)).

    ``loss_fn`` is a function of the peft tree only. ``key`` is the
    estimate's integer key; ``perturbations`` optionally injects the K
    stacked (unmasked or masked) perturbations."""
    peft32 = tree_map(lambda x: x.float(), peft)
    K = int(k_perturbations)
    tb = K if tangent_batch is None else max(1, min(int(tangent_batch), K))
    draw = lambda idx: stacked_perturbations(  # noqa: E731
        key, peft32, idx, mask_tree, perturbations)

    def clip(jvps):
        return jvps if jvp_clip is None else torch.clamp(jvps, -jvp_clip, jvp_clip)

    if K == 1:
        vs = draw([0])
        loss, jv = _jvp_one(loss_fn, peft32, tree_map(lambda x: x[0], vs))
        jvps = clip(jv.reshape(1).float())
        return loss, _combine(jvps, vs, 1), jvps

    if tb == 1:
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
        loss, jvps = _jvp_stacked(loss_fn, peft32, vs)
        jvps = clip(jvps.float())
        return loss, _combine(jvps, vs, K), jvps

    # chunked: ceil(K/tb) groups, padded lanes masked out of the combine
    g = tree_map(torch.zeros_like, peft32)
    jvps_all = []
    for start in range(0, K, tb):
        idx = list(range(start, start + tb))
        vs_g = draw(idx)
        loss, jvps_g = _jvp_stacked(loss_fn, peft32, vs_g)
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
