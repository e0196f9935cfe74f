"""Mixture-of-Experts block: top-k routing with GShard capacity dispatch
per router chunk, the shared expert and the Switch aux loss. Port of
``repro/models/moe.py``.

The tokens are cut into chunks of ``router_chunk`` (the tail padded to a
whole chunk and dropped after); each chunk routes on its own, so an
expert's capacity C = max(4, int(T k capacity_factor / E)) counts the
chunk's T tokens, and which tokens an expert drops depends on which tokens
share its chunk. Dispatch and combine are the reference's one-hot einsums
(exact: one non-zero term a sum). The routing decisions (top-k indices,
positions in an expert's queue) are taken on the primal, out of place, so
the block runs unchanged under the estimator's ``vmap(jvp(...))``: the
tangents flow through the gates and the token values only. The expert
products (E, C, D) x (E, D, F) go through ``expert_matmul``, whose rule for
K stacked tangents folds K into each expert's rows: torch's own batching
rule for a batched matmul expands the frozen (E, D, F) weights K times
(40 GiB for one layer of llama4-maverick's experts at K=4).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def moe_params(cfg, gen, layers=None):
    d, m = cfg.d_model, cfg.moe
    f = m.d_expert
    stack = (layers,) if layers else ()
    p = {
        "router": dense_init(gen, stack + (d, m.n_experts), dtype=torch.float32),
        "wi": dense_init(gen, stack + (m.n_experts, d, f), dtype=cfg.dtype),
        "wg": dense_init(gen, stack + (m.n_experts, d, f), dtype=cfg.dtype),
        "wd": dense_init(gen, stack + (m.n_experts, f, d), dtype=cfg.dtype),
    }
    if m.n_shared_experts:
        sf = f * m.n_shared_experts
        p["shared"] = {
            "wi": dense_init(gen, stack + (d, sf), dtype=cfg.dtype),
            "wg": dense_init(gen, stack + (d, sf), dtype=cfg.dtype),
            "wd": dense_init(gen, stack + (sf, d), dtype=cfg.dtype),
        }
    return p


class _ExpertTangent(torch.autograd.Function):
    """xd @ w per expert for one tangent (forward) or K stacked tangents
    (vmap: K folded into the rows, w read as it is)."""

    @staticmethod
    def forward(xd, w):
        return torch.bmm(xd, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, xd, w):
        # w is the primal weight: never batched
        xd = xd.movedim(in_dims[0], 1)                       # (E, K, C, D)
        E, K, C, D = xd.shape
        out = torch.bmm(xd.reshape(E, K * C, D), w)
        return out.reshape(E, K, C, w.shape[-1]), 1


class _ExpertMatmul(torch.autograd.Function):
    @staticmethod
    def forward(x, w):
        return torch.bmm(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        # no zeros for the frozen weights' missing tangent and gradient (one
        # layer of llama4-maverick's experts is 10 GiB in bf16)
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*inputs)
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        x, w = ctx.saved_tensors
        gx = torch.bmm(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(x.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return gx, gw

    @staticmethod
    def jvp(ctx, xd, wd):
        x, w = ctx.saved_tensors
        yd = None if xd is None else _ExpertTangent.apply(xd, w)
        if wd is not None:          # frozen in SPRY; kept for AD completeness
            yd = torch.bmm(x, wd) if yd is None else yd + torch.bmm(x, wd)
        return yd

    @staticmethod
    def vmap(info, in_dims, x, w):
        raise NotImplementedError("expert_matmul: a batched primal is not supported; "
                                  "vmap the tangents only")


def expert_matmul(x, w):
    """(E, C, D) x (E, D, F) -> (E, C, F), one product per expert."""
    return _ExpertMatmul.apply(x, w)


def _capacity(n_tokens: int, m) -> int:
    return max(4, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def _top_k(gates, k):
    """The k largest gates of each row and their indices, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` promises none): a stable
    descending sort of the primal, then a gather that keeps the tangent."""
    idx = torch.sort(gates.detach(), dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(gates, -1, idx), idx


def _dispatch_chunk(cfg, p, chunk):
    """chunk (T, D) -> (out (T, D), aux scalar fp32). Each token goes to its
    top-k experts in token order; a token past an expert's capacity C is
    dropped for that expert."""
    m = cfg.moe
    T = chunk.shape[0]
    E, C = m.n_experts, _capacity(T, m)
    experts = torch.arange(E, device=chunk.device)
    slots = torch.arange(C, device=chunk.device)

    gates = torch.softmax(chunk.float() @ p["router"], dim=-1)     # (T, E)
    topg, topi = _top_k(gates, m.top_k)                             # (T, k)
    topg = topg / torch.clamp(topg.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e (fraction of tokens_e * mean gate_e); the
    # token fractions count first choices (no tangent)
    ce = (topi[:, :1] == experts).float().sum(0) / T
    aux = E * torch.sum(gates.mean(0) * ce)

    counts = torch.zeros(E, dtype=torch.long, device=chunk.device)
    dispatch = torch.zeros((T, E, C), dtype=chunk.dtype, device=chunk.device)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=chunk.device)
    for j in range(m.top_k):
        onehot = (topi[:, j, None] == experts).long()                 # (T, E)
        pos = torch.cumsum(onehot, dim=0) - 1 + counts                # queue slot
        counts = counts + onehot.sum(0)
        keep = (onehot == 1) & (pos < C)
        d_j = keep[..., None] & (pos.clamp(0, C - 1)[..., None] == slots)   # (T, E, C)
        dispatch = dispatch + d_j.to(chunk.dtype)
        combine = combine + d_j.float() * topg[:, j, None, None]

    xe = torch.einsum("tec,td->ecd", dispatch, chunk)                # (E, C, D)
    up = expert_matmul(xe, p["wi"])
    gate = expert_matmul(xe, p["wg"])
    ye = expert_matmul(activation(cfg, gate) * up, p["wd"])
    out = torch.einsum("tec,ecd->td", combine.to(chunk.dtype), ye)
    if m.n_shared_experts:
        s = p["shared"]
        sh = activation(cfg, chunk @ s["wg"]) * (chunk @ s["wi"])
        out = out + sh @ s["wd"]
    return out, aux


def moe_block(cfg, p, x):
    """x (B, S, D) -> (out (B, S, D), aux): the mean of the chunks' aux."""
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    T = tokens.shape[0]
    chunk = min(cfg.moe.router_chunk, T)
    n = -(-T // chunk)
    if n * chunk != T:            # pad to a whole number of chunks
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, n * chunk - T))
    if n == 1:
        out, aux = _dispatch_chunk(cfg, p, tokens)
    else:
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(n):
            out_c, aux_c = _dispatch_chunk(cfg, p, tokens[c * chunk:(c + 1) * chunk])
            outs.append(out_c)
            aux = aux + aux_c
        out, aux = torch.cat(outs), aux / n
    return out[:T].reshape(B, S, D), aux
