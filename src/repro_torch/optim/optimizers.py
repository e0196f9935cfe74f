"""First-order optimizers over trees, optax calling convention.

Port of ``repro/optim/optimizers.py``:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_map, tree_norm, tree_zeros_like


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum m <- beta m + g; the step -lr m, or with
    ``nesterov`` -lr (beta m + g)."""
    def init(params):
        return {"m": tree_zeros_like(params)}

    def update(grads, state, params=None):
        m = tree_map(lambda mi, g: beta * mi + g, state["m"], grads)
        if nesterov:
            upd = tree_map(lambda mi, g: -lr * (beta * mi + g), m, grads)
        else:
            upd = tree_map(lambda mi: -lr * mi, m)
        return upd, {"m": m}

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    count: int
    m: Any
    v: Any


def _adam_core(lr, b1, b2, eps, weight_decay=0.0, second_moment="adam"):
    """Adam ('adam': v <- b2 v + (1-b2) g²) or Yogi
    ('yogi': v <- v - (1-b2) sign(v - g²) g²), with bias correction."""

    def init(params):
        return _AdamState(0, tree_zeros_like(params), tree_zeros_like(params))

    def update(grads, state, params=None):
        count = state.count + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state.m, grads)
        if second_moment == "adam":
            v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * (g * g), state.v, grads)
        else:
            v = tree_map(
                lambda vi, g: vi - (1 - b2) * torch.sign(vi - g * g) * (g * g),
                state.v, grads)
        c1 = 1 - b1 ** count
        c2 = 1 - b2 ** count

        def upd(mi, vi, p=None):
            step = -lr * (mi / c1) / (torch.sqrt(vi / c2) + eps)
            if weight_decay:
                step = step - lr * weight_decay * p
            return step

        if weight_decay:
            updates = tree_map(upd, m, v, params)
        else:
            updates = tree_map(upd, m, v)
        return updates, _AdamState(count, m, v)

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay)


def yogi(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, second_moment="yogi")


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (|grads| + 1e-12)), |grads|)."""
    norm = tree_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
