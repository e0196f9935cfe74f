"""Server-side federated optimizers (paper §3.1, Reddi et al. AFO).

Port of ``repro/fl/server.py``: the aggregated client delta is a pseudo-
gradient for FedAvg / FedSGD / FedAdam / FedYogi / FedAdagrad. Pure
functions over trees; nothing is updated in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.pytree import tree_map, tree_zeros_like


class ServerState(NamedTuple):
    count: int
    m: Any            # first moment of deltas
    v: Any            # second moment of deltas


def server_init(params) -> ServerState:
    return ServerState(0, tree_zeros_like(params), tree_zeros_like(params))


def server_update(kind: str, params, delta, state: ServerState, lr: float,
                  b1: float = 0.9, b2: float = 0.99, tau: float = 1e-3):
    """One server-optimizer step -> (new_params, new_state)."""
    count = state.count + 1
    if kind in ("fedavg", "fedsgd"):
        new_params = tree_map(lambda p, d: (p + lr * d).to(p.dtype), params, delta)
        return new_params, ServerState(count, state.m, state.v)

    m = tree_map(lambda mi, d: b1 * mi + (1 - b1) * d, state.m, delta)
    if kind == "fedadam":
        v = tree_map(lambda vi, d: b2 * vi + (1 - b2) * d * d, state.v, delta)
    elif kind == "fedyogi":
        v = tree_map(
            lambda vi, d: vi - (1 - b2) * torch.sign(vi - d * d) * (d * d),
            state.v, delta)
    elif kind == "fedadagrad":
        v = tree_map(lambda vi, d: vi + d * d, state.v, delta)
    else:
        raise ValueError(f"unknown server optimizer {kind!r}")

    new_params = tree_map(
        lambda p, mi, vi: (p + lr * mi / (torch.sqrt(vi) + tau)).to(p.dtype),
        params, m, v)
    return new_params, ServerState(count, m, v)
