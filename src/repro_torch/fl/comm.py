"""Communication / computation cost accounting (paper Tables 2 & 3).

Analytic formulas, parameterised exactly as the paper: w_g total trainable
params, w_l params per trainable layer, L trainable layer count, M
participating clients, K perturbations per batch.

A copy of ``repro/fl/comm.py`` (plain arithmetic, no framework).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCost:
    client_to_server: float   # parameter count per round, per client aggregate
    server_to_client: float


def comm_cost(method: str, mode: str, w_l: float, L: int, M: int) -> CommCost:
    """Table 2 of the paper. ``mode`` is 'per_epoch' or 'per_iteration'."""
    w_g = w_l * L
    method = method.lower()
    backprop = method in ("fedavg", "fedyogi", "fedsgd")
    zeroorder = method in ("fedmezo", "fwdllm", "baffle")
    if backprop:
        return CommCost(w_g, w_g * M)
    if zeroorder:
        if mode == "per_epoch":
            return CommCost(w_g, w_g * M)
        return CommCost(1, (w_g + 1) * M)
    if method == "spry":
        layers_per_client = max(L / M, 1)
        if mode == "per_epoch":
            return CommCost(w_l * layers_per_client, w_l * max(L, M))
        return CommCost(1, w_l * max(L, M) + M)
    raise ValueError(method)


@dataclasses.dataclass(frozen=True)
class ComputeCost:
    client_per_iter: float
    server_per_round: float


def compute_cost(method: str, mode: str, w_l: float, L: int, M: int,
                 c: float, v: float, K: int = 1) -> ComputeCost:
    """Table 3 of the paper. c = per-layer matmul cost, v = jvp column
    overhead (≈0 under XLA fusion; kept for parity with the paper)."""
    method = method.lower()
    if method in ("fedavg", "fedyogi", "fedsgd"):
        return ComputeCost(3 * L * c, (M - 1) * w_l * L)
    if method == "fedmezo":
        server = (M - 1) * w_l * L if mode == "per_epoch" else 2 * M * w_l * L
        return ComputeCost(L * (2 * c + 3 * w_l), server)
    if method in ("fwdllm", "baffle"):
        server = (M - 1) * w_l * L if mode == "per_epoch" else 2 * M * w_l * L
        return ComputeCost(K * L * (2 * c + w_l), server)
    if method == "spry":
        client = 2 * max(L / M, 1) * (c + v) + w_l * L
        if mode == "per_epoch":
            groups = max(M / L, 1)
            server = (groups - 1) * w_l * max(L / M, 1) * min(L, M)
        else:
            server = 2 * max(M / L, 1) * w_l * max(L / M, 1) * min(L, M)
        return ComputeCost(client, server)
    raise ValueError(method)
