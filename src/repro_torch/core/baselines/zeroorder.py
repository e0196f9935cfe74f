"""Zero-order (finite-difference) FL baselines: FedMeZO, BAFFLE+, FwdLLM+.

Port of ``repro/core/baselines/zeroorder.py``, the memory-improved variants
the paper builds (only the trainable PEFT weights are perturbed):

  FedMeZO : 1 central-difference perturbation per batch
  BAFFLE+ : K (default 20) perturbations averaged
  FwdLLM+ : K candidates; keep the one whose direction best matches the
            previous round's aggregated gradient (cosine similarity), and
            drop clients whose finite-difference variance is too high

Perturbation i of client m in round r is drawn from the port's key chain
``fold_in(fold_in(fold_in(seed, r), m), i)`` (one ``torch.Generator`` per
draw, as ``forward_grad.masked_perturbation``). The clients only run primal
forwards outside the forward-AD region, so no kernel is launched.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.forward_grad import fold_in, masked_perturbation
from repro_torch.core.spry import SpryState
from repro_torch.fl.server import server_update
from repro_torch.models.registry import get_loss_fn
from repro_torch.utils.pytree import tree_dot, tree_map, tree_norm

ZO_DEFAULTS = {
    "fedmezo": dict(k=1, eps=1e-3),
    "baffle": dict(k=20, eps=1e-4),
    "fwdllm": dict(k=10, eps=1e-2, var_threshold=10.0),
}


class ZOState(NamedTuple):
    inner: SpryState
    prev_grad: Any          # FwdLLM's guidance direction


def init_zo_state(state: SpryState) -> ZOState:
    return ZOState(state, tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                                   state.peft))


def _central_difference(loss_fn, peft, v, eps):
    """(f(w + eps v) - f(w - eps v)) / (2 eps): two forward passes."""
    plus = tree_map(lambda p, vi: p + eps * vi, peft, v)
    minus = tree_map(lambda p, vi: p - eps * vi, peft, v)
    return (loss_fn(plus) - loss_fn(minus)) / (2.0 * eps)


def make_zeroorder_round_step(cfg, spry_cfg, task: str = "cls",
                              method: str = "fedmezo", **overrides):
    """round_step(zo_state, batch, perturbations=None) -> (zo_state,
    metrics). ``perturbations[m]``, a tree of client m's K perturbations
    stacked on a leading axis, replaces the drawn ones (tests feed both
    packages the same noise). For fwdllm, ``metrics["choice"]`` holds each
    client's chosen candidate."""
    loss_fn_kind = get_loss_fn(task)
    M = spry_cfg.n_clients_per_round
    hp = dict(ZO_DEFAULTS[method])
    hp.update(overrides)
    K, eps = hp["k"], hp["eps"]

    def client_update(base, peft, prev_grad, ckey, client_batch, injected):
        def loss_of(p):
            return loss_fn_kind(cfg, base, p, client_batch,
                                lora_scale=spry_cfg.lora_alpha)

        def one(i):
            v = (masked_perturbation(fold_in(ckey, i), peft) if injected is None
                 else tree_map(lambda x: x[i], injected))
            return v, _central_difference(loss_of, peft, v, eps)

        choice = None
        if method == "fwdllm":
            gs, coss, fds = [], [], []
            for i in range(K):
                v, fd = one(i)
                g = tree_map(lambda vi: fd * vi, v)
                gs.append(g)
                coss.append(tree_dot(g, prev_grad)
                            / (tree_norm(g) * tree_norm(prev_grad) + 1e-9))
                fds.append(fd)
            choice = int(torch.argmax(torch.stack(coss)))
            keep = (torch.var(torch.stack(fds), unbiased=False)
                    < hp["var_threshold"]).float()
            g = tree_map(lambda x: x * keep, gs[choice])
        else:
            g = tree_map(lambda p: torch.zeros(p.shape, device=p.device), peft)
            for i in range(K):
                v, fd = one(i)
                g = tree_map(lambda gi, vi: gi + fd * vi / K, g, v)
        delta = tree_map(lambda gi: -spry_cfg.local_lr * gi, g)
        return delta, loss_of(peft), g, choice

    def round_step(zo_state: ZOState, batch, perturbations=None):
        state = zo_state.inner
        base, peft = state.base, state.peft
        round_key = fold_in(spry_cfg.seed, state.round_idx)
        outs = [client_update(base, peft, zo_state.prev_grad, fold_in(round_key, m),
                              {k: v[m] for k, v in batch.items()},
                              None if perturbations is None else perturbations[m])
                for m in range(M)]
        deltas, losses, grads, choices = zip(*outs)
        mean = lambda trees: tree_map(  # noqa: E731
            lambda *xs: torch.stack(xs).mean(0), *trees)
        new_peft, server = server_update(spry_cfg.server_opt, peft, mean(deltas),
                                         state.server, lr=spry_cfg.server_lr)
        metrics = {"loss": torch.stack(losses).mean()}
        if method == "fwdllm":
            metrics["choice"] = torch.tensor(choices)
        new_inner = SpryState(base, new_peft, server, state.round_idx + 1)
        return ZOState(new_inner, mean(grads)), metrics

    return round_step
