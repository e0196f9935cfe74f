"""Backpropagation FL baselines: FedAvg / FedYogi / FedSGD, and the paper's
FedAvgSplit ablation (layer splitting applied to backprop).

Port of ``repro/core/baselines/backprop.py``: the SPRY round skeleton, but
each client takes exact gradients of its loss by reverse mode
(``torch.autograd.grad``), which stores the whole activation stack: the
memory cost the paper's Fig. 2 sets SPRY against. Reverse mode runs outside
the forward-AD region, so the attention is the plain ``attend_prefill`` and
``lora_proj`` takes its plain ``backward``: no kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.core.assignment import build_mask_tree
from repro_torch.core.spry import SpryState, _round_setup, aggregate_payloads
from repro_torch.fl.server import server_update
from repro_torch.models.registry import get_loss_fn
from repro_torch.optim import adamw, sgd
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten_like


def value_and_grad(loss_of, peft):
    """(loss, grad tree) of ``loss_of`` at ``peft`` by reverse mode."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), peft)
    loss = loss_of(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten_like(p, grads)


def make_backprop_round_step(cfg, spry_cfg, task: str = "cls",
                             method: str = "fedavg", split: bool = False):
    """round_step(state, batch) -> (state, metrics) for method fedavg |
    fedyogi | fedsgd; ``split=True`` is the FedAvgSplit ablation."""
    loss_fn_kind = get_loss_fn(task)
    M = spry_cfg.n_clients_per_round
    server_kind = {"fedavg": "fedavg", "fedsgd": "fedsgd",
                   "fedyogi": "fedyogi"}[method]
    client_opt = (adamw if spry_cfg.client_opt == "adamw" else sgd)(spry_cfg.local_lr)

    def client_update(base, peft, index, mask_row, client_batch):
        mask_tree = build_mask_tree(peft, index, mask_row)

        def loss_of(p):
            return loss_fn_kind(cfg, base, p, client_batch,
                                lora_scale=spry_cfg.lora_alpha)

        peft_c, opt_state = peft, client_opt.init(peft)
        losses = []
        for _ in range(spry_cfg.local_iters):
            loss, g = value_and_grad(loss_of, peft_c)
            g = tree_map(lambda gi, m: gi * m, g, mask_tree)
            updates, opt_state = client_opt.update(g, opt_state, peft_c)
            peft_c = apply_updates(peft_c, updates)
            losses.append(loss)
        delta = tree_map(lambda a, b: a - b, peft_c, peft)
        return delta, torch.stack(losses).mean()

    def round_step(state: SpryState, batch):
        base, peft = state.base, state.peft
        index, mask_matrix, counts, _ = _round_setup(state, spry_cfg, M, split)
        outs = [client_update(base, peft, index, mask_matrix[m],
                              {k: v[m] for k, v in batch.items()})
                for m in range(M)]
        deltas, losses = zip(*outs)
        delta = aggregate_payloads(peft, index, list(deltas), counts, M)
        lr = 1.0 if server_kind in ("fedavg", "fedsgd") else spry_cfg.server_lr
        new_peft, server = server_update(server_kind, peft, delta, state.server, lr=lr)
        metrics = {"loss": torch.stack(losses).mean()}
        return SpryState(base, new_peft, server, state.round_idx + 1), metrics

    return round_step
