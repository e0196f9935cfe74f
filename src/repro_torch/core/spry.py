"""SPRY round step (paper Alg. 1). Port of ``repro/core/spry.py``.

One call = one FL round:
  1. cyclic unit->client assignment masks (assignment.py)
  2. per-client seeded perturbations + forward-gradient local training; the
     reference's vmap over the M simulated clients is a Python loop here
  3. weighted-union aggregation of the per-unit deltas
  4. adaptive server update (FedYogi default)

Keys are integers: ``round_key = fold_in(seed, round)``, ``client key =
fold_in(round_key, client)``, ``estimate key = fold_in(client key,
local_iter)`` (see ``forward_grad.fold_in``). Every round function takes
an optional ``perturbations`` argument, ``perturbations[client][iter]`` a
stacked tree of K perturbations (with ``microbatch_size`` set, a list of
such stacks, one a microbatch), so tests can inject the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.assignment import (
    assignment_matrix,
    build_mask_tree,
    client_counts,
    enumerate_units,
)
from repro_torch.core.forward_grad import (
    fold_in,
    forward_gradient,
    reconstruct_gradient,
)
from repro_torch.fl.server import ServerState, server_init, server_update
from repro_torch.models.registry import get_loss_fn
from repro_torch.utils.pytree import tree_cast, tree_leaves, tree_map


class SpryState(NamedTuple):
    base: Any
    peft: Any
    server: ServerState
    round_idx: int


def init_state(base, peft) -> SpryState:
    peft32 = tree_cast(peft, torch.float32)
    return SpryState(base, peft32, server_init(peft32), 0)


def make_task_loss(cfg, spry_cfg, task, base, batch):
    """The client objective as a function of the peft tree only: the
    registry's ``SplitLoss`` with ``spry_cfg.fused_contraction`` (the
    estimator then runs the in-kernel contraction at the final mixer site),
    else the plain closure. Both run the same loss ops."""
    if spry_cfg.fused_contraction:
        return get_loss_fn(task, split=True)(cfg, base, batch,
                                             lora_scale=spry_cfg.lora_alpha)
    loss_fn_kind = get_loss_fn(task)

    def loss_of(p):
        return loss_fn_kind(cfg, base, p, batch, lora_scale=spry_cfg.lora_alpha)
    return loss_of


def estimator_route(spry_cfg) -> str:
    """'fused' (in-kernel jvp contraction at the final mixer site) or
    'standard' (tangent outputs materialized, then contracted)."""
    return "fused" if spry_cfg.fused_contraction else "standard"


def run_fields(spry_cfg) -> dict:
    """Static estimator facts stamped on run artifacts (telemetry
    ``run_meta`` events, report headers): the active route plus the knobs
    that select it."""
    return {
        "route": estimator_route(spry_cfg),
        "k_perturbations": int(spry_cfg.k_perturbations),
        "tangent_batch": (int(spry_cfg.tangent_batch)
                          if spry_cfg.tangent_batch is not None else None),
        "local_iters": int(spry_cfg.local_iters),
        "local_lr": float(spry_cfg.local_lr),
        "server_lr": float(spry_cfg.server_lr),
    }


def _estimate(loss_of, peft, key, spry_cfg, mask_tree, injected):
    return forward_gradient(
        loss_of, peft, key, k_perturbations=spry_cfg.k_perturbations,
        mask_tree=mask_tree, jvp_clip=spry_cfg.jvp_clip,
        tangent_batch=spry_cfg.tangent_batch, perturbations=injected,
        fused_contraction=spry_cfg.fused_contraction)


def _injected(perturbations, seed_id, it):
    return None if perturbations is None else perturbations[seed_id][it]


def _microbatched_estimate(cfg, spry_cfg, task, base, client_batch, peft,
                           ikey, mask_tree, injected):
    """Gradient accumulation over ``B // microbatch_size`` microbatches, each
    with a fresh perturbation from ``fold_in(ikey, i)`` (each estimate is
    unbiased for its microbatch's gradient, the average for the batch's);
    gradients and loss are averaged and the first K jvps kept, as the
    reference's scan. ``injected`` is then a list of stacks, one a
    microbatch."""
    mb = spry_cfg.microbatch_size
    n_mb = client_batch["tokens"].shape[0] // mb
    g_acc = tree_map(lambda x: torch.zeros(x.shape, device=x.device), peft)
    loss_acc = torch.zeros((), device=client_batch["tokens"].device)
    jvps_all = []
    for i in range(n_mb):
        one = {k: v[i * mb:(i + 1) * mb] for k, v in client_batch.items()}
        loss_of = make_task_loss(cfg, spry_cfg, task, base, one)
        loss, g, jvps = _estimate(loss_of, peft, fold_in(ikey, i), spry_cfg,
                                  mask_tree, None if injected is None else injected[i])
        g_acc = tree_map(lambda a, b: a + b / n_mb, g_acc, g)
        loss_acc = loss_acc + loss / n_mb
        jvps_all.append(jvps)
    return loss_acc, g_acc, torch.cat(jvps_all)[:spry_cfg.k_perturbations]


def make_client_update_fn(cfg, spry_cfg, task: str = "cls"):
    """Per-epoch client (Alg. 1 lines 6-13): ``local_iters`` steps of
    forward-gradient SGD on the units of ``mask_row``, each on the whole
    client batch or, with ``microbatch_size`` below it, accumulated over its
    microbatches (``_microbatched_estimate``). Returns
    ``client_update(base, peft, round_key, seed_id, mask_row, client_batch,
    perturbations=None) -> (delta, loss_mean, jvps)``."""
    lr_l = spry_cfg.local_lr
    mb = spry_cfg.microbatch_size

    def client_update(base, peft, round_key, seed_id, mask_row, client_batch,
                      perturbations=None):
        index = enumerate_units(peft)
        mask_tree = build_mask_tree(peft, index, mask_row)
        ckey = fold_in(round_key, seed_id)
        whole = mb is None or mb >= client_batch["tokens"].shape[0]
        loss_of = (make_task_loss(cfg, spry_cfg, task, base, client_batch)
                   if whole else None)
        peft_c = peft
        losses, jvps_all = [], []
        for it in range(spry_cfg.local_iters):
            ikey, injected = fold_in(ckey, it), _injected(perturbations, seed_id, it)
            if whole:
                loss, g, jvps = _estimate(loss_of, peft_c, ikey, spry_cfg,
                                          mask_tree, injected)
            else:
                loss, g, jvps = _microbatched_estimate(
                    cfg, spry_cfg, task, base, client_batch, peft_c, ikey,
                    mask_tree, injected)
            peft_c = tree_map(lambda p, gi: p - lr_l * gi, peft_c, g)
            losses.append(loss)
            jvps_all.append(jvps)
        delta = tree_map(lambda a, b: a - b, peft_c, peft)
        return delta, torch.stack(losses).mean(), torch.stack(jvps_all)

    return client_update


def make_client_jvp_fn(cfg, spry_cfg, task: str = "cls"):
    """Per-iteration client (§3.2): one estimate at the server weights; the
    K jvp scalars are the whole uplink. ``client_jvp(base, peft, round_key,
    seed_id, mask_row, client_batch, perturbations=None) -> (loss, jvps)``."""
    def client_jvp(base, peft, round_key, seed_id, mask_row, client_batch,
                   perturbations=None):
        index = enumerate_units(peft)
        mask_tree = build_mask_tree(peft, index, mask_row)
        ikey = fold_in(fold_in(round_key, seed_id), 0)
        loss_of = make_task_loss(cfg, spry_cfg, task, base, client_batch)
        loss, _, jvps = _estimate(loss_of, peft, ikey, spry_cfg, mask_tree,
                                  _injected(perturbations, seed_id, 0))
        return loss, jvps

    return client_jvp


def make_rebuild_fn():
    """Server-side per-iteration rebuild: ``rebuild(peft, round_key, seed_id,
    mask_row, jvps, perturbations=None) -> grad``, bit-identical to the
    client's batched estimate."""
    def rebuild(peft, round_key, seed_id, mask_row, jvps, perturbations=None):
        index = enumerate_units(peft)
        mask_tree = build_mask_tree(peft, index, mask_row)
        ikey = fold_in(fold_in(round_key, seed_id), 0)
        return reconstruct_gradient(peft, ikey, jvps, mask_tree,
                                    _injected(perturbations, seed_id, 0))

    return rebuild


def make_count_tree(peft, index, counts, head_count):
    """Per-unit divisor tree: M-tilde per LoRA unit, ``head_count`` for the
    always-on head."""
    count_tree = build_mask_tree(peft, index, counts)
    count_tree["head"] = tree_map(lambda x: torch.full_like(x, head_count),
                                  count_tree["head"])
    return count_tree


def aggregate_payloads(peft, index, payloads, counts, head_count):
    """Weighted-union average of per-client payload trees (a list): clients
    that share a unit are averaged (sum over clients / per-unit count)."""
    count_tree = make_count_tree(peft, index, counts, head_count)
    stacked = tree_map(lambda *xs: torch.stack(xs), *payloads)
    return tree_map(lambda leaf, c: leaf.sum(0) / c, stacked, count_tree)


def _round_setup(state, spry_cfg, M, split=True):
    """(unit index, client x unit mask, per-unit counts, round key);
    ``split=False`` gives every client every unit."""
    index = enumerate_units(state.peft)
    device = next(iter(state.peft["head"].values())).device
    if split:
        mask_matrix = assignment_matrix(index.n_units, M, state.round_idx % M,
                                        device=device)
    else:
        mask_matrix = torch.ones((M, index.n_units), device=device)
    round_key = fold_in(spry_cfg.seed, state.round_idx)
    return index, mask_matrix, client_counts(mask_matrix), round_key


def _client_batch(batch, m):
    return {k: v[m] for k, v in batch.items()}


def _route_metric(spry_cfg):
    """1.0 on the fused route, 0.0 on the standard one."""
    return torch.tensor(float(spry_cfg.fused_contraction))


def make_round_step(cfg, spry_cfg, task: str = "cls", split: bool = True):
    """round_step(state, batch, perturbations=None) -> (state, metrics);
    batch leaves lead with the M simulated clients. ``split=False`` turns
    the paper's weight splitting off (the FedFGD ablation: every client
    perturbs every unit). Per-epoch rounds only: ``comm_mode`` other than
    "per_epoch" raises (the per-iteration round is
    ``make_round_step_per_iteration``)."""
    if spry_cfg.comm_mode != "per_epoch":
        raise NotImplementedError(
            f"comm_mode {spry_cfg.comm_mode!r}: make_round_step runs per-epoch "
            f"rounds; the per-iteration round is make_round_step_per_iteration, "
            f"and fl.runtime.FederationEngine runs either comm_mode")
    M = spry_cfg.n_clients_per_round
    client_update = make_client_update_fn(cfg, spry_cfg, task)

    def round_step(state: SpryState, batch, perturbations=None):
        base, peft = state.base, state.peft
        index, mask_matrix, counts, round_key = _round_setup(state, spry_cfg, M,
                                                             split)
        outs = [client_update(base, peft, round_key, m, mask_matrix[m],
                              _client_batch(batch, m), perturbations)
                for m in range(M)]
        deltas, losses, jvps = zip(*outs)
        delta = aggregate_payloads(peft, index, list(deltas), counts, M)
        new_peft, server = server_update(spry_cfg.server_opt, peft, delta,
                                         state.server, lr=spry_cfg.server_lr)
        jvps = torch.stack(jvps)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "jvp_abs_mean": jvps.abs().mean(),
            "delta_norm": torch.sqrt(sum(torch.sum(d * d) for d in
                                         tree_leaves(delta))),
            "jvps": jvps,
            "fused_route": _route_metric(spry_cfg),
        }
        return SpryState(base, new_peft, server, state.round_idx + 1), metrics

    return round_step


def make_round_step_per_iteration(cfg, spry_cfg, task: str = "cls"):
    """Per-iteration comm mode (§3.2): clients send K jvp scalars; the server
    regenerates the perturbations and rebuilds each client's gradient."""
    M = spry_cfg.n_clients_per_round
    client_jvp = make_client_jvp_fn(cfg, spry_cfg, task)
    rebuild = make_rebuild_fn()

    def round_step(state: SpryState, batch, perturbations=None):
        base, peft = state.base, state.peft
        index, mask_matrix, counts, round_key = _round_setup(state, spry_cfg, M)
        outs = [client_jvp(base, peft, round_key, m, mask_matrix[m],
                           _client_batch(batch, m), perturbations)
                for m in range(M)]
        losses, jvps = zip(*outs)
        grads = [rebuild(peft, round_key, m, mask_matrix[m], jvps[m], perturbations)
                 for m in range(M)]
        grad = aggregate_payloads(peft, index, grads, counts, M)
        delta = tree_map(lambda g: -spry_cfg.local_lr * g, grad)
        new_peft, server = server_update(spry_cfg.server_opt, peft, delta,
                                         state.server, lr=spry_cfg.server_lr)
        jvps = torch.stack(jvps)
        metrics = {"loss": torch.stack(losses).mean(),
                   "jvp_abs_mean": jvps.abs().mean(), "jvps": jvps,
                   "fused_route": _route_metric(spry_cfg)}
        return SpryState(base, new_peft, server, state.round_idx + 1), metrics

    return round_step

