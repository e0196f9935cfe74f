"""FL-simulation training driver of the port (in-process simulator path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-large-lora \
        --task sst2 --method spry --rounds 100 --clients 8

Port of ``repro/launch/train.py``'s in-process path: synthetic task ->
Dirichlet partition -> client sampling -> round step (SPRY on either
estimator route, or a baseline) -> server update, with test accuracy at
every eval round and the personalized accuracy at the end. Runs on CUDA
unless ``--device cpu`` is given; asking for CUDA without a card raises.
TF32 is switched off for matmuls and cuDNN: the reference is fp32-exact.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.core import (
    estimator_route,
    forward_gradient,
    init_state,
    make_round_step,
    make_round_step_per_iteration,
)
from repro_torch.core.baselines import (
    ZOState,
    init_zo_state,
    make_backprop_round_step,
    make_zeroorder_round_step,
)
from repro_torch.data import make_task
from repro_torch.data.loader import ClientDataset, stack_client_batches
from repro_torch.fl import dirichlet_partition, sample_clients
from repro_torch.kernels import launch_counts
from repro_torch.kernels.dispatch import forward_ad_region
from repro_torch.models import cls_logits, get_model
from repro_torch.models.common import accuracy_from_logits, classification_loss
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_map

METHODS = ("spry", "spry_periter", "fedavg", "fedyogi", "fedsgd",
           "fedavgsplit", "fedfgd", "fedmezo", "baffle", "fwdllm")
# (client lr, server lr) per method, as the reference
_LR_DEFAULTS = {
    "spry": (5e-3, 1e-2), "spry_periter": (5e-3, 1e-2), "fedfgd": (5e-3, 1e-2),
    "fedavg": (5e-2, 1.0), "fedyogi": (5e-2, 1e-2), "fedsgd": (5e-2, 1.0),
    "fedavgsplit": (5e-2, 1.0),
    "fedmezo": (5e-3, 1e-2), "baffle": (5e-3, 1e-2), "fwdllm": (5e-3, 1e-2),
}
# reference flags whose paths are later port slices
_NOT_PORTED = ("--runtime", "--runtime-executor", "--runtime-microbatch",
               "--async", "--buffer-size", "--staleness-decay",
               "--async-concurrency", "--max-staleness", "--over-select",
               "--deadline", "--dropout-rate", "--wire-dtype",
               "--wire-simulate", "--faults", "--quorum", "--checkpoint-dir",
               "--checkpoint-every", "--resume", "--telemetry", "--trace-out",
               "--prom-out")


def resolve_device(device: str) -> torch.device:
    """The run's device. CUDA is never silently replaced by the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def personalized_accuracy(cfg, state, clients, x, y, rng, device, steps=5,
                          lr=5e-2, batch_size=8, max_clients=8):
    """Paper's Acc_p: each client finetunes the head on its own shard with
    head-only forward-gradient steps and is evaluated on its held-out
    samples.

    Only the head moves (every other unit's mask is 0), so each step runs
    the model once without tangents, under the estimator's region so its
    ops are the estimator's primal ops, and differentiates the head-only
    loss on those hidden states: the same perturbation draws (the head's
    leaves come first in the tree's order), loss and head update as
    perturbing the whole tree under the head mask, without the model's
    zero tangents."""
    model = get_model(cfg)
    accs = []
    for c in clients[:max_clients]:
        idx = c.indices
        if len(idx) < 4:
            continue
        cut = max(2, int(0.8 * len(idx)))
        tr, te = idx[:cut], idx[cut:]
        head = state.peft["head"]
        for s in range(steps):
            take = rng.choice(tr, size=min(batch_size, len(tr)), replace=False)
            tokens = torch.as_tensor(x[take], device=device)
            labels = torch.as_tensor(y[take], device=device)
            with torch.no_grad(), forward_ad_region():
                h, aux = model.forward(cfg, state.base, state.peft, {"tokens": tokens})

            def head_loss(p, h=h, aux=aux, labels=labels):
                return classification_loss(h, p["head"], labels)[0] + 0.01 * aux
            _, g, _ = forward_gradient(head_loss, {"head": head}, int(take[0]) + s)
            head = tree_map(lambda p_, g_: p_ - lr * g_, head, g["head"])
        with torch.no_grad():
            logits = cls_logits(cfg, state.base, dict(state.peft, head=head),
                                {"tokens": torch.as_tensor(x[te], device=device)})
        accs.append(float(accuracy_from_logits(
            logits, torch.as_tensor(y[te], device=device))))
    return float(np.mean(accs)) if accs else float("nan")


def build_round_step(cfg, sc: SpryConfig, method: str, task="cls"):
    """(round_step, kind): kind 'spry' (forward gradients), 'bp' (backprop)
    or 'zo' (zero-order; its state is a ``ZOState``)."""
    if method == "spry":
        return make_round_step(cfg, sc, task), "spry"
    if method == "spry_periter":
        return make_round_step_per_iteration(cfg, sc, task), "spry"
    if method == "fedfgd":
        # forward gradients without splitting: every client perturbs all units
        return make_round_step(cfg, sc, task, split=False), "spry"
    if method in ("fedavg", "fedyogi", "fedsgd"):
        return make_backprop_round_step(cfg, sc, task, method=method), "bp"
    if method == "fedavgsplit":
        return make_backprop_round_step(cfg, sc, task, method="fedavg",
                                        split=True), "bp"
    if method in ("fedmezo", "baffle", "fwdllm"):
        return make_zeroorder_round_step(cfg, sc, task, method=method), "zo"
    raise ValueError(f"unknown method {method!r}; known: {METHODS}")


def run_training(arch="roberta-large-lora", task="sst2", method="spry",
                 rounds=100, clients_per_round=8, total_clients=32,
                 batch_size=8, local_iters=1, local_lr=None, server_lr=None,
                 dirichlet_alpha=0.1, seed=0, eval_every=10, reduced=True,
                 k_perturbations=1, jvp_clip=None, tangent_batch=None,
                 fused_contraction=False, device="cuda", log=print):
    """Run ``rounds`` rounds of ``method``; returns the eval history (one
    entry per eval round: round, acc, loss, round_s, round_peak_bytes (the
    round's peak device memory on CUDA, else None), the round's kernel
    launches, t, and the estimator route for the forward-gradient methods;
    the last also carries personalized_acc)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
    x_tr, y_tr, x_te, y_te = make_task(task, seed=seed, vocab=cfg.vocab)
    cfg = dataclasses.replace(cfg, n_classes=int(y_tr.max()) + 1)
    d_lr, d_slr = _LR_DEFAULTS[method]
    sc = SpryConfig(
        n_clients_per_round=clients_per_round, n_total_clients=total_clients,
        local_iters=local_iters,
        local_lr=local_lr if local_lr is not None else d_lr,
        server_lr=server_lr if server_lr is not None else d_slr,
        k_perturbations=k_perturbations, jvp_clip=jvp_clip,
        tangent_batch=tangent_batch, fused_contraction=fused_contraction,
        dirichlet_alpha=dirichlet_alpha,
        server_opt="fedavg" if method in ("fedavg", "fedsgd", "fedavgsplit")
        else "fedyogi",
        seed=seed)
    if method in ("spry", "spry_periter", "fedfgd"):
        route = estimator_route(sc)
        log(f"[{method}] estimator route: {route}"
            + (" (in-kernel jvp contraction at the final mixer site)"
               if route == "fused" else ""))

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    state = init_state(base, init_peft(cfg, gen, sc))
    parts = dirichlet_partition(y_tr, total_clients, dirichlet_alpha, seed=seed)
    client_data = [ClientDataset(x_tr, y_tr, idx) for idx in parts]
    step_fn, kind = build_round_step(cfg, sc, method)
    if kind == "zo":
        state = init_zo_state(state)

    def the_state(s):
        return s.inner if isinstance(s, ZOState) else s

    history = []
    t0 = time.time()
    for r in range(rounds):
        chosen = sample_clients(rng, total_clients, clients_per_round)
        bx, by = stack_client_batches([client_data[c] for c in chosen], rng,
                                      batch_size)
        before = launch_counts()
        if dev.type == "cuda":          # the round's own peak, not init's
            torch.cuda.reset_peak_memory_stats(dev)
        t_round = time.perf_counter()
        state, metrics = step_fn(state, {
            "tokens": torch.as_tensor(bx, device=dev),
            "labels": torch.as_tensor(by, device=dev)})
        _sync(dev)
        round_s = time.perf_counter() - t_round
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            st = the_state(state)
            accs = []
            with torch.no_grad():
                for i in range(0, min(len(x_te), 512), 64):
                    lg = cls_logits(cfg, st.base, st.peft, {
                        "tokens": torch.as_tensor(x_te[i:i + 64], device=dev)})
                    accs.append(float(accuracy_from_logits(
                        lg, torch.as_tensor(y_te[i:i + 64], device=dev))))
            acc = float(np.mean(accs))
            loss = float(metrics["loss"])
            entry = {"round": r + 1, "acc": acc, "loss": loss,
                     "round_s": round_s, "round_peak_bytes": peak,
                     "launches": launches, "t": time.time() - t0}
            if "fused_route" in metrics:
                entry["route"] = "fused" if float(metrics["fused_route"]) else "standard"
            history.append(entry)
            log(f"[{method}] round {r+1:4d} loss={loss:.4f} "
                f"test_acc={acc:.4f} ({time.time()-t0:.0f}s)")
    history[-1]["personalized_acc"] = personalized_accuracy(
        cfg, the_state(state), client_data, x_tr, y_tr, rng, dev)
    log(f"[{method}] personalized_acc={history[-1]['personalized_acc']:.4f}")
    return history


def _not_ported(flag, entry="train"):
    class _Reject(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{flag} is not ported to repro_torch yet (later "
                         f"slice); run it with python -m repro.launch.{entry}")
    return _Reject


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="roberta-large-lora")
    ap.add_argument("--task", default="sst2")
    ap.add_argument("--method", default="spry", choices=METHODS)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--total-clients", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--local-iters", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None,
                    help="client learning rate (default: the method's)")
    ap.add_argument("--server-lr", type=float, default=None,
                    help="server learning rate (default: the method's)")
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet alpha of the client partition")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--jvp-clip", type=float, default=None)
    ap.add_argument("--tangent-batch", type=int, default=None,
                    help="tangents per batched estimator pass (None = all "
                         "K; 1 = sequential; 1<b<K = groups of b)")
    ap.add_argument("--fused-contraction", action="store_true",
                    help="contract the final mixer site's tangents against "
                         "the post-head cotangent in-kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (unreduced) architecture")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", action=_not_ported(flag),
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_training(arch=args.arch, task=args.task, method=args.method,
                 rounds=args.rounds, clients_per_round=args.clients,
                 total_clients=args.total_clients, batch_size=args.batch_size,
                 local_iters=args.local_iters, local_lr=args.lr,
                 server_lr=args.server_lr, dirichlet_alpha=args.alpha,
                 seed=args.seed, reduced=not args.full_size,
                 k_perturbations=args.k, jvp_clip=args.jvp_clip,
                 tangent_batch=args.tangent_batch,
                 fused_contraction=args.fused_contraction, device=args.device)


if __name__ == "__main__":
    main()
