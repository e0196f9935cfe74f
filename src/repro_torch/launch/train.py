"""FL-simulation training driver of the port (in-process simulator path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-large-lora \
        --task sst2 --method spry --rounds 100 --clients 8

Port of ``repro/launch/train.py``: synthetic task -> Dirichlet partition ->
client sampling -> SPRY round step -> server update, with test accuracy at
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
    forward_gradient,
    init_state,
    make_round_step,
    make_round_step_per_iteration,
)
from repro_torch.data import make_task
from repro_torch.data.loader import ClientDataset, stack_client_batches
from repro_torch.fl import dirichlet_partition, sample_clients
from repro_torch.kernels import launch_counts
from repro_torch.models import cls_logits, cls_loss, get_model
from repro_torch.models.common import accuracy_from_logits
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_map

METHODS = ("spry", "spry_periter")
# reference flags whose paths are later port slices
_NOT_PORTED = ("--runtime", "--runtime-executor", "--runtime-microbatch",
               "--async", "--buffer-size", "--staleness-decay",
               "--async-concurrency", "--max-staleness", "--over-select",
               "--deadline", "--dropout-rate", "--wire-dtype",
               "--wire-simulate", "--faults", "--quorum", "--checkpoint-dir",
               "--checkpoint-every", "--resume", "--telemetry", "--trace-out",
               "--prom-out", "--fused-contraction")


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
    samples."""
    accs = []
    for c in clients[:max_clients]:
        idx = c.indices
        if len(idx) < 4:
            continue
        cut = max(2, int(0.8 * len(idx)))
        tr, te = idx[:cut], idx[cut:]
        peft = state.peft
        head_mask = {g: tree_map(lambda leaf, g=g: torch.tensor(
            1.0 if g == "head" else 0.0, device=device), t)
            for g, t in peft.items()}
        for s in range(steps):
            take = rng.choice(tr, size=min(batch_size, len(tr)), replace=False)
            batch = {"tokens": torch.as_tensor(x[take], device=device),
                     "labels": torch.as_tensor(y[take], device=device)}
            _, g, _ = forward_gradient(
                lambda p: cls_loss(cfg, state.base, p, batch), peft,
                int(take[0]) + s, mask_tree=head_mask)
            peft = tree_map(lambda p_, g_: p_ - lr * g_, peft, g)
        with torch.no_grad():
            logits = cls_logits(cfg, state.base, peft,
                                {"tokens": torch.as_tensor(x[te], device=device)})
        accs.append(float(accuracy_from_logits(
            logits, torch.as_tensor(y[te], device=device))))
    return float(np.mean(accs)) if accs else float("nan")


def run_training(arch="roberta-large-lora", task="sst2", method="spry",
                 rounds=100, clients_per_round=8, total_clients=32,
                 batch_size=8, local_iters=1, local_lr=None, server_lr=None,
                 dirichlet_alpha=0.1, seed=0, eval_every=10, reduced=True,
                 k_perturbations=1, jvp_clip=None, tangent_batch=None,
                 device="cuda", log=print):
    """Run ``rounds`` SPRY rounds; returns the eval history (one entry per
    eval round: round, acc, loss, round_s, the round's kernel launches, t;
    the last also carries personalized_acc)."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} is not ported yet; "
                         f"the port runs {METHODS}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
    x_tr, y_tr, x_te, y_te = make_task(task, seed=seed, vocab=cfg.vocab)
    cfg = dataclasses.replace(cfg, n_classes=int(y_tr.max()) + 1)
    sc = SpryConfig(
        n_clients_per_round=clients_per_round, n_total_clients=total_clients,
        local_iters=local_iters,
        local_lr=local_lr if local_lr is not None else 5e-3,
        server_lr=server_lr if server_lr is not None else 1e-2,
        k_perturbations=k_perturbations, jvp_clip=jvp_clip,
        tangent_batch=tangent_batch, dirichlet_alpha=dirichlet_alpha,
        server_opt="fedyogi", seed=seed)
    log(f"[{method}] estimator route: standard")

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = get_model(cfg).init_base(cfg, gen)
    state = init_state(base, init_peft(cfg, gen, sc))
    parts = dirichlet_partition(y_tr, total_clients, dirichlet_alpha, seed=seed)
    client_data = [ClientDataset(x_tr, y_tr, idx) for idx in parts]
    step_fn = (make_round_step(cfg, sc) if method == "spry"
               else make_round_step_per_iteration(cfg, sc))

    history = []
    t0 = time.time()
    for r in range(rounds):
        chosen = sample_clients(rng, total_clients, clients_per_round)
        bx, by = stack_client_batches([client_data[c] for c in chosen], rng,
                                      batch_size)
        before = launch_counts()
        t_round = time.perf_counter()
        state, metrics = step_fn(state, {
            "tokens": torch.as_tensor(bx, device=dev),
            "labels": torch.as_tensor(by, device=dev)})
        _sync(dev)
        round_s = time.perf_counter() - t_round
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            accs = []
            with torch.no_grad():
                for i in range(0, min(len(x_te), 512), 64):
                    lg = cls_logits(cfg, state.base, state.peft, {
                        "tokens": torch.as_tensor(x_te[i:i + 64], device=dev)})
                    accs.append(float(accuracy_from_logits(
                        lg, torch.as_tensor(y_te[i:i + 64], device=dev))))
            acc = float(np.mean(accs))
            loss = float(metrics["loss"])
            history.append({"round": r + 1, "acc": acc, "loss": loss,
                            "round_s": round_s, "launches": launches,
                            "t": time.time() - t0})
            log(f"[{method}] round {r+1:4d} loss={loss:.4f} "
                f"test_acc={acc:.4f} ({time.time()-t0:.0f}s)")
    history[-1]["personalized_acc"] = personalized_accuracy(
        cfg, state, client_data, x_tr, y_tr, rng, dev)
    log(f"[{method}] personalized_acc={history[-1]['personalized_acc']:.4f}")
    return history


def _not_ported(flag):
    class _Reject(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{flag} is not ported to repro_torch yet (later "
                         f"slice); run it with python -m repro.launch.train")
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
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--tangent-batch", type=int, default=None,
                    help="tangents per batched estimator pass (None = all "
                         "K; 1 = sequential; 1<b<K = groups of b)")
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
                 local_iters=args.local_iters, seed=args.seed,
                 reduced=not args.full_size, k_perturbations=args.k,
                 tangent_batch=args.tangent_batch, device=args.device)


if __name__ == "__main__":
    main()
