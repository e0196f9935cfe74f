"""FL-simulation training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-large-lora \
        --task sst2 --method spry --rounds 100 --clients 8 --out history.json

``--arch`` takes roberta-large-lora, llama2-7b, gemma3-12b, gemma3-27b,
h2o-danube-3-4b, command-r-plus-104b, qwen3-moe-235b-a22b,
llama4-maverick-400b-a17b, internvl2-76b (text only, as the reference's
tasks carry no patch embeddings), zamba2-1.2b or rwkv6-1.6b (reduced
unless ``--full-size``). whisper-tiny raises: its loss reads encoder
frames, which no task's batches carry (the reference's cannot train it
either); it trains through ``forward_gradient`` on a batch with frames.

Port of ``repro/launch/train.py``. The in-process path: synthetic task ->
Dirichlet partition -> client sampling -> round step (SPRY on either
estimator route, or a baseline) -> server update, with test accuracy at
every eval round and the personalized accuracy at the end. ``--runtime``
drives spry / spry_periter rounds through the federation runtime instead
(a lazy client population, the cohort scheduler with over-selection,
deadline and dropout, the round engine with wire frames, faults and
quorum); ``--async`` through the FedBuff engine. ``--checkpoint-dir``
writes crash-safe checkpoints and ``--resume`` continues from one, bit
for bit. ``--telemetry`` (on by default, ``telemetry.jsonl``; ``off``
disables), ``--trace-out`` and ``--prom-out`` write the run's event log,
Chrome trace and Prometheus snapshot (``repro_torch.obs``). Runs on CUDA
unless ``--device cpu`` is given; asking for CUDA without a card raises. TF32 is switched off for matmuls and cuDNN: the
reference is fp32-exact.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import (
    decode_async_snapshot,
    encode_async_snapshot,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.core import (
    enumerate_units,
    estimator_route,
    forward_gradient,
    init_state,
    make_round_step,
    make_round_step_per_iteration,
    run_fields,
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
from repro_torch.fl.runtime import (
    AsyncConfig,
    AsyncFederationEngine,
    ClientPopulation,
    CohortScheduler,
    FaultConfig,
    FederationEngine,
    SerialExecutor,
    ShardedExecutor,
    WireConfig,
)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.dispatch import forward_ad_region
from repro_torch.models import cls_logits, get_model
from repro_torch.models.common import accuracy_from_logits, classification_loss
from repro_torch.obs import NULL, MemoryProbe, make_telemetry
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
                          lr=5e-2, batch_size=8, max_clients=8, perturbations=None):
    """Paper's Acc_p: each client finetunes the head on its own shard with
    head-only forward-gradient steps and is evaluated on its held-out
    samples.

    Only the head moves (the reference masks every other unit to 0), so
    each step runs the model once without tangents, under the estimator's
    region so its ops are the estimator's primal ops, and differentiates
    the head-only loss on those hidden states: the loss and head update of
    perturbing the whole tree under the head mask, without the model's zero
    tangents. A step's perturbation is drawn for the head alone from the
    step's integer key (``int(take[0]) + step``, the reference's);
    ``perturbations``, a function of that key returning the stacked head
    draw ``{"head": ...}`` (leading axis 1), injects it instead, as
    ``forward_gradient``'s argument of that name does."""
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
            key = int(take[0]) + s
            _, g, _ = forward_gradient(head_loss, {"head": head}, key, perturbations=(
                None if perturbations is None else perturbations(key)))
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


def _engine_entry(report, async_mode):
    """The engine report's fields an eval entry keeps (JSON-safe)."""
    if async_mode:
        return {"sim_time_s": report.sim_time_s, "staleness": report.staleness,
                "utilization": report.utilization,
                "health": dataclasses.asdict(report.health)}
    return {"cohort": report.cohort_size, "survivors": report.n_validated,
            "round_bytes_up": report.bytes_up,
            "round_bytes_down": report.bytes_down,
            "round_skipped": report.round_skipped,
            "dropped_frame_ids": report.dropped_frame_ids,
            "health": (None if report.health is None
                       else dataclasses.asdict(report.health))}


def run_training(arch="roberta-large-lora", task="sst2", method="spry",
                 rounds=100, clients_per_round=8, total_clients=32,
                 batch_size=8, local_iters=1, local_lr=None, server_lr=None,
                 dirichlet_alpha=0.1, seed=0, eval_every=10, reduced=True,
                 k_perturbations=1, jvp_clip=None, tangent_batch=None,
                 fused_contraction=False, device="cuda", log=print,
                 runtime=False, runtime_executor="serial",
                 runtime_microbatch=None, over_select=1.0, deadline=None,
                 dropout_rate=0.0, wire_dtype="fp32", wire_simulate=False,
                 faults=None, quorum=None, checkpoint_dir=None,
                 checkpoint_every=1, resume=False, async_mode=False,
                 buffer_size=4, staleness_decay=0.5, async_concurrency=None,
                 max_staleness=None, telemetry=None):
    """Run ``rounds`` rounds of ``method``; returns the eval history (one
    entry per eval round: round, acc, loss, round_s, round_peak_bytes (the
    round's peak device memory on CUDA, else None), the round's kernel
    launches, t, and the estimator route for the forward-gradient methods;
    on the runtime path also the byte totals and the engine's report; the
    last also carries personalized_acc). The runtime and checkpoint
    parameters are the reference's (``--faults`` implies wire simulation,
    ``async_mode`` implies ``runtime``). ``telemetry`` (an ``obs.Telemetry``;
    default ``NULL``) receives the reference's events (``run_meta``,
    ``round``, ``eval``, ``memory``, ``personalized_eval``; the engines' own
    on the runtime path) and the ``train.round`` span, all recorded on
    values the run has already computed."""
    tel = telemetry if telemetry is not None else NULL
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    if async_mode:
        runtime = True          # the async engine is a runtime path
    # fault injection rides the simulated wire (frames must exist to be
    # corrupted), so faults imply wire simulation on the runtime path
    if isinstance(faults, str):
        faults = FaultConfig.parse(faults, seed=seed)
    if faults is not None and not faults.any_faults:
        faults = None
    if faults is not None:
        if not runtime:
            raise ValueError("--faults requires --runtime (the chaotic wire "
                             "lives in the federation engine)")
        wire_simulate = True
    if runtime and method not in ("spry", "spry_periter"):
        raise ValueError(f"--runtime supports spry/spry_periter, not {method!r}")
    if resume and not checkpoint_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if cfg.encoder_layers:
        raise ValueError(
            f"{arch}: the encoder-decoder family's loss reads encoder frames, "
            f"and the {task!r} task's batches carry tokens only; estimate its "
            f"gradients with core.forward_gradient on a batch with 'frames'")
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
    if tel.enabled:
        tel.event("run_meta", workload="train", method=method, arch=arch,
                  task=task, rounds=rounds, clients_per_round=clients_per_round,
                  total_clients=total_clients, batch_size=batch_size,
                  runtime=runtime, seed=seed, **run_fields(sc))
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

    engine = scheduler = None
    if runtime:
        comm_mode = "per_epoch" if method == "spry" else "per_iteration"
        population = ClientPopulation(x_tr, y_tr, n_clients=total_clients,
                                      alpha=dirichlet_alpha, seed=seed)
        wire = WireConfig(dtype=wire_dtype, simulate=wire_simulate or async_mode)
        if async_mode:
            engine = AsyncFederationEngine(
                cfg, sc, population, task="cls", comm_mode=comm_mode,
                async_cfg=AsyncConfig(
                    buffer_size=buffer_size, staleness_decay=staleness_decay,
                    concurrency=(async_concurrency if async_concurrency
                                 else max(clients_per_round, buffer_size)),
                    max_staleness=max_staleness, seed=seed),
                wire=wire, telemetry=tel, faults=faults)
        else:
            scheduler = CohortScheduler(
                population, clients_per_round, over_select=over_select,
                deadline=deadline, dropout_rate=dropout_rate, seed=seed)
            executor = (ShardedExecutor(microbatch=runtime_microbatch)
                        if runtime_executor == "sharded"
                        else SerialExecutor(microbatch=runtime_microbatch))
            engine = FederationEngine(
                cfg, sc, task="cls", comm_mode=comm_mode, executor=executor,
                wire=wire, telemetry=tel, faults=faults, quorum=quorum)
            n_units = enumerate_units(state.peft).n_units
        client_data = [ClientDataset(x_tr, y_tr, population.shard(c))
                       for c in range(min(total_clients, 8))]
    else:
        parts = dirichlet_partition(y_tr, total_clients, dirichlet_alpha,
                                    seed=seed)
        client_data = [ClientDataset(x_tr, y_tr, idx) for idx in parts]
        step_fn, kind = build_round_step(cfg, sc, method)
        if kind == "zo":
            state = init_zo_state(state)

    def the_state(s):
        return s.inner if isinstance(s, ZOState) else s

    history = []
    bytes_up_total = bytes_down_total = 0
    start_round = 0
    if resume:
        # the manifest carries everything the loop consumes host-side (round
        # index, host rng state, history, byte totals); the round key is
        # fold_in(seed, round_idx) and every perturbation is drawn from a
        # generator seeded per key, so restoring the state and round index
        # replays the remaining rounds bit for bit
        t_load = time.perf_counter()
        state, man = load_checkpoint(checkpoint_dir, state)
        load_s = time.perf_counter() - t_load
        if man.algo_seed != seed:
            raise ValueError(f"checkpoint seed {man.algo_seed} != run seed "
                             f"{seed}: refusing to splice trajectories")
        start_round = man.round_idx
        history = list(man.history)
        bytes_up_total = int(man.extra.get("bytes_up_total", 0))
        bytes_down_total = int(man.extra.get("bytes_down_total", 0))
        if man.rng_state is not None:
            rng.bit_generator.state = man.rng_state
        if async_mode:
            # async determinism rides on the virtual-time snapshot: the event
            # heap (in-flight frames byte for byte), the staleness buffer,
            # the clock and the dispatch counter
            if "async" not in man.extra:
                raise ValueError("--async --resume needs a checkpoint written "
                                 "by an async run (no snapshot in the manifest)")
            engine.restore(decode_async_snapshot(man.extra["async"]))
        log(f"[{method}] resumed from {checkpoint_dir} at round {start_round} "
            f"(load {load_s:.2f}s)")

    def maybe_checkpoint(r):
        if not checkpoint_dir:
            return
        if (r + 1) % max(1, checkpoint_every) != 0 and r != rounds - 1:
            return
        extra = {"bytes_up_total": bytes_up_total,
                 "bytes_down_total": bytes_down_total}
        if async_mode:
            extra["async"] = encode_async_snapshot(engine.snapshot())
        t_save = time.perf_counter()
        man = save_checkpoint(checkpoint_dir, state, round_idx=r + 1,
                              algo_seed=seed, rng_state=rng.bit_generator.state,
                              history=history, extra=extra)
        log(f"[{method}] checkpoint {man.state_file} written "
            f"({time.perf_counter() - t_save:.2f}s)")

    def personalized():
        t_p = time.perf_counter()
        acc = personalized_accuracy(cfg, the_state(state), client_data, x_tr,
                                    y_tr, rng, dev)
        log(f"[{method}] personalized_acc={acc:.4f} "
            f"({time.perf_counter() - t_p:.2f}s)")
        return acc

    probe = MemoryProbe(tel) if tel.enabled else None
    t0 = time.time()
    if start_round >= rounds:
        # the checkpoint covers the whole run; only the final personalized
        # eval may be outstanding
        if history and "personalized_acc" not in history[-1]:
            history[-1]["personalized_acc"] = personalized()
        return history
    for r in range(start_round, rounds):
        before = launch_counts()
        if dev.type == "cuda":          # the round's own peak, not init's
            torch.cuda.reset_peak_memory_stats(dev)
        t_round = time.perf_counter()
        report = None
        # the in-process round's span covers what round_s measures (the
        # engines span their own rounds)
        with (tel.span("train.round", round=r, method=method) if engine is None
              else contextlib.nullcontext()):
            if async_mode:
                state, metrics, report = engine.run_version(state, batch_size)
                # async reports carry engine-lifetime byte totals (restored
                # across resume by the snapshot): assign, don't accumulate
                bytes_up_total, bytes_down_total = report.bytes_up, report.bytes_down
            elif engine is not None:
                plan = scheduler.plan_round(r, n_units, sc.seed)
                bx, by = scheduler.round_batch(plan, batch_size)
                state, metrics, report = engine.run_round(state, plan, {
                    "tokens": torch.as_tensor(bx, device=dev),
                    "labels": torch.as_tensor(by, device=dev)})
                bytes_up_total += report.bytes_up
                bytes_down_total += report.bytes_down
            else:
                chosen = sample_clients(rng, total_clients, clients_per_round)
                bx, by = stack_client_batches([client_data[c] for c in chosen],
                                              rng, batch_size)
                state, metrics = step_fn(state, {
                    "tokens": torch.as_tensor(bx, device=dev),
                    "labels": torch.as_tensor(by, device=dev)})
            _sync(dev)
        round_s = time.perf_counter() - t_round
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        if tel.enabled and engine is None:
            # the engines emit their own "round" events; the in-process
            # path emits one here
            ev = {"round": r, "method": method, "loss": float(metrics["loss"]),
                  "wall_s": round(round_s, 6)}
            for k in ("jvp_abs_mean", "delta_norm"):
                if k in metrics:
                    ev[k] = float(metrics[k])
            if "fused_route" in metrics:
                ev["route"] = "fused" if float(metrics["fused_route"]) else "standard"
            tel.event("round", **ev)
        if probe is not None and r == 0:
            # after the round's peak is read, so its peak_bytes_in_use is
            # the round's round_peak_bytes
            probe.sample("post_round_1")
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
            extra = ""
            if report is not None:
                entry.update(bytes_up=bytes_up_total, bytes_down=bytes_down_total,
                             **_engine_entry(report, async_mode))
                extra = f" up={bytes_up_total/1e6:.2f}MB down={bytes_down_total/1e6:.2f}MB"
                if async_mode:
                    extra += (f" sim_t={report.sim_time_s:.0f}s staleness="
                              f"{np.mean(report.staleness):.1f} "
                              f"util={report.utilization:.2f}")
                else:
                    extra += f" survivors={report.n_validated}/{report.cohort_size}"
                    if report.round_skipped:
                        extra += " [below quorum: round skipped]"
            history.append(entry)
            if tel.enabled:
                # the reference's eval fields, round 0-based as the "round"
                # events
                tel.event("eval", round=r, **{
                    k: entry[k] for k in ("acc", "loss", "route", "bytes_up",
                                          "bytes_down") if k in entry})
            log(f"[{method}] round {r+1:4d} loss={loss:.4f} "
                f"test_acc={acc:.4f} ({time.time()-t0:.0f}s){extra}")
        maybe_checkpoint(r)
    history[-1]["personalized_acc"] = personalized()
    if tel.enabled:
        probe.sample("end_of_run")
        tel.event("personalized_eval",
                  personalized_acc=history[-1]["personalized_acc"])
    return history


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
    ap.add_argument("--out", default=None,
                    help="write the eval history (one entry per eval round) "
                         "to this JSON file")
    ap.add_argument("--runtime", action="store_true",
                    help="drive rounds through the federation runtime "
                         "(fl/runtime: scheduler -> executor -> engine)")
    ap.add_argument("--runtime-executor", default="serial",
                    choices=("serial", "sharded"),
                    help="sharded (the reference's shard_map over TPU "
                         "devices) has no one-GPU meaning and raises")
    ap.add_argument("--runtime-microbatch", type=int, default=None,
                    help="clients per executor chunk (None = whole cohort; "
                         "finite = streaming aggregation)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="event-driven FedBuff engine: clients stream updates "
                         "as they finish; the server aggregates the first "
                         "--buffer-size validated arrivals with staleness-"
                         "weighted combination (implies --runtime)")
    ap.add_argument("--buffer-size", type=int, default=4,
                    help="async: validated arrivals per server step (B)")
    ap.add_argument("--staleness-decay", type=float, default=0.5,
                    help="async: a in w = 1/(1+s)^a (0 = ignore staleness)")
    ap.add_argument("--async-concurrency", type=int, default=None,
                    help="async: clients kept in flight (default: "
                         "max(--clients, --buffer-size))")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="async: drop updates staler than this many versions")
    ap.add_argument("--over-select", type=float, default=1.0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="straggler cutoff seconds (None = 90%% quantile)")
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--wire-dtype", default="fp32",
                    choices=("fp32", "bf16", "fp16"))
    ap.add_argument("--wire-simulate", action="store_true",
                    help="route every update through a serialized frame")
    ap.add_argument("--faults", default=None,
                    help="chaos schedule: 'mild'/'aggressive' preset or "
                         "'crash_rate=0.1,corrupt_rate=0.2,...' (implies "
                         "--wire-simulate; requires --runtime)")
    ap.add_argument("--quorum", type=float, default=None,
                    help="min validated survivors per round: fraction of the "
                         "requested cohort if <= 1.0, else an absolute count")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="crash-safe checkpoint directory (atomic state + "
                         "manifest every --checkpoint-every rounds)")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir's manifest, replaying "
                         "the remaining rounds bit for bit")
    ap.add_argument("--telemetry", default="telemetry.jsonl",
                    help="JSONL event-log path (machine-readable round "
                         "reporting, on by default; 'off' disables)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON (Perfetto-loadable) "
                         "of the run's spans to this path")
    ap.add_argument("--prom-out", default=None,
                    help="Prometheus textfile-collector snapshot path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    tel = make_telemetry(
        jsonl=None if args.telemetry in ("off", "none", "") else args.telemetry,
        prometheus=args.prom_out, run_id=f"train-{args.method}-{args.seed}",
        workload="train")
    hist = run_training(arch=args.arch, task=args.task, method=args.method,
                 rounds=args.rounds, clients_per_round=args.clients,
                 total_clients=args.total_clients, batch_size=args.batch_size,
                 local_iters=args.local_iters, local_lr=args.lr,
                 server_lr=args.server_lr, dirichlet_alpha=args.alpha,
                 seed=args.seed, reduced=not args.full_size,
                 k_perturbations=args.k, jvp_clip=args.jvp_clip,
                 tangent_batch=args.tangent_batch,
                 fused_contraction=args.fused_contraction, device=args.device,
                 runtime=args.runtime, runtime_executor=args.runtime_executor,
                 runtime_microbatch=args.runtime_microbatch,
                 over_select=args.over_select, deadline=args.deadline,
                 dropout_rate=args.dropout_rate, wire_dtype=args.wire_dtype,
                 wire_simulate=args.wire_simulate, faults=args.faults,
                 quorum=args.quorum, checkpoint_dir=args.checkpoint_dir,
                 checkpoint_every=args.checkpoint_every, resume=args.resume,
                 async_mode=args.async_mode, buffer_size=args.buffer_size,
                 staleness_decay=args.staleness_decay,
                 async_concurrency=args.async_concurrency,
                 max_staleness=args.max_staleness, telemetry=tel)
    if tel.enabled:
        if args.trace_out:
            tel.export_chrome_trace(args.trace_out)
        tel.close()
        print(f"[telemetry] events -> {args.telemetry}"
              + (f"  trace -> {args.trace_out}" if args.trace_out else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)


if __name__ == "__main__":
    main()
