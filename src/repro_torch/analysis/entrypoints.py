"""The port's real entry points, run under the kernel-call recorder for the
rules to inspect. Stands for ``repro/analysis/entrypoints.py``.

The reference traces its entry points to jaxprs and lowered HLO without
running them. The port has no trace, so each function here RUNS the entry
point once at a reduced config, on the device asked for (the kernels on
the card, their plain versions on the CPU), inside ``record_calls()``:

* ``loss_traces``     every family x {lm, cls}: one K-perturbation
  estimate through ``core.forward_grad.forward_gradient`` on the fused
  route (the registry's split loss) and on the standard one;
* ``lora_site_traces`` a one-site split loss whose final site is a LoRA
  projection (the ``lora`` site kind of ``SplitLoss``, whose contraction
  epilogue is ``lora_dual_mt_jvps``);
* ``grad_guard_traces`` ``torch.autograd.grad`` of the plain loss outside
  ``forward_ad_region()``;
* ``serve_lowered``   the serve CLI's prefill and decode step
  (``launch.serve.build_serve_fns``), the cache's storage before and after;
* ``serving_engine_lowered`` the continuous-batching engine's admission
  (B=1 prefill, row scatter) and batched decode step;
* ``round_step_lowered`` the runtime ``FederationEngine`` round and the
  train loop's ``make_round_step``, the frozen base's storage before and
  after;
* ``telemetry_pair_lowered`` an engine round and the serving engine run
  twice, telemetry off and on;
* ``main_path_calls`` one call of each kernel at the main path's shapes,
  which the lint profiles on the card for the shared-memory table.

The names keep the reference's "lowered" for what is, here, one run.
``quick`` means dense + ssm. Everything is reduced (``reduce_config``;
B=1, S=16 for the estimates), so the whole sweep runs in about a minute on
the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.rules import storage_map
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.core.forward_grad import SplitLoss, forward_gradient
from repro_torch.kernels import dispatch
from repro_torch.kernels.calls import record_calls
from repro_torch.models.registry import get_loss_fn, get_model
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves

# one representative reduced arch per registry family (gemma3's
# local-global attention rides along as a seventh), as the reference's;
# ``hybrid_m2`` is zamba2 cut to 3 layers with the shared block every 2,
# so the final site is the mamba2 recurrence (reduced zamba2's is attention)
ARCHS = {
    "dense": "llama2-7b",
    "moe": "qwen3-moe-235b-a22b",
    "vlm": "internvl2-76b",
    "ssm": "rwkv6-1.6b",
    "hybrid": "zamba2-1.2b",
    "hybrid_m2": "zamba2-1.2b",
    "audio": "whisper-tiny",
    "local_global": "gemma3-12b",
}
VARIANTS = {"hybrid_m2": {"n_layers": 3, "hybrid_attn_every": 2}}
QUICK_FAMILIES = ("dense", "ssm")
TASKS = ("lm", "cls")

# which kernel family holds the final-mixer site of each split-loss kind
SITE_FAMILY = {"lora": "lora_dual", "wkv6": "wkv6_scan",
               "swa": "swa_attention", "mamba2": "mamba2_scan"}


@dataclasses.dataclass
class Trace:
    name: str              # e.g. "loss.dense.cls.fused"
    kind: str              # "fused_loss" | "standard_loss" | "grad_guard"
                           # | "lowered" | "telemetry_pair"
    calls: List = dataclasses.field(default_factory=list)   # KernelCall records
    K: Optional[int] = None
    y_shape: Optional[tuple] = None
    site_family: Optional[str] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _cfg(family):
    return dataclasses.replace(reduce_config(get_config(ARCHS[family])),
                               **VARIANTS.get(family, {}))


def build_setup(cfg, task, device, seed=0, B=1, S=16, spry_cfg=None):
    """Model, base, peft and a shaped batch for one family and task, drawn
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = get_model(cfg)
    base = model.init_base(cfg, gen)
    peft = init_peft(cfg, gen, spry_cfg or SpryConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)}
    if task == "cls":
        batch["labels"] = torch.randint(0, cfg.n_classes, (B,), generator=gen, device=device)
    if cfg.n_frontend_tokens:
        batch["patch_embeds"] = 0.1 * torch.randn(
            (B, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device=device)
    if cfg.encoder_layers:
        batch["frames"] = 0.1 * torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                            generator=gen, device=device)
    return model, base, peft, batch


def _y_shape(split, peft):
    with torch.no_grad(), dispatch.forward_ad_region():
        return tuple(split.site(split.pre(peft)[0]).shape)


def _estimate_traces(prefix, split, plain, peft, K, meta):
    y_shape = _y_shape(split, peft)
    site = SITE_FAMILY[split.kind]
    with record_calls() as fused:
        forward_gradient(split, peft, 0, K, fused_contraction=True)
    with record_calls() as standard:
        forward_gradient(plain, peft, 0, K)
    return [Trace(f"{prefix}.fused", "fused_loss", list(fused), K, y_shape, site,
                  dict(meta)),
            Trace(f"{prefix}.standard", "standard_loss", list(standard), K, y_shape,
                  site, dict(meta))]


def loss_traces(family: str, task: str, K: int = 4, device="cpu") -> List[Trace]:
    """Fused and standard estimator-route runs for one family and task."""
    cfg = _cfg(family)
    _, base, peft, batch = build_setup(cfg, task, device)
    split = get_loss_fn(task, split=True)(cfg, base, batch)
    plain = lambda p: get_loss_fn(task)(cfg, base, p, batch)  # noqa: E731
    return _estimate_traces(f"loss.{family}.{task}", split, plain, peft, K,
                            {"arch": ARCHS[family]})


def lora_site_traces(K: int = 4, device="cpu", D: int = 256, M: int = 64) -> List[Trace]:
    """A split loss whose final site is a LoRA projection fed by an
    upstream one (so the site's input carries a tangent): the ``lora`` site
    kind, whose fused route runs ``lora_dual_mt_jvps``."""
    gen = torch.Generator(device=device).manual_seed(3)
    f = lambda *sh: torch.randn(sh, generator=gen, device=device)  # noqa: E731
    x0, w0, w1 = 0.3 * f(M, D), 0.05 * f(D, D), 0.05 * f(D, D)
    peft = {"A0": 0.05 * f(D, 1), "B0": 0.05 * f(1, D), "A1": 0.05 * f(D, 1),
            "B1": 0.05 * f(1, D)}

    def pre(p):
        x = dispatch.lora_proj(x0, w0, p["A0"], p["B0"], 2.0)
        return (x, w1, p["A1"], p["B1"]), None
    split = SplitLoss(pre, "lora", lambda y, ctx, p: torch.mean(y * y), scale=2.0)
    return _estimate_traces("loss.lora_site", split, lambda p: split(p), peft, K,
                            {"arch": "lora-site"})


def grad_guard_traces(family: str, task: str = "cls", device="cpu") -> List[Trace]:
    """``torch.autograd.grad`` of the plain loss OUTSIDE forward_ad_region:
    must record no kernel call."""
    cfg = _cfg(family)
    _, base, peft, batch = build_setup(cfg, task, device)
    params = [t.requires_grad_() for t in tree_leaves(peft)]
    error = None
    with record_calls() as rec:
        try:
            loss = get_loss_fn(task)(cfg, base, peft, batch)
            torch.autograd.grad(loss, params, allow_unused=True)
        except (NotImplementedError, RuntimeError) as e:   # a kernel has no reverse rule
            error = f"{type(e).__name__}: {e}"
    return [Trace(f"grad.{family}.{task}", "grad_guard", list(rec),
                  meta={"arch": ARCHS[family], "error": error})]


def _donation_trace(name, arch, fn, carried):
    """Run ``fn`` under the recorder; ``carried`` maps the buffers it
    carries before and after (the second is read from ``fn``'s result)."""
    before = storage_map(carried(None))
    with record_calls() as rec:
        result = fn()
    return Trace(name, "lowered", list(rec),
                 meta={"arch": arch, "before": before, "after": storage_map(carried(result))})


def serve_lowered(family: str = "dense", B: int = 2, P: int = 8, steps: int = 8,
                  device="cpu") -> List[Trace]:
    """The serve CLI's prefill and decode step at serving shapes; every
    cache tensor must come back in its storage."""
    from repro_torch.launch.serve import build_serve_fns

    cfg = _cfg(family)
    model, base, peft, _ = build_setup(cfg, "lm", device, B=B)
    fns = build_serve_fns(cfg, model)
    cache = model.init_cache(cfg, B, P + steps, device=device)
    toks = torch.zeros((B, P), dtype=torch.int32, device=device)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    out = []
    if fns["prefill"] is not None:
        out.append(_donation_trace(
            f"serve.prefill.{family}", ARCHS[family],
            lambda: fns["prefill"](base, peft, cache, toks),
            lambda r: cache if r is None else r[1]))
    out.append(_donation_trace(
        f"serve.decode.{family}", ARCHS[family],
        lambda: fns["decode"](base, peft, cache, tok, P),
        lambda r: cache if r is None else r[1]))
    return out


def _engine(cfg, base, device, telemetry=None):
    from repro_torch.launch.adapter_cache import AdapterCache, SyntheticAdapterStore
    from repro_torch.launch.serving import ServingEngine
    return ServingEngine(cfg, base, AdapterCache(SyntheticAdapterStore(cfg, device=device),
                                                 capacity=2, telemetry=telemetry),
                         max_batch=2, cache_len=16, telemetry=telemetry)


def _requests(cfg, n=3):
    from repro_torch.launch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(f"r{i}", i % 2, rng.integers(0, cfg.vocab, (4 + i,)).astype(np.int32),
                    3) for i in range(n)]


def serving_engine_lowered(family: str = "dense", device="cpu") -> List[Trace]:
    """The serving engine's admission (B=1 prefill into a row cache, then
    the row scattered into the batch cache) and its batched decode step
    (``lora_dual_multi`` at every adapted projection)."""
    from repro_torch.launch.serving import _scatter_row

    cfg = _cfg(family)
    model, base, _, _ = build_setup(cfg, "lm", device)
    eng = _engine(cfg, base, device)
    peft1 = eng.adapters.page_tree(eng.adapters.acquire(0))
    cache1 = model.init_cache(cfg, 1, eng.cache_len, device=device)
    prompt = torch.zeros((1, 4), dtype=torch.int32, device=device)
    out = [_donation_trace(f"serving.decode1.{family}", ARCHS[family],
                           lambda: eng._prefill1(base, peft1, cache1, prompt),
                           lambda r: cache1 if r is None else r[1]),
           _donation_trace(f"serving.scatter.{family}", ARCHS[family],
                           lambda: _scatter_row(eng.cache, cache1, 0),
                           lambda r: eng.cache)]
    for r in _requests(cfg, 2):
        eng.submit(r)
    eng.step()                        # admit both rows, one batched step
    out.append(_donation_trace(f"serving.decode.{family}", ARCHS[family],
                               eng.step, lambda r: eng.cache))
    return out


def _round_setup(family, device, M=2, B=2, S=16):
    from repro_torch.core.spry import init_state
    cfg = _cfg(family)
    sc = SpryConfig(n_clients_per_round=M, n_total_clients=4, k_perturbations=2)
    _, base, peft, _ = build_setup(cfg, "cls", device, spry_cfg=sc)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (M, B, S), generator=gen, device=device),
             "labels": torch.randint(0, cfg.n_classes, (M, B), generator=gen, device=device)}
    return cfg, sc, (lambda: init_state(base, peft)), batch


def round_step_lowered(family: str = "ssm", device="cpu") -> List[Trace]:
    """The runtime FederationEngine's round and the train loop's round step
    at a tiny cohort; each must return the frozen base in its storage."""
    from repro_torch.core.spry import make_round_step
    from repro_torch.fl.runtime import FederationEngine, SerialExecutor, WireConfig

    cfg, sc, state0, batch = _round_setup(family, device)
    engine = FederationEngine(cfg, sc, task="cls", executor=SerialExecutor(),
                              wire=WireConfig(dtype="fp32"))
    step = make_round_step(cfg, sc, "cls")
    out = []
    for name, run in (("engine.round_step", engine.run_ideal), ("train.round_step", step)):
        st = state0()
        out.append(_donation_trace(name, ARCHS[family], lambda: run(st, batch),
                                   lambda r: st.base if r is None else r[0].base))
    return out


def telemetry_pair_lowered(family: str = "ssm", device="cpu") -> List[Trace]:
    """An engine round and the serving engine, each run with telemetry off
    and with an in-memory ``Telemetry``: the rule compares the recorded
    calls and the outputs."""
    from repro_torch.fl.runtime import FederationEngine, SerialExecutor, WireConfig
    from repro_torch.obs import InMemorySink, Telemetry

    def tel(on):
        return Telemetry(run_id="analysis", sinks=[InMemorySink()]) if on else None

    cfg, sc, state0, batch = _round_setup(family, device)
    runs = {}
    for on in (False, True):
        eng = FederationEngine(cfg, sc, task="cls", executor=SerialExecutor(),
                               wire=WireConfig(dtype="fp32"), telemetry=tel(on))
        with record_calls() as rec:
            state, metrics = eng.run_ideal(state0(), batch)
        runs[on] = (list(rec), tree_leaves(state.peft) + [metrics["loss"]])
    same = all(torch.equal(a, b) for a, b in zip(runs[False][1], runs[True][1]))
    traces = [Trace(f"telemetry.engine.round_step.{family}", "telemetry_pair",
                    meta={"arch": ARCHS[family], "calls_off": runs[False][0],
                          "calls_on": runs[True][0], "outputs_equal": same})]
    scfg = _cfg("dense")
    _, base, _, _ = build_setup(scfg, "lm", device)
    runs = {}
    for on in (False, True):
        eng = _engine(scfg, base, device, telemetry=tel(on))
        with record_calls() as rec:
            outputs = eng.run(_requests(scfg))
        runs[on] = (list(rec), outputs)
    traces.append(Trace("telemetry.serving.engine.dense", "telemetry_pair",
                        meta={"arch": ARCHS["dense"], "calls_off": runs[False][0],
                              "calls_on": runs[True][0],
                              "outputs_equal": runs[False][1] == runs[True][1]}))
    return traces


def main_path_calls() -> None:
    """One call of each of the twelve kernels at the main path's shapes
    (PERF.md §6: rows 1-5 roberta-large bf16, T=8, with and without an
    input tangent; row 6 llama2-7b's decode, M=4; rows 7-9 rwkv6-1.6b and
    10-12 zamba2 fp32 at a client batch, T=8), inputs from seed 0: the
    lint profiles them on the card, so the shared-memory table reads each
    main-path instantiation's block and dynamic shared memory."""
    from repro_torch.kernels.lora_dual import ops as lo
    from repro_torch.kernels.mamba2_scan import ops as mo
    from repro_torch.kernels.swa_attention import ops as so
    from repro_torch.kernels.wkv6_scan import ops as wo
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    f32 = torch.float32
    T, M, K, r = 8, 256, 1024, 1
    x, w = rn(M, K), rn(K, K, scale=0.03)
    a, b = rn(K, r, dtype=f32, scale=0.03), rn(r, K, dtype=f32, scale=0.03)
    ad, bd = rn(T, K, r, dtype=f32), rn(T, r, K, dtype=f32)
    for xd in (rn(T, M, K), None):                      # tc and store
        lo.lora_dual_mt_tangents(x, xd, w, a, ad, b, bd, 1.0)
        lo.lora_dual_mt_jvps(x, w, a, ad, b, bd, rn(M, K), 1.0, xdots=xd)
    q, k, v = (rn(8, 16, 32, 64) for _ in range(3))
    so.swa_attention(q, k, v)
    qd, kd, vd = (rn(T, 8, 16, 32, 64) for _ in range(3))
    so.swa_attention_mt_tangents(q, k, v, qd, kd, vd)
    so.swa_attention_mt_jvps(q, k, v, qd, kd, vd, rn(8, 16, 32, 64))
    P, KL = 4, 4096
    lo.lora_dual_multi(rn(4, KL), torch.arange(4, device="cuda"), rn(KL, KL, scale=0.02),
                       rn(P, KL, r, dtype=f32, scale=0.02), rn(P, r, KL, dtype=f32, scale=0.02),
                       1.0)
    B, S, H, hd = 8, 32, 32, 64                         # rwkv6: decay in (0, 1)
    prim = (*(rn(B, S, H, hd, dtype=f32, scale=0.5) for _ in range(3)),
            torch.exp(-torch.exp(0.5 + rn(B, S, H, hd, dtype=f32, scale=0.5))),
            rn(H, hd, dtype=f32, scale=0.3))
    tang = tuple(rn(T, B, S, H, hd, dtype=f32, scale=0.3) for _ in range(4))
    wo.wkv6_scan(*prim)
    wo.wkv6_scan_mt_tangents(*prim, *tang)
    wo.wkv6_scan_mt_jvps(*prim, *tang, rn(B, S, H, hd, dtype=f32))
    B, S, H, hd, N = 8, 32, 64, 64, 64                  # zamba2's mamba2
    prim = (rn(B, S, H, hd, dtype=f32, scale=0.3), rn(B, S, N, dtype=f32, scale=0.3),
            rn(B, S, N, dtype=f32, scale=0.3), torch.sigmoid(rn(B, S, H, dtype=f32)))
    tang = (rn(T, B, S, H, hd, dtype=f32, scale=0.3), rn(T, B, S, N, dtype=f32, scale=0.3),
            rn(T, B, S, N, dtype=f32, scale=0.3), rn(T, B, S, H, dtype=f32, scale=0.1))
    mo.mamba2_scan(*prim)
    mo.mamba2_scan_mt_tangents(*prim, *tang)
    mo.mamba2_scan_mt_jvps(*prim, *tang, rn(B, S, H, hd, dtype=f32))
    torch.cuda.synchronize()


def sweep(families=None, tasks=TASKS, quick=False, K: int = 4, device="cpu") -> List[Trace]:
    """The full registered entry-point sweep the lint runs."""
    if families is None:
        families = QUICK_FAMILIES if quick else tuple(ARCHS)
    traces: List[Trace] = []
    for fam in families:
        for task in tasks:
            traces += loss_traces(fam, task, K=K, device=device)
        traces += grad_guard_traces(fam, device=device)
    traces += lora_site_traces(K=K, device=device)
    traces += serve_lowered("dense", device=device)
    traces += serve_lowered("ssm", device=device)
    traces += serving_engine_lowered("dense", device=device)
    traces += round_step_lowered("ssm", device=device)
    traces += telemetry_pair_lowered("ssm", device=device)
    return traces
