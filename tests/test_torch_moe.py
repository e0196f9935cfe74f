"""The moe (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b) and vlm
(internvl2-76b) families of the port against the JAX package, on reduced
configs (2 layers, d_model 256, 4 experts, top-k <= 2, router chunks of 64
tokens, 8 patch embeddings), fp32, with the reference's weights carried
over (``from_reference``) and numpy-seeded inputs:

- every config field, the reduced configs and the parameter estimates;
- ``moe_block`` (out and aux at rel 1e-5) on one chunk, on several chunks
  with a padded tail, with capacity drops (``capacity_factor`` 0.5), top-1
  with a shared expert (llama4), on zero input and with tied gates (a zero
  router): ``lax.top_k`` breaks ties to the lower index, and so must the
  port;
- ``lm_loss`` and ``cls_loss`` at rel 1e-5 (llama4 and internvl2 with patch
  embeddings: RoPE over P+S, the LM loss on the text rows), the port's
  split composition bitwise equal to its forward;
- ``forward_gradient`` with K=4 on both estimator routes, the reference's
  perturbations injected, loss, jvps and gradient at rel 1e-5
  (tests/test_torch_spry.py's tolerances): qwen3 over two router chunks
  (the tail padded), internvl2 with patches;
- qwen3's ``prefill`` and ``decode_step`` against the reference's,
  ``can_fuse_prefill`` and ``supports_kv_int8`` as the reference has them,
  the engine's ids equal per-request greedy;
- ``from_reference`` on the moe trees (the router stays fp32), the draw
  rule of ``dense_init``, and the train CLI on reduced qwen3.

The reference's weights, losses and estimates run under ``jax.jit``,
computed once per arch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import forward_grad as jfg
from repro.launch import serve as jserve
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import forward_grad as tfg
from repro_torch.launch import adapter_cache as tac
from repro_torch.launch import serve as tserve
from repro_torch.launch import serving as tserving
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import get_model as tget_model
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)
ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "internvl2-76b")
B, S, K = 2, 40, 4           # batch, text tokens (B*S = 80: two router chunks), tangents


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, tree))


def _configs(arch):
    return (jcfgs.reduce_config(jcfgs.get_config(arch)),
            tcfgs.reduce_config(tcfgs.get_config(arch)))


@functools.partial(jax.jit, static_argnums=0)
def _reference_weights(jc):
    """The reference's ``init_base`` and ``init_peft`` (LoRA B factors made
    non-zero), compiled once."""
    jbase = jtf.init_base(jc, jax.random.PRNGKey(0))
    jpeft = jinit_peft(jc, jax.random.PRNGKey(1), jcfgs.SpryConfig())
    for t, k in zip(("wq", "wv"), jax.random.split(jax.random.PRNGKey(2), 2)):
        jpeft["layers"][t]["B"] = 0.2 * jax.random.normal(k, jpeft["layers"][t]["B"].shape)
    return jbase, jpeft


@functools.partial(jax.jit, static_argnums=0)
def _reference_outputs(jc, jbase, jpeft, jb):
    h, aux = jget_model(jc).forward(jc, jbase, jpeft, jb)
    return {"h": h, "aux": aux, "lm": jreg.lm_loss(jc, jbase, jpeft, jb),
            "cls": jreg.cls_loss(jc, jbase, jpeft, jb)}


@functools.partial(jax.jit, static_argnums=0)
def _reference_estimates(jc, jbase, jpeft, jb):
    """K=4 estimates of the LM loss on both routes (one key) and the
    perturbations they drew."""
    key = jax.random.PRNGKey(7)
    out = {}
    for route, loss in (("standard", lambda p: jreg.lm_loss(jc, jbase, p, jb)),
                        ("fused", jreg.split_lm_loss(jc, jbase, jb))):
        out[route] = jfg.forward_gradient(loss, jpeft, key, K,
                                          fused_contraction=route == "fused")
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    out["vs"] = jfg.stacked_perturbations(key, peft32, jnp.arange(K))
    return out


@functools.lru_cache(maxsize=None)
def _stack(arch):
    jc, tc = _configs(arch)
    jbase, jpeft = _reference_weights(jc)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jc.n_classes, (B,)).astype(np.int32)}
    if jc.n_frontend_tokens:
        batch["patch_embeds"] = rng.standard_normal(
            (B, jc.n_frontend_tokens, jc.d_model)).astype(np.float32)
    return dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
                jb={k: jnp.asarray(v) for k, v in batch.items()},
                tb={k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _outputs(arch):
    s = _stack(arch)
    return _reference_outputs(s["jc"], s["jbase"], s["jpeft"], s["jb"])


@functools.lru_cache(maxsize=None)
def _estimates(arch):
    s = _stack(arch)
    return _reference_estimates(s["jc"], s["jbase"], s["jpeft"], s["jb"])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _fields(c):
    d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    d["moe"] = None if c.moe is None else dataclasses.asdict(c.moe)
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    jfull, tfull = jcfgs.get_config(arch), tcfgs.get_config(arch)
    for jc, tc in ((jfull, tfull), _configs(arch)):
        assert _fields(tc) == _fields(jc)
        assert tc.hd == jc.hd and tc.sub_quadratic == jc.sub_quadratic
        assert tc.n_param_estimate() == jc.n_param_estimate()
        assert tc.n_active_param_estimate() == jc.n_active_param_estimate()
    # the reduced cut as the reference's: <= 4 experts, top-k <= 2, d_expert
    # 128, router chunks of 64, 8 patches
    tr = _configs(arch)[1]
    assert (tr.moe is None) == (tfull.moe is None)
    if tr.moe is not None:
        assert (tr.moe.n_experts, tr.moe.d_expert, tr.moe.router_chunk) == (4, 128, 64)
        assert tr.moe.top_k == min(tfull.moe.top_k, 2)
        assert tfull.n_active_param_estimate() < tfull.n_param_estimate()
    assert tr.n_frontend_tokens == (8 if tfull.n_frontend_tokens else 0)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

# name -> (arch, x shape, MoEConfig changes, router zeroed, input zeroed)
MOE_CASES = {
    "one_chunk": ("qwen3-moe-235b-a22b", (2, 16), {}, False, False),
    "padded_chunks": ("qwen3-moe-235b-a22b", (3, 50), {}, False, False),
    "capacity_drops": ("qwen3-moe-235b-a22b", (2, 32), {"capacity_factor": 0.5}, False, False),
    "top1_shared": ("llama4-maverick-400b-a17b", (3, 30), {}, False, False),
    "zero_input": ("qwen3-moe-235b-a22b", (2, 20), {}, False, True),
    "tied_gates": ("qwen3-moe-235b-a22b", (2, 40), {}, True, False),
}


@functools.partial(jax.jit, static_argnums=0)
def _reference_moe_params(jc):
    return jmoe.moe_params(jc, jax.random.PRNGKey(4))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(case):
    arch, (b, s), changes, zero_router, zero_x = MOE_CASES[case]
    jc, tc = _configs(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **changes))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **changes))
    jp = dict(_reference_moe_params(jc))
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    x = np.random.default_rng(1).standard_normal((b, s, jc.d_model)).astype(np.float32)
    if zero_x:
        x[:] = 0.0
    want_out, want_aux = jax.jit(lambda p, x: jmoe.moe_block(jc, p, x))(jp, jnp.asarray(x))
    got_out, got_aux = tmoe.moe_block(tc, _to_t(jp), torch.from_numpy(x))
    assert got_out.shape == (b, s, jc.d_model)
    T = b * s
    if zero_x or zero_router:        # every gate ties: the first top-k experts
        topi = tmoe._top_k(torch.full((T, 4), 0.25), tc.moe.top_k)[1]
        assert torch.equal(topi, torch.arange(tc.moe.top_k).expand(T, -1))
        assert float(got_aux) == float(want_aux) == 1.0
    if zero_x:
        assert not got_out.any()
    else:
        assert _rel(got_out, want_out) <= 1e-5
        assert _rel(got_aux, want_aux) <= 1e-5
    if case == "capacity_drops":      # some token lost an expert: its weight is not 1
        C = tmoe._capacity(T, tc.moe)
        assert C * tc.moe.n_experts < T * tc.moe.top_k


def test_expert_matmul_rules():
    """The expert product's rules: the primal, K stacked tangents (folded
    into the rows; a batched weight too), one tangent, and reverse mode,
    each equal to the plain batched product."""
    from torch.func import jvp, vmap
    g = torch.Generator().manual_seed(6)
    x, w = torch.randn(4, 3, 16, generator=g), torch.randn(4, 16, 8, generator=g)
    vs, ws = torch.randn(5, 4, 3, 16, generator=g), torch.randn(5, 4, 16, 8, generator=g)
    y, yd = vmap(lambda v: jvp(lambda a: tmoe.expert_matmul(a, w), (x,), (v,)),
                 out_dims=(None, 0))(vs)
    assert torch.equal(y, torch.bmm(x, w))
    torch.testing.assert_close(yd, torch.einsum("kecd,edf->kecf", vs, w))
    _, yd2 = vmap(lambda v, u: jvp(tmoe.expert_matmul, (x, w), (v, u)),
                  out_dims=(None, 0))(vs, ws)
    torch.testing.assert_close(yd2, torch.einsum("kecd,edf->kecf", vs, w)
                               + torch.einsum("ecd,kedf->kecf", x, ws))
    _, yd1 = jvp(lambda a: tmoe.expert_matmul(a, w), (x,), (vs[0],))
    torch.testing.assert_close(yd1, torch.bmm(vs[0], w))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(tmoe.expert_matmul(xg, wg).square().sum(), (xg, wg))
    rx, rw = torch.autograd.grad(torch.bmm(xg, wg).square().sum(), (xg, wg))
    torch.testing.assert_close(gx, rx)
    torch.testing.assert_close(gw, rw)


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(2)
    g = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4     # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(g), 3)
    got_v, got_i = tmoe._top_k(torch.from_numpy(g), 3)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# losses, the split composition, forward gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_reference(arch):
    s, ref = _stack(arch), _outputs(arch)
    tc = s["tc"]
    with torch.no_grad():
        h, aux = tget_model(tc).forward(tc, s["tbase"], s["tpeft"], s["tb"])
        lm = treg.lm_loss(tc, s["tbase"], s["tpeft"], s["tb"])
        cls = treg.cls_loss(tc, s["tbase"], s["tpeft"], s["tb"])
    assert h.shape == (B, tc.n_frontend_tokens + S, tc.d_model)
    assert _rel(h, ref["h"]) <= 1e-5
    if tc.moe is None:
        assert float(aux) == float(ref["aux"]) == 0.0
    else:
        assert float(aux) > 0 and _rel(aux, ref["aux"]) <= 1e-5
    assert _rel(lm, ref["lm"]) <= 1e-5
    assert _rel(cls, ref["cls"]) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_split_composition_equals_forward_bitwise(arch):
    s = _stack(arch)
    tc, model = s["tc"], tget_model(s["tc"])
    with torch.no_grad():
        h, aux = model.forward(tc, s["tbase"], s["tpeft"], s["tb"])
        site, ctx = model.split_forward(tc, s["tbase"], s["tpeft"], s["tb"])
        y = model.mixer_site(tc, site)
        h2, aux2 = model.split_post(tc, s["tbase"], y, ctx, s["tpeft"], s["tb"])
        split = treg.split_lm_loss(tc, s["tbase"], s["tb"])(s["tpeft"])
        plain = treg.lm_loss(tc, s["tbase"], s["tpeft"], s["tb"])
    assert site[0].shape[2] == tc.n_frontend_tokens + S     # patches in the sequence
    assert torch.equal(h, h2) and torch.equal(aux, aux2)
    assert torch.equal(split, plain)


@pytest.mark.parametrize("route", ["standard", "fused"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "internvl2-76b"])
def test_forward_gradient_matches_reference(arch, route):
    s, ref = _stack(arch), _estimates(arch)
    tc = s["tc"]
    jloss, jg, jjvps = ref[route]
    loss = (treg.split_lm_loss(tc, s["tbase"], s["tb"]) if route == "fused"
            else lambda p: treg.lm_loss(tc, s["tbase"], p, s["tb"]))
    tloss, tg, tjvps = tfg.forward_gradient(loss, s["tpeft"], 0, K,
                                            perturbations=_to_t(ref["vs"]),
                                            fused_contraction=route == "fused")
    assert tjvps.shape == (K,)
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-5


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_serving(per_row):
    s = _stack("qwen3-moe-235b-a22b")
    jc = s["jc"]
    model = jget_model(jc)
    prompt = s["jb"]["tokens"][:, :12]
    pos = jnp.asarray([12, 9], jnp.int32) if per_row else jnp.int32(12)

    @jax.jit
    def run(jbase, jpeft, prompt):
        logits0, cache0 = model.prefill(jc, jbase, jpeft, model.init_cache(jc, B, 16), prompt)
        tok = jnp.argmax(logits0, -1)[:, None].astype(jnp.int32)
        logits1, cache1 = model.decode_step(jc, jbase, jpeft, cache0, tok, pos)
        return logits0, cache0, tok, logits1, cache1
    return run(s["jbase"], s["jpeft"], prompt), np.array(prompt), np.array(pos)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_prefill_and_decode_match_reference(per_row):
    """qwen3 (MoE, GQA 4:2): a 12-token prefill (one router chunk of 24
    tokens, capacity 15) then one decode step, logits and caches at rel
    1e-5; per_row decodes each row at its own position."""
    s = _stack("qwen3-moe-235b-a22b")
    tc = s["tc"]
    (logits0, cache0, tok, logits1, cache1), prompt, pos = _reference_serving(per_row)
    model = tget_model(tc)
    cache = model.init_cache(tc, B, 16, device="cpu")
    with torch.inference_mode():
        got0, cache = model.prefill(tc, s["tbase"], s["tpeft"], cache,
                                    torch.from_numpy(prompt))
        assert _rel(got0, logits0) <= 1e-5
        for k in ("k", "v"):
            assert _rel(cache[k], cache0[k]) <= 1e-5
        got1, cache = model.decode_step(tc, s["tbase"], s["tpeft"], cache,
                                        torch.from_numpy(np.asarray(tok)),
                                        torch.from_numpy(pos) if per_row else int(pos))
    assert _rel(got1, logits1) <= 1e-5
    for k in ("k", "v"):
        assert _rel(cache[k], cache1[k]) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_capabilities_as_reference(arch):
    jc, tc = _configs(arch)
    jm, tm = jget_model(jc), tget_model(tc)
    assert tm.supports_kv_int8 == jm.supports_kv_int8 is True
    for Sc, P in ((16, 8), (8, 16)):
        for kv_int8 in (False, True):
            jcache = jm.init_cache(jc, 1, Sc, kv_int8=kv_int8)
            tcache = tm.init_cache(tc, 1, Sc, kv_int8=kv_int8, device="cpu")
            assert {k: tuple(v.shape) for k, v in tcache.items()} == {
                k: v.shape for k, v in jcache.items()}
            assert tserve.can_fuse_prefill(tc, tm, tcache, P) == \
                jserve.can_fuse_prefill(jc, jm, jcache, P)


def test_engine_ids_equal_per_request_greedy():
    """Reduced qwen3 through the ServingEngine (3 requests on 3 adapters,
    max_batch 2: an admission mid-flight) against each request's own B=1
    greedy run with its adapter, ids equal: admission is the B=1 prefill,
    and a batched decode step routes each row's token alone (capacity 4
    per expert, at most 2 tokens a step)."""
    tc = _configs("qwen3-moe-235b-a22b")[1]
    base = tget_model(tc).init_base(tc, torch.Generator().manual_seed(0))
    store = tac.SyntheticAdapterStore(tc, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [tserving.Request(f"r{i}", i, rng.integers(0, tc.vocab, 6).astype(np.int32), 5)
            for i in range(3)]
    eng = tserving.ServingEngine(tc, base, tac.AdapterCache(store, 2), max_batch=2,
                                 cache_len=12)
    out = eng.run(reqs)
    for r in reqs:
        ids = tserve.greedy_generate(tc, base, store.load(r.adapter_id),
                                     torch.from_numpy(r.prompt)[None], 5, cache_len=12)
        assert out[r.request_id] == ids[0].tolist()


# ---------------------------------------------------------------------------
# conversion, the draw rule, the train entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"])
def test_from_reference_carries_moe_trees(arch):
    s = _stack(arch)
    tc = s["tc"]
    jleaves = dict(tree_paths(_to_t(s["jbase"])))
    tleaves = dict(tree_paths(s["tbase"]))
    assert set(tleaves) == set(jleaves)
    for path, leaf in tleaves.items():
        assert torch.equal(leaf, jleaves[path]), path
    E, f = tc.moe.n_experts, tc.moe.d_expert
    assert tleaves[("layers", "moe", "router")].dtype == torch.float32
    assert tuple(tleaves[("layers", "moe", "wi")].shape) == (tc.n_layers, E, tc.d_model, f)
    assert (("layers", "moe", "shared", "wi") in tleaves) == bool(tc.moe.n_shared_experts)
    assert not any("mlp" in p for p in tleaves)
    bf = dataclasses.replace(tc, param_dtype="bfloat16")
    mine = dict(tree_paths(tget_model(bf).init_base(bf, torch.Generator().manual_seed(0))))
    assert {p: tuple(v.shape) for p, v in mine.items()} == {
        p: tuple(v.shape) for p, v in tleaves.items()}
    assert mine[("layers", "moe", "router")].dtype == torch.float32
    assert mine[("layers", "moe", "wi")].dtype == torch.bfloat16
    bad = jax.tree.map(np.asarray, s["jbase"])
    bad["layers"]["moe"]["wi"] = bad["layers"]["moe"]["wi"][:1]
    with pytest.raises(ValueError, match="base layers/moe/wi has depth 1"):
        from_reference(tc, bad, jax.tree.map(np.asarray, s["jpeft"]), "cpu")


def test_dense_init_draws_slices_only_past_the_limit(monkeypatch):
    """A draw within the limit is one ``randn`` (values unchanged by the
    sliced rule); past it each leading slice is drawn on its own, and a
    slice still past it is cut again (llama4's one-layer expert leaf)."""
    def draw(shape):
        return tcommon.dense_init(torch.Generator().manual_seed(5), shape)
    whole = draw((3, 4, 5, 6))
    g = torch.Generator().manual_seed(5)
    assert torch.equal(whole, torch.randn((3, 4, 5, 6), generator=g) / np.sqrt(5.0))
    monkeypatch.setattr(tcommon, "_DRAW_BYTES_MAX", 4 * 4 * 5 * 6)   # one layer fits
    by_layer = draw((3, 4, 5, 6))
    g = torch.Generator().manual_seed(5)
    assert torch.equal(by_layer, torch.stack(
        [torch.randn((4, 5, 6), generator=g) / np.sqrt(5.0) for _ in range(3)]))
    monkeypatch.setattr(tcommon, "_DRAW_BYTES_MAX", 4 * 5 * 6)       # one expert fits
    by_expert = draw((3, 4, 5, 6))
    g = torch.Generator().manual_seed(5)
    assert torch.equal(by_expert, torch.stack([torch.stack(
        [torch.randn((5, 6), generator=g) / np.sqrt(5.0) for _ in range(4)])
        for _ in range(3)]))


def test_train_cli_on_reduced_qwen3(tmp_path):
    argv = ["--arch", "qwen3-moe-235b-a22b", "--rounds", "1", "--clients", "2",
            "--total-clients", "6", "--batch-size", "2", "--k", "2", "--telemetry", "off"]
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(argv)
    hist = ttrain.run_training(arch="qwen3-moe-235b-a22b", rounds=1, clients_per_round=2,
                               total_clients=6, batch_size=2, k_perturbations=2,
                               eval_every=1, device="cpu", log=lambda _: None)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["personalized_acc"] <= 1.0
