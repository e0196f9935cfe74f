"""The audio (encoder-decoder) family of the port, whisper-tiny, against the
JAX package on its reduced config (2 encoder and 2 decoder layers, d_model
256, 16 frames), fp32, with the reference's weights carried over
(``from_reference``) and numpy-seeded tokens and frames:

- the config's fields, the reduced config and the parameter estimates;
- the encoder (non-causal attention, sinusoidal positions, LayerNorm with
  biases), ``forward`` and ``forward_scanned``, ``lm_loss`` and ``cls_loss``
  with frames at rel 1e-5, the split composition bitwise equal to the
  forward;
- ``forward_gradient`` with K=4 on both estimator routes, the reference's
  perturbations injected, at rel 1e-5: the decoder's causal self-attention
  goes through the dispatched mixer, the encoder's attention never does;
- serving: ``prefill`` and ``decode_step`` with the encoder's memory in the
  cache (scalar and per-row positions; logits and caches at rel 1e-5),
  greedy ids equal to the reference's on the fused prefill and on the
  token loop (a cache shorter than the prompt), the engine with
  per-request frames equal to per-request greedy;
- the two repairs: ``enumerate_units`` stacks ``enc_layers`` as the
  reference does, and the encoder's attention is non-causal and never
  reaches the causal mixer inside the forward-AD region;
- ``from_reference`` on the encoder-decoder trees with the ``enc_layers``
  depth checked, ``init_peft``'s groups, the launch counts chip_smoke.py
  holds the path to, and the serve and train CLIs.

The reference's weights, losses, estimates and serving run under
``jax.jit``, computed once.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import assignment as jassign
from repro.core import forward_grad as jfg
from repro.launch import serve as jserve
from repro.models import encdec as jed
from repro.models import get_model as jget_model
from repro.models import registry as jreg
from repro.peft import init_peft as jinit_peft
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.core import forward_grad as tfg
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.launch import adapter_cache as tac
from repro_torch.launch import serve as tserve
from repro_torch.launch import serving as tserving
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import get_model as tget_model
from repro_torch.models import registry as treg
from repro_torch.peft import init_peft as tinit_peft
from repro_torch.peft import peft_layer_groups
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
B, S, K = 2, 12, 4          # batch, decoder tokens, tangents
P_LEN, NEW = 6, 4           # serving: prompt, new tokens


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, tree))


@functools.partial(jax.jit, static_argnums=0)
def _reference_weights(jc):
    """The reference's ``init_base`` and ``init_peft`` (every LoRA B factor
    made non-zero, the encoder's too), compiled once."""
    jbase = jed.init_base(jc, jax.random.PRNGKey(0))
    jpeft = jinit_peft(jc, jax.random.PRNGKey(1), jcfgs.SpryConfig())
    keys = iter(jax.random.split(jax.random.PRNGKey(2), 4))
    for group in ("layers", "enc_layers"):
        for t in ("wq", "wv"):
            jpeft[group][t]["B"] = 0.2 * jax.random.normal(next(keys),
                                                           jpeft[group][t]["B"].shape)
    return jbase, jpeft


@functools.partial(jax.jit, static_argnums=0)
def _reference_outputs(jc, jbase, jpeft, jb):
    key = jax.random.PRNGKey(7)
    h, aux = jed.forward(jc, jbase, jpeft, jb["tokens"], frames=jb["frames"])
    out = {"h": h, "aux": aux,
           "scanned": jed.forward_scanned(jc, jbase, jpeft, jb["tokens"],
                                          frames=jb["frames"])[0],
           "memory": jed.encode(jc, jbase, jb["frames"], jpeft),
           "lm": jreg.lm_loss(jc, jbase, jpeft, jb), "cls": jreg.cls_loss(jc, jbase, jpeft, jb)}
    for route, loss in (("standard", lambda p: jreg.lm_loss(jc, jbase, p, jb)),
                        ("fused", jreg.split_lm_loss(jc, jbase, jb))):
        out[route] = jfg.forward_gradient(loss, jpeft, key, K,
                                          fused_contraction=route == "fused")
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    out["vs"] = jfg.stacked_perturbations(key, peft32, jnp.arange(K))
    return out


@functools.lru_cache(maxsize=None)
def _stack():
    jc = jcfgs.reduce_config(jcfgs.get_config(ARCH))
    tc = tcfgs.reduce_config(tcfgs.get_config(ARCH))
    jbase, jpeft = _reference_weights(jc)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jc.n_classes, (B,)).astype(np.int32),
             "frames": rng.standard_normal((B, jc.encoder_seq, jc.d_model)).astype(np.float32)}
    s = dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
             jb={k: jnp.asarray(v) for k, v in batch.items()},
             tb={k: torch.from_numpy(v) for k, v in batch.items()})
    s["ref"] = _reference_outputs(jc, jbase, jpeft, s["jb"])
    return s


# ---------------------------------------------------------------------------
# config, encoder, forward, losses
# ---------------------------------------------------------------------------

def test_config_fields_equal_reference():
    full_j, full_t = jcfgs.get_config(ARCH), tcfgs.get_config(ARCH)
    for jc, tc in ((full_j, full_t), (jcfgs.reduce_config(full_j),
                                      tcfgs.reduce_config(full_t))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_param_estimate() == jc.n_param_estimate()
        assert tc.n_active_param_estimate() == jc.n_active_param_estimate()
    tc = tcfgs.reduce_config(full_t)
    assert (tc.encoder_layers, tc.encoder_seq, tc.family, tc.rope_theta) == (2, 16, "audio", 0)
    assert full_t.encoder_seq == 1500 and full_t.vocab % 8     # 51865


def test_encoder_forward_and_scanned_match_reference():
    s = _stack()
    tc, ref = s["tc"], s["ref"]
    frames, toks = s["tb"]["frames"], s["tb"]["tokens"]
    with torch.no_grad():
        memory = ted.encode(tc, s["tbase"], frames, s["tpeft"])
        h, aux = ted.forward(tc, s["tbase"], s["tpeft"], toks, frames=frames)
        scanned, aux2 = ted.forward_scanned(tc, s["tbase"], s["tpeft"], toks, frames=frames)
    assert memory.shape == (B, tc.encoder_seq, tc.d_model)
    assert _rel(memory, ref["memory"]) <= 1e-5
    assert _rel(h, ref["h"]) <= 1e-5 and _rel(scanned, ref["scanned"]) <= 1e-5
    assert float(aux) == float(aux2) == float(ref["aux"]) == 0.0
    torch.testing.assert_close(scanned, h, rtol=1e-6, atol=1e-6)
    pos = ted.sinusoidal_positions(7, tc.d_model)
    assert torch.equal(pos, torch.from_numpy(np.array(
        jed.sinusoidal_positions(7, tc.d_model))))


def test_losses_match_reference():
    s = _stack()
    with torch.no_grad():
        lm = treg.lm_loss(s["tc"], s["tbase"], s["tpeft"], s["tb"])
        cls = treg.cls_loss(s["tc"], s["tbase"], s["tpeft"], s["tb"])
    assert _rel(lm, s["ref"]["lm"]) <= 1e-5
    assert _rel(cls, s["ref"]["cls"]) <= 1e-5


def test_split_composition_equals_forward_bitwise():
    s = _stack()
    tc, model = s["tc"], tget_model(s["tc"])
    with torch.no_grad():
        h, _ = model.forward(tc, s["tbase"], s["tpeft"], s["tb"])
        site, ctx = model.split_forward(tc, s["tbase"], s["tpeft"], s["tb"])
        h2, _ = model.split_post(tc, s["tbase"], model.mixer_site(tc, site), ctx,
                                 s["tpeft"], s["tb"])
        split = treg.split_lm_loss(tc, s["tbase"], s["tb"])(s["tpeft"])
        plain = treg.lm_loss(tc, s["tbase"], s["tpeft"], s["tb"])
    assert model.split_site(tc) == ("swa", {"window": None})
    assert site[0].shape == (B, tc.n_heads, S, tc.hd)
    assert torch.equal(h, h2) and torch.equal(split, plain)


@pytest.mark.parametrize("route", ["standard", "fused"])
def test_forward_gradient_matches_reference(route, monkeypatch):
    """Inside the estimator only the decoder's causal self-attention takes
    the dispatched mixer: once a decoder layer, never the encoder's."""
    s = _stack()
    tc = s["tc"]
    jloss, jg, jjvps = s["ref"][route]
    calls = []
    orig = dispatch.swa_attend
    monkeypatch.setattr(dispatch, "swa_attend",
                        lambda q, k, v, w: calls.append(q.shape) or orig(q, k, v, w))
    loss = (treg.split_lm_loss(tc, s["tbase"], s["tb"]) if route == "fused"
            else lambda p: treg.lm_loss(tc, s["tbase"], p, s["tb"]))
    tloss, tg, tjvps = tfg.forward_gradient(loss, s["tpeft"], 0, K,
                                            perturbations=_to_t(s["ref"]["vs"]),
                                            fused_contraction=route == "fused")
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-5
    # standard: every decoder layer in the region; fused: the final site's
    # primal runs in the region too, its tangents in the contraction op
    assert len(calls) == tc.n_layers
    assert all(c[2] == S for c in calls)


# ---------------------------------------------------------------------------
# the two repairs
# ---------------------------------------------------------------------------

def test_enumerate_units_stacks_encoder_layers_as_reference():
    s = _stack()
    ji, ti = jassign.enumerate_units(s["jpeft"]), tassign.enumerate_units(s["tpeft"])
    assert ti.units == ji.units and ti.spans == ji.spans
    assert ("enc_layers", "wq", 1) in ti.units
    assert ti.n_units == 2 * (s["tc"].n_layers + s["tc"].encoder_layers)
    row = tassign.assignment_matrix(ti.n_units, 3, 1)[1]
    mask = tassign.build_mask_tree(s["tpeft"], ti, row)
    jmask = jassign.build_mask_tree(s["jpeft"], ji, jassign.assignment_matrix(ji.n_units, 3, 1)[1])
    for a, b in zip(jax.tree.leaves(jmask), tree_leaves(mask)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_encoder_attention_is_non_causal_and_skips_the_causal_mixer(monkeypatch):
    """``attn_block_prefill(causal=False)`` inside the forward-AD region
    attends to every position (a change to the last frame moves the first
    output) through the plain chunked attention, as the reference's; the
    dispatched causal mixer is never called and no kernel launches."""
    s = _stack()
    tc = s["tc"]
    calls = []
    monkeypatch.setattr(dispatch, "swa_attend", lambda *a: calls.append(a))
    lp = {k: v[0] for k, v in s["tbase"]["enc_layers"]["attn"].items()}
    pl = {k: {n: t[0] for n, t in v.items()} for k, v in s["tpeft"]["enc_layers"].items()}
    x = s["tb"]["frames"].clone()
    x2 = x.clone()
    x2[:, -1] += 1.0
    reset_launch_counts()
    with torch.no_grad(), dispatch.forward_ad_region():
        out = tattn.attn_block_prefill(tc, lp, x, pl, 1.0, causal=False)
        out2 = tattn.attn_block_prefill(tc, lp, x2, pl, 1.0, causal=False)
        memory = ted.encode(tc, s["tbase"], s["tb"]["frames"], s["tpeft"])
    assert not calls and not any(launch_counts().values())
    assert not torch.allclose(out[:, 0], out2[:, 0])
    assert _rel(memory, s["ref"]["memory"]) <= 1e-5
    q, k, v = tattn.attn_site_qkv(tc, lp, x, pl, 1.0)
    want = tattn.attend_prefill(q, k, v, causal=False)
    got = tattn.attn_finish(tc, lp, want, pl, 1.0)
    assert torch.equal(out, got)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_serving(per_row):
    s = _stack()
    jc, model = s["jc"], jget_model(s["jc"])
    prompt = s["jb"]["tokens"][:, :P_LEN]
    pos = jnp.asarray([P_LEN, P_LEN - 2], jnp.int32) if per_row else jnp.int32(P_LEN)

    @jax.jit
    def run(jbase, jpeft, prompt, frames):
        cache = model.init_cache(jc, B, P_LEN + NEW)
        cache = dict(cache, memory=jed.encode(jc, jbase, frames, jpeft))
        logits0, cache0 = model.prefill(jc, jbase, jpeft, cache, prompt)
        tok = jnp.argmax(logits0, -1)[:, None].astype(jnp.int32)
        logits1, cache1 = model.decode_step(jc, jbase, jpeft, cache0, tok, pos)
        return logits0, cache0, tok, logits1, cache1
    return run(s["jbase"], s["jpeft"], prompt, s["jb"]["frames"]), np.array(prompt), \
        np.array(pos)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_prefill_and_decode_match_reference(per_row):
    s = _stack()
    tc = s["tc"]
    (logits0, cache0, tok, logits1, cache1), prompt, pos = _reference_serving(per_row)
    model = tget_model(tc)
    cache = model.init_cache(tc, B, P_LEN + NEW, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in cache0.items()}
    tserve.encode_into_cache(tc, s["tbase"], s["tpeft"], cache, s["tb"]["frames"])
    assert _rel(cache["memory"], cache0["memory"]) <= 1e-5
    with torch.inference_mode():
        got0, cache = model.prefill(tc, s["tbase"], s["tpeft"], cache,
                                    torch.from_numpy(prompt))
        assert _rel(got0, logits0) <= 1e-5
        assert np.array_equal(torch.argmax(got0, -1)[:, None].numpy(), np.asarray(tok))
        for k in ("k", "v"):
            assert _rel(cache[k], cache0[k]) <= 1e-5
        got1, cache = model.decode_step(tc, s["tbase"], s["tpeft"], cache,
                                        torch.from_numpy(np.array(tok)),
                                        torch.from_numpy(pos) if per_row else int(pos))
    assert _rel(got1, logits1) <= 1e-5
    assert np.array_equal(torch.argmax(got1, -1).numpy(), np.argmax(logits1, -1))
    for k in ("k", "v"):
        assert _rel(cache[k], cache1[k]) <= 1e-5


@pytest.mark.parametrize("cache_len", [P_LEN + NEW, P_LEN - 2],
                         ids=["full_cache", "short_cache"])
def test_greedy_ids_equal_reference(cache_len):
    """Greedy with frames, ids equal to the reference's, on the fused
    prefill and on the token loop; ``can_fuse_prefill`` decides as the
    reference's, and sends a cache shorter than the prompt to the token
    loop (full attention: no ring keeps what the fused pass would see)."""
    s = _stack()
    jc, tc = s["jc"], s["tc"]
    tm, jm = tget_model(tc), jget_model(jc)
    fusible = tserve.can_fuse_prefill(tc, tm, tm.init_cache(tc, B, cache_len, device="cpu"),
                                      P_LEN)
    assert fusible == jserve.can_fuse_prefill(jc, jm, jm.init_cache(jc, B, cache_len),
                                              P_LEN) == (cache_len >= P_LEN)
    if not fusible:
        return
    steps = cache_len - P_LEN
    prompt = s["jb"]["tokens"][:, :P_LEN]
    want = jserve.greedy_generate(jc, s["jbase"], s["jpeft"], prompt, steps,
                                  cache_len=cache_len, frames=s["jb"]["frames"])
    got = tserve.greedy_generate(tc, s["tbase"], s["tpeft"], torch.from_numpy(np.array(prompt)),
                                 steps, cache_len=cache_len, frames=s["tb"]["frames"])
    assert np.array_equal(got.numpy(), np.asarray(want))
    loop = tserve.greedy_generate(tc, s["tbase"], s["tpeft"], torch.from_numpy(np.array(prompt)),
                                  steps, cache_len=cache_len, frames=s["tb"]["frames"],
                                  fused_prefill=False)
    assert torch.equal(loop, got)


def test_engine_with_frames_equals_per_request_greedy():
    """Three requests on three adapters (max_batch 2: an admission
    mid-flight), each with its own frames encoded with its adapter at
    admission: the engine's ids equal each request's B=1 greedy run."""
    tc = s_tc = _stack()["tc"]
    base = tget_model(tc).init_base(tc, torch.Generator().manual_seed(0))
    store = tac.SyntheticAdapterStore(s_tc, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [tserving.Request(f"r{i}", i, rng.integers(0, tc.vocab, 5).astype(np.int32), 4,
                             frames=rng.standard_normal((tc.encoder_seq, tc.d_model),
                                                        np.float32))
            for i in range(3)]
    eng = tserving.ServingEngine(tc, base, tac.AdapterCache(store, 2), max_batch=2,
                                 cache_len=10)
    out = eng.run(reqs)
    assert eng.steps > 3
    for r in reqs:
        ids = tserve.greedy_generate(tc, base, store.load(r.adapter_id),
                                     torch.from_numpy(r.prompt)[None], 4, cache_len=10,
                                     frames=torch.from_numpy(r.frames)[None])
        assert out[r.request_id] == ids[0].tolist()


# ---------------------------------------------------------------------------
# trees, launch counts, the entry points
# ---------------------------------------------------------------------------

def test_from_reference_carries_encdec_trees():
    s = _stack()
    tc = s["tc"]
    jleaves, tleaves = dict(tree_paths(_to_t(s["jbase"]))), dict(tree_paths(s["tbase"]))
    assert set(tleaves) == set(jleaves)
    for path, leaf in tleaves.items():
        assert torch.equal(leaf, jleaves[path]), path
    assert ("layers", "cross_attn", "wq_b") in tleaves and ("enc_norm", "b") in tleaves
    mine = dict(tree_paths(ted.init_base(tc, torch.Generator().manual_seed(0))))
    assert {p: tuple(v.shape) for p, v in mine.items()} == {
        p: tuple(v.shape) for p, v in tleaves.items()}
    for what in ("base", "peft"):
        trees = [jax.tree.map(np.asarray, s["jbase"]), jax.tree.map(np.asarray, s["jpeft"])]
        tree = trees[what == "peft"]
        leaf = tree["enc_layers"]["attn" if what == "base" else "wq"]
        key = "wq" if what == "base" else "A"
        leaf[key] = leaf[key][:1]
        with pytest.raises(ValueError, match=f"{what} enc_layers/.* has depth 1"):
            from_reference(tc, *trees, "cpu")


def test_init_peft_groups_as_reference():
    s = _stack()
    jc, tc = s["jc"], s["tc"]
    assert peft_layer_groups(tc) == [("layers", 2), ("enc_layers", 2)]
    mine = tinit_peft(tc, torch.Generator().manual_seed(0), tcfgs.SpryConfig())
    ref = jinit_peft(jc, jax.random.PRNGKey(0), jcfgs.SpryConfig())
    assert {p: tuple(v.shape) for p, v in tree_paths(mine)} == {
        p: tuple(v.shape) for p, v in tree_paths(_to_t(ref))}
    assert not any(v.any() for p, v in tree_paths(mine) if p[-1] == "B")


def test_chip_smoke_launch_counts_for_whisper(monkeypatch):
    """``chip_smoke.serve_launches`` (12 a decode step at whisper-tiny's 4
    decoder layers: self-attention wq, wv and cross-attention wq; the
    encoder runs at admission, on one page) against the engine's
    multi-adapter calls, and ``round_launches`` of one estimate against the
    LoRA projections the estimator makes on each route."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    full = tcfgs.get_config(ARCH)
    tc = dataclasses.replace(tcfgs.reduce_config(full), n_layers=full.n_layers,
                             encoder_layers=full.encoder_layers)
    calls = []
    orig = dispatch.lora_dual_multi
    monkeypatch.setattr(dispatch, "lora_dual_multi",
                        lambda *a: calls.append(a) or orig(*a))
    base = ted.init_base(tc, torch.Generator().manual_seed(0))
    eng = tserving.ServingEngine(
        tc, base, tac.AdapterCache(tac.SyntheticAdapterStore(tc, device="cpu"), 2),
        max_batch=2, cache_len=8)
    eng.run([tserving.Request(f"r{i}", i, np.arange(4, dtype=np.int32), 3,
                              frames=np.ones((tc.encoder_seq, tc.d_model), np.float32))
             for i in range(3)])
    want = chip_smoke.serve_launches(tc, eng.steps)
    assert len(calls) == want["lora_dual_multi"] == 12 * eng.steps > 0
    s = _stack()
    lora = []
    orig_mt = dispatch.lora_dual_mt_tangents
    monkeypatch.setattr(dispatch, "lora_dual_mt_tangents",
                        lambda *a: lora.append(1) or orig_mt(*a))
    for route in ("standard", "fused"):
        lora.clear()
        loss = treg.split_lm_loss(s["tc"], s["tbase"], s["tb"])
        tfg.forward_gradient(loss, s["tpeft"], 0, 2, fused_contraction=route == "fused")
        want = chip_smoke.round_launches(s["tc"], route, 1)
        assert len(lora) == want["lora_dual_mt"] == 2 * 2 + 3 * 2 - (route == "fused")


def test_serve_cli_runs_on_cpu_and_raises_without_a_card(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                 "--steps", "3"])
    assert "[serve] whisper-tiny: generated (2, 3)" in capsys.readouterr().out
    tserve.main(["--arch", ARCH, "--device", "cpu", "--engine", "3", "--batch", "2",
                 "--prompt-len", "4", "--steps", "3", "--cache-capacity", "2"])
    assert "3 requests drained" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", ARCH])


def test_train_cli_raises_for_whisper():
    with pytest.raises(ValueError, match="encoder frames"):
        ttrain.run_training(arch=ARCH, rounds=1, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", ARCH, "--rounds", "1"])
