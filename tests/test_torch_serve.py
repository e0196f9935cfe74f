"""The port's serving path against the JAX package, on reduced llama2
(fp32) with the reference's own weights and adapters carried over:

- ``lora_dual_multi_ref`` against the reference's oracle and its 'jnp'
  mirror (fp32 at rel 1e-6, bf16 within two bf16 ulps of the largest value);
  ``proj`` with a page index row by row against single-adapter ``proj``;
- ``init_cache``, ``prefill`` and ``decode_step`` (scalar and per-row
  ``pos``, int8 KV; decode from the reference's prefill cache): logits at
  rel 1e-5, K/V caches at rel 1e-5 (the rows come out of matrix products
  summed in another order) and int8 caches equal but for entries whose
  fp32 value straddles a rounding boundary (off by one, at most 1e-3 of
  them; on this input one K entry after prefill, none after decode);
- ``can_fuse_prefill`` decides as the reference for full, sliding-window
  and local:global stacks, and a fusible ring prefill equals the token loop;
- greedy ids, ``AdapterCache`` residency and page round trips, and the
  ``ServingEngine``'s ids equal the reference's; the engine's ids equal
  per-request greedy;
- the serve CLI runs on ``--device cpu``, raises without a card, and rejects
  the later slices' flags;
- no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the JAX package.

Each reference run is computed once per module (the ``ref`` fixture).
"""
import ast
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.kernels import dispatch as jdispatch
from repro.kernels.lora_dual import ref as jlref
from repro.launch import adapter_cache as jac
from repro.launch import serve as jserve
from repro.launch import serving as jserving
from repro.models import get_model as jget_model
from repro.models import transformer as jtf
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference, peft_from_reference
from repro_torch.kernels.dispatch import lora_proj_multi
from repro_torch.kernels.lora_dual import ops as tops
from repro_torch.launch import adapter_cache as tac
from repro_torch.launch import serve as tserve
from repro_torch.launch import serving as tserving
from repro_torch.models import get_model as tget_model
from repro_torch.models import transformer as ttf
from repro_torch.models.common import proj
from repro_torch.utils.pytree import tree_leaves

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
P_LEN, NEW = 8, 5            # prompt length, new tokens


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class _InjectedStore:
    """The reference's synthetic adapters, carried into the port."""

    def __init__(self, jstore, cfg):
        self.jstore, self.cfg = jstore, cfg

    def template(self):
        return self.load(0)

    def load(self, aid):
        return peft_from_reference(self.cfg, _np_tree(self.jstore.load(aid)), "cpu")


@pytest.fixture(scope="module")
def ref():
    """Reduced llama2 on both sides: configs, the reference's weights and
    adapters (carried over), and the reference runs the tests compare with."""
    jc = jcfgs.reduce_config(jcfgs.get_config("llama2-7b"))
    tc = tcfgs.reduce_config(tcfgs.get_config("llama2-7b"))
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jstore = jac.SyntheticAdapterStore(jc, seed=0)
    jstore.load = jax.jit(jstore.load)   # compiled once, not op by op
    jpeft = jstore.load(5)
    tbase, tpeft = from_reference(tc, _np_tree(jbase), _np_tree(jpeft), "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jc.vocab, (2, P_LEN)).astype(np.int32)
    r = dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
             jstore=jstore, prompt=prompt)
    r.update(serve_reference(jc, jbase, jpeft, jstore, prompt, NEW, int8=True))
    return r


def serve_reference(jc, jbase, jpeft, jstore, prompt, new, int8=False):
    """The reference's serving runs of one config, which the port is held
    to (shared by the families' serve test files):

    - ``steps``: prefill of ``prompt`` (B=2) into a cache of P + ``new``,
      then one decode step, with a scalar ``pos`` ('scalar'), a per-row
      ``pos`` of [P, P-3] ('per_row') and, with ``int8``, an int8 KV cache:
      (logits0, cache0, tok, pos, logits1, cache1) as numpy;
    - ``greedy``: ``greedy_generate`` ids of ``prompt``, ``new`` steps;
    - the engine on ``_requests`` (5 requests over 3 adapters, max_batch 2,
      capacity 2: rows admitted mid-flight, pages evicted): its outputs,
      adapter cache stats and decode steps."""
    P = prompt.shape[1]
    model = jget_model(jc)
    steps = {}
    prefill = jax.jit(lambda c: model.prefill(jc, jbase, jpeft, c, prompt))
    decode = jax.jit(lambda c, tok, pos: model.decode_step(jc, jbase, jpeft, c, tok, pos))
    cases = (("scalar", False, P), ("per_row", False, None))
    for name, q8, pos in cases + ((("int8", True, P),) if int8 else ()):
        kw = {"kv_int8": True} if q8 else {}
        logits0, cache0 = prefill(model.init_cache(jc, 2, P + new, **kw))
        jpos = (jnp.int32(pos) if pos is not None
                else jnp.asarray([P, P - 3], jnp.int32))
        tok = jnp.argmax(logits0, -1)[:, None].astype(jnp.int32)
        logits1, cache1 = decode(cache0, tok, jpos)
        steps[name] = jax.tree.map(np.asarray, (logits0, cache0, tok, jpos, logits1,
                                                cache1))
    r = {"steps": steps, "new": new,
         "greedy": np.asarray(jserve.greedy_generate(jc, jbase, jpeft,
                                                     jnp.asarray(prompt), new))}
    jcache = jac.AdapterCache(jstore, capacity=2)
    jeng = jserving.ServingEngine(jc, jbase, jcache, max_batch=2,
                                  cache_len=P_LEN + NEW)
    r["engine_out"] = jeng.run(_requests(jc))
    r["engine_stats"] = jcache.stats()
    r["engine_steps"] = jeng.steps
    return r


def _requests(cfg, module=jserving):
    rng = np.random.default_rng(7)
    return [module.Request(request_id=f"r{i}", adapter_id=i % 3,
                           prompt=rng.integers(0, cfg.vocab, P_LEN).astype(np.int32),
                           max_new_tokens=(5, 3, 4, 2, 5)[i])
            for i in range(5)]


# ---------------------------------------------------------------------------
# the multi-adapter projection
# ---------------------------------------------------------------------------

def _multi_inputs(M, K, N, P, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    a = (rng.standard_normal((P, K, r)) / np.sqrt(K)).astype(np.float32)
    b = (0.5 * rng.standard_normal((P, r, N))).astype(np.float32)
    idx = np.concatenate([np.arange(P), rng.integers(0, P, M - P)]).astype(np.int32)
    return x, idx, w, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,P,r", [(6, 64, 48, 3, 1), (5, 33, 17, 3, 4)],
                         ids=["even", "ragged"])
def test_lora_dual_multi_ref_matches_reference(dtype, M, K, N, P, r):
    x, idx, w, a, b = _multi_inputs(M, K, N, P, r)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    got = tops.lora_dual_multi_ref(torch.tensor(np.asarray(xj, np.float32)).to(tdt),
                                   torch.from_numpy(idx),
                                   torch.tensor(np.asarray(wj, np.float32)).to(tdt),
                                   torch.from_numpy(a), torch.from_numpy(b), 0.5)
    assert got.dtype == tdt and got.shape == (M, N)
    oracle = jlref.lora_dual_multi_ref(xj, jnp.asarray(idx), wj, jnp.asarray(a),
                                       jnp.asarray(b), 0.5)
    jdispatch.set_backend("jnp")
    try:   # the mirror, rows as the engine gives them: (M, 1, K) with (M,) pages
        mirror = jdispatch.lora_proj_multi(xj[:, None], jnp.asarray(idx), wj,
                                           jnp.asarray(a), jnp.asarray(b), 0.5)[:, 0]
    finally:
        jdispatch.set_backend(None)
    assert mirror.dtype == jdt
    if dtype == "float32":
        assert _rel(got, oracle) <= 1e-6
        assert _rel(got, mirror) <= 1e-6
    else:   # both round x@W and the rank-r term to bf16 before adding
        ulp2 = 2.0 ** -7 * float(jnp.abs(mirror.astype(jnp.float32)).max())
        assert float(np.abs(got.float().numpy() - np.asarray(mirror, np.float32)).max()) <= ulp2
        assert float(np.abs(got.float().numpy() - np.asarray(oracle, np.float32)).max()) <= ulp2


def test_proj_with_pages_equals_single_adapter_proj():
    """Row b of a multi-adapter ``proj`` is single-adapter ``proj`` with
    page idx[b], at fp32 rel 1e-6 (not bitwise: the CPU GEMM blocks a
    4-row product differently from a 1-row one)."""
    x, idx, w, a, b = (torch.from_numpy(t) for t in _multi_inputs(4, 64, 32, 3, 2))
    x = x[:, None]                                   # (B, 1, K) decode rows
    y = proj(x, w, lora={"A": a, "B": b, "idx": idx}, lora_scale=0.5)
    for row in range(4):
        one = proj(x[row:row + 1], w, lora={"A": a[idx[row]], "B": b[idx[row]]},
                   lora_scale=0.5)
        assert _rel(y[row:row + 1], one.detach()) <= 1e-6
    with pytest.raises(NotImplementedError, match="no gradient"):
        lora_proj_multi(x, idx, w, a.requires_grad_(), b, 0.5)


# ---------------------------------------------------------------------------
# prefill / decode / cache
# ---------------------------------------------------------------------------

def _cache_close(got, want):
    for name, w in want.items():
        g = got[name]
        assert (g.dtype == torch.int8) == (w.dtype == np.int8), name
        if g.dtype == torch.int8:
            # an fp32 row a few ulps apart may round to the neighbouring int8
            diff = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, name
        else:
            assert _rel(g, w) <= 1e-5, name


def check_prefill_and_decode(ref, case):
    """``init_cache`` shapes and dtypes equal the reference's; ``prefill``
    logits and every cache leaf, then one ``decode_step`` from the
    reference's own prefill cache, against ``serve_reference``'s run."""
    tc = ref["tc"]
    model = tget_model(tc)
    logits0, cache0, tok, jpos, logits1, cache1 = ref["steps"][case]
    kw = {"kv_int8": True} if case == "int8" else {}
    cache = model.init_cache(tc, 2, ref["prompt"].shape[1] + ref["new"],
                             device="cpu", **kw)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in cache0.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in cache.items()} == {
        k: v.dtype.name for k, v in cache0.items()}
    with torch.inference_mode():
        got0, cache = model.prefill(tc, ref["tbase"], ref["tpeft"], cache,
                                    torch.from_numpy(ref["prompt"]))
        assert _rel(got0, logits0) <= 1e-5
        _cache_close(cache, cache0)
        # decode from the reference's own prefill cache: one int8 entry a
        # rounding boundary apart moves the logits by ~1e-4
        cache = {k: torch.from_numpy(v.copy()) for k, v in cache0.items()}
        pos = int(jpos) if jpos.ndim == 0 else torch.from_numpy(jpos.copy())
        got1, cache = model.decode_step(tc, ref["tbase"], ref["tpeft"], cache,
                                        torch.from_numpy(tok.copy()), pos)
    assert got1.shape == (2, tc.vocab) and got1.dtype == torch.float32
    assert _rel(got1, logits1) <= 1e-5
    _cache_close(cache, cache1)


@pytest.mark.parametrize("case", ["scalar", "per_row", "int8"])
def test_prefill_and_decode_match_reference(ref, case):
    check_prefill_and_decode(ref, case)


@pytest.mark.parametrize("pattern,window,Sc,P", [
    ("full", 64, 6, 8),          # global layers, ring shorter than the prompt
    ("full", 64, 12, 8),
    ("swa", 4, 4, 8),            # all-swa ring covering the window: fusible
    ("swa", 8, 6, 8),            # ring narrower than the window: lossy
    ("local_global", 4, 6, 8),
    ("local_global", 4, 12, 8),
])
def test_can_fuse_prefill_decides_as_reference(pattern, window, Sc, P):
    kw = dict(attn_pattern=pattern, window=window,
              local_global_ratio=1 if pattern == "local_global" else 0)
    jc = dataclasses.replace(jcfgs.reduce_config(jcfgs.get_config("llama2-7b")), **kw)
    tc = dataclasses.replace(tcfgs.reduce_config(tcfgs.get_config("llama2-7b")), **kw)
    jm, tm = jget_model(jc), tget_model(tc)
    for int8 in (False, True):
        jcache = jm.init_cache(jc, 1, Sc, kv_int8=int8)
        tcache = tm.init_cache(tc, 1, Sc, kv_int8=int8, device="cpu")
        assert tcache["k"].shape == jcache["k"].shape
        assert (tserve.can_fuse_prefill(tc, tm, tcache, P)
                == jserve.can_fuse_prefill(jc, jm, jcache, P))


def test_fused_ring_prefill_equals_token_loop():
    """An all-sliding-window stack whose ring (4) is shorter than the prompt
    (10) but covers the window: the fused prefill keeps each slot's last
    occupant, as the token loop does."""
    tc = dataclasses.replace(tcfgs.reduce_config(tcfgs.get_config("llama2-7b")),
                             attn_pattern="swa", window=4)
    model = tget_model(tc)
    gen = torch.Generator().manual_seed(0)
    base = model.init_base(tc, gen)
    prompt = torch.randint(0, tc.vocab, (2, 10), generator=gen)
    fused = model.init_cache(tc, 2, 16, device="cpu")
    loop = model.init_cache(tc, 2, 16, device="cpu")
    assert fused["k"].shape[2] == 4 and tserve.can_fuse_prefill(tc, model, fused, 10)
    fns = tserve.build_serve_fns(tc, model)
    lf, fused = fns["prefill"](base, None, fused, prompt)
    ll, loop = tserve.tokenwise_prefill(tc, model, base, None, loop, prompt)
    assert _rel(lf, ll) <= 1e-5
    for name in ("k", "v"):
        assert _rel(fused[name], loop[name].numpy()) <= 1e-5


def check_greedy(ref):
    """Greedy ids, fused prefill and token loop alike, equal the
    reference's."""
    ids = tserve.greedy_generate(ref["tc"], ref["tbase"], ref["tpeft"],
                                 torch.from_numpy(ref["prompt"]), ref["new"])
    np.testing.assert_array_equal(ids.numpy(), ref["greedy"])
    loop = tserve.greedy_generate(ref["tc"], ref["tbase"], ref["tpeft"],
                                  torch.from_numpy(ref["prompt"]), ref["new"],
                                  fused_prefill=False)
    np.testing.assert_array_equal(loop.numpy(), ref["greedy"])


def test_greedy_ids_equal_reference(ref):
    check_greedy(ref)


def check_fused_prefill(ref, plen, new=NEW):
    """A prompt of ``plen`` tokens: the fused prefill equals
    ``tokenwise_prefill`` (logits and every cache leaf at rel 1e-5), and
    greedy ids come out the same either way."""
    tc = ref["tc"]
    model = tget_model(tc)
    prompt = torch.randint(0, tc.vocab, (2, plen),
                           generator=torch.Generator().manual_seed(plen))
    fused = model.init_cache(tc, 2, plen + new, device="cpu")
    loop = model.init_cache(tc, 2, plen + new, device="cpu")
    assert tserve.can_fuse_prefill(tc, model, fused, plen)
    fns = tserve.build_serve_fns(tc, model)
    lf, fused = fns["prefill"](ref["tbase"], ref["tpeft"], fused, prompt)
    ll, loop = tserve.tokenwise_prefill(tc, model, ref["tbase"], ref["tpeft"],
                                        loop, prompt)
    assert _rel(lf, ll) <= 1e-5
    for name, want in loop.items():
        assert _rel(fused[name], want.float().numpy()) <= 1e-5, name
    ids = [tserve.greedy_generate(tc, ref["tbase"], ref["tpeft"], prompt, 3,
                                  fused_prefill=f, fns=fns) for f in (True, False)]
    assert torch.equal(*ids)
    return fused


def check_scatter_axis(ref, leaves):
    """Every cache leaf (named ``leaves``) carries batch on axis 1, as
    ``serving._scatter_row`` assumes: a B=1 cache scattered into row 2 of a
    B=3 cache lands there and nowhere else."""
    model = tget_model(ref["tc"])
    one = model.init_cache(ref["tc"], 1, 16, device="cpu")
    big = model.init_cache(ref["tc"], 3, 16, device="cpu")
    assert set(one) == set(leaves)
    for name, leaf in one.items():
        torch.nn.init.normal_(leaf)
        want = list(leaf.shape)
        want[1] = 3
        assert list(big[name].shape) == want, name
    tserving._scatter_row(big, one, 2)
    for name, leaf in one.items():
        assert torch.equal(big[name][:, 2], leaf[:, 0]), name
        assert not big[name][:, :2].any(), name


def check_forward_scanned(ref, tmod, jmod):
    """``tmod.forward_scanned`` equals ``tmod.forward`` within the
    reference's own tolerance (rtol = atol = 2e-5) and the reference's
    ``jmod.forward_scanned`` at rel 1e-5."""
    tc, jc = ref["tc"], ref["jc"]
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        h_scan, aux = tmod.forward_scanned(tc, ref["tbase"], ref["tpeft"],
                                           torch.from_numpy(tokens))
        h_split, _ = tmod.forward(tc, ref["tbase"], ref["tpeft"],
                                  torch.from_numpy(tokens))
    np.testing.assert_allclose(h_split.numpy(), h_scan.numpy(), rtol=2e-5, atol=2e-5)
    assert float(aux) == 0.0
    want, _ = jmod.forward_scanned(jc, ref["jbase"], ref["jpeft"], jnp.asarray(tokens))
    assert _rel(h_scan, np.asarray(want)) <= 1e-5


# ---------------------------------------------------------------------------
# adapter cache and engine
# ---------------------------------------------------------------------------

def test_adapter_cache_matches_reference(ref):
    """The same acquire/pin/unpin sequence on both caches: the same pages,
    LRU order, stats and pin refusals; every resident page slices back out
    as the store's tree, equal to the reference's page."""
    jcache = jac.AdapterCache(ref["jstore"], capacity=2)
    tcache = tac.AdapterCache(_InjectedStore(ref["jstore"], ref["tc"]), capacity=2)
    ops = [("acquire", 0), ("acquire", 1), ("acquire", 0), ("acquire", 2),
           ("pin", 2), ("pin", 2), ("acquire", 1), ("pin", 1), ("acquire", 3),
           ("unpin", 2), ("acquire", 3), ("unpin", 2), ("acquire", 0),
           ("unpin", 1), ("acquire", 4)]
    for op, aid in ops:
        outs = []
        for c in (jcache, tcache):
            try:
                outs.append(getattr(c, op)(aid))
            except RuntimeError as e:
                outs.append(("refused", "pinned" in str(e)))
        assert outs[0] == outs[1], (op, aid)
        assert jcache.resident() == tcache.resident()
        assert jcache.stats() == tcache.stats()
        for aid_r in tcache.resident():
            page = tcache._pages[aid_r]
            want = ref["jstore"].load(aid_r)
            got = tcache.page_tree(page)
            jgot = jcache.page_tree(jcache._pages[aid_r])
            assert set(got) == set(jgot) == {"layers"}
            for a, b, c in zip(tree_leaves(got), jax.tree.leaves(jgot),
                               jax.tree.leaves(want["layers"])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(c))
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tcache.stats()["evictions"] >= 2
    jm, tm = jcache.multi_peft([1, 0, 1]), tcache.multi_peft([1, 0, 1])
    for t in ("wq", "wv"):
        np.testing.assert_array_equal(tm["layers"][t]["idx"].numpy(),
                                      np.asarray(jm["layers"][t]["idx"]))
        assert tm["layers"][t]["A"].shape == jm["layers"][t]["A"].shape


def test_synthetic_store_is_deterministic_and_distinct():
    tc = tcfgs.reduce_config(tcfgs.get_config("llama2-7b"))
    store = tac.SyntheticAdapterStore(tc, seed=3, device="cpu")
    a, again, other = store.load(1), store.load(1), store.load(2)
    for x, y, z in zip(*(tree_leaves(t["layers"]) for t in (a, again, other))):
        assert torch.equal(x, y) and not torch.equal(x, z)
    b = a["layers"]["wq"]["B"]
    assert 0.03 < float(b.std()) < 0.07      # 0.05 * N(0, 1), not init's zeros


def check_engine(ref):
    """The port's engine on the reference's adapters and requests: ids,
    adapter cache stats and decode steps equal the reference engine's, and
    each request's ids equal its own greedy run."""
    tc = ref["tc"]
    store = _InjectedStore(ref["jstore"], tc)
    tcache = tac.AdapterCache(store, capacity=2)
    eng = tserving.ServingEngine(tc, ref["tbase"], tcache, max_batch=2,
                                 cache_len=P_LEN + NEW)
    reqs = _requests(tc, tserving)
    out = eng.run(reqs)
    assert out == ref["engine_out"]
    assert tcache.stats() == ref["engine_stats"] and tcache.stats()["evictions"] > 0
    assert eng.steps == ref["engine_steps"]
    fns = tserve.build_serve_fns(tc, tget_model(tc))
    for req in reqs:
        ids = tserve.greedy_generate(tc, ref["tbase"], store.load(req.adapter_id),
                                     torch.from_numpy(req.prompt)[None],
                                     req.max_new_tokens, cache_len=P_LEN + NEW,
                                     fns=fns)
        assert out[req.request_id] == ids[0].tolist(), req.request_id


def test_engine_ids_equal_reference_and_greedy(ref):
    check_engine(ref)


@pytest.mark.parametrize("arch,per_step", [("llama2-7b", 64), ("rwkv6-1.6b", 48),
                                           ("zamba2-1.2b", 88)])
def test_serve_launches_counts_every_adapted_projection(arch, per_step, monkeypatch):
    """``chip_smoke.serve_launches`` against the multi-adapter calls an
    engine really makes, at each arch's full depth and layer pattern
    (reduced width, on the CPU): one a decode step per adapted projection,
    none from the B=1 admission prefill."""
    from repro_torch.kernels import dispatch
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    full = tcfgs.get_config(arch)
    tc = dataclasses.replace(tcfgs.reduce_config(full), n_layers=full.n_layers,
                             hybrid_attn_every=full.hybrid_attn_every)
    calls = []
    monkeypatch.setattr(dispatch, "lora_dual_multi",
                        lambda *a: calls.append(a) or tops.lora_dual_multi(*a))
    base = tget_model(tc).init_base(tc, torch.Generator().manual_seed(0))
    eng = tserving.ServingEngine(
        tc, base, tac.AdapterCache(tac.SyntheticAdapterStore(tc, device="cpu"), 2),
        max_batch=2, cache_len=8)
    eng.run([tserving.Request(f"r{i}", i, np.arange(4, dtype=np.int32), 3)
             for i in range(3)])
    want = chip_smoke.serve_launches(tc, eng.steps)
    assert len(calls) == want["lora_dual_multi"] == per_step * eng.steps > 0
    assert sum(want.values()) == want["lora_dual_multi"]


def test_engine_rejects_overlong_request(ref):
    tc = ref["tc"]
    eng = tserving.ServingEngine(
        tc, ref["tbase"], tac.AdapterCache(_InjectedStore(ref["jstore"], tc), 2),
        max_batch=2, cache_len=8)
    eng.submit(tserving.Request(request_id="big", adapter_id=0,
                                prompt=np.zeros(6, np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="cache_len"):
        eng.step()


# ---------------------------------------------------------------------------
# the entry point and the port's isolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,engine", [
    pytest.param("llama2-7b", False, id="greedy"),
    pytest.param("llama2-7b", True, id="engine"),
    pytest.param(None, False, id="rwkv6-1.6b-greedy"),     # the default arch
    pytest.param(None, True, id="rwkv6-1.6b-engine"),
    pytest.param("zamba2-1.2b", False, id="zamba2-1.2b-greedy"),
    pytest.param("zamba2-1.2b", True, id="zamba2-1.2b-engine"),
])
def test_serve_cli_runs_on_cpu(arch, engine, capsys):
    argv = ["--device", "cpu", "--steps", "3", "--prompt-len", "4", "--batch", "2"]
    argv += ["--arch", arch] if arch else []
    if engine:
        argv += ["--engine", "3", "--cache-capacity", "2"]
    tserve.main(argv)
    out = capsys.readouterr().out
    if engine:
        assert "[serve] engine: 3 requests drained in" in out and "'evictions': 1" in out
    else:
        assert (f"[serve] {arch or 'rwkv6-1.6b'}: generated (2, 3)" in out
                and "steady-state" in out)


@pytest.mark.parametrize("flags", [("telemetry",), ("telemetry", "trace-out"), ()],
                         ids=["telemetry", "trace-out", "off"])
def test_serve_cli_rejects_later_slices(flags, tmp_path, monkeypatch, capsys):
    """Engine mode's telemetry flags: ``--telemetry`` writes the run's
    events (``run_meta``, one ``request`` a request, the ``metrics``
    snapshot), ``--trace-out`` its Chrome trace, ``--telemetry off`` (as no
    flag) nothing."""
    monkeypatch.chdir(tmp_path)
    paths = {"telemetry": tmp_path / "serve.jsonl",
             "trace-out": tmp_path / "serve.trace.json"}
    argv = ["--arch", "llama2-7b", "--device", "cpu", "--engine", "3", "--steps", "2",
            "--prompt-len", "4", "--batch", "2", "--cache-capacity", "2"]
    argv += ["--telemetry", "off"] if not flags else []
    for flag in flags:
        argv += [f"--{flag}", str(paths[flag])]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] engine: 3 requests drained in" in out
    if not flags:
        assert "[telemetry]" not in out and not list(tmp_path.iterdir())
        return
    assert f"[telemetry] events -> {paths['telemetry']}" in out
    kinds = [json.loads(line)["kind"] for line in paths["telemetry"].read_text().splitlines()]
    assert kinds[:2] == ["run_meta", "run_meta"] and kinds[-1] == "metrics"
    assert kinds.count("request") == 3
    if "trace-out" in flags:
        doc = json.loads(paths["trace-out"].read_text())
        assert any(e["name"] == "serve.admit" for e in doc["traceEvents"])
    else:
        assert not paths["trace-out"].exists()


def test_serve_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "llama2-7b"])


@pytest.mark.parametrize("argv", [[], ["--arch", "zamba2-1.2b"], ["--engine", "2"]],
                         ids=["rwkv6-1.6b", "zamba2-1.2b", "rwkv6-1.6b-engine"])
def test_serve_cli_families_raise_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(argv)


def test_synthetic_store_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tac.SyntheticAdapterStore(tcfgs.reduce_config(tcfgs.get_config("llama2-7b")))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_or_reference():
    """Every module of the port, and chip_smoke.py, parsed with ``ast``:
    no import of jax (or jaxlib) or of the JAX package ``repro``."""
    banned = ("jax", "jaxlib", "repro")
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names
                      if n.split(".")[0] in banned]
    assert len(_port_sources()) > 40
    assert not found, found
