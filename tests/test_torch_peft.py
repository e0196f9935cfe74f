"""The port's IA3, BitFit and classifier-only PEFT trees against the JAX
package, on reduced configs with the reference's weights carried over
(``from_reference``) and numpy-seeded batches:

- ``init_peft`` trees (shapes, dtypes, the deterministic leaves' values)
  and ``count_trainable`` for all four kinds, reduced and at full
  roberta-large (102404 / 126980 / 53252 / 4100; 48 / 48 / 48 / 0 units);
- dense cls (roberta) and lm (llama2), each kind: the loss and one K=4
  estimate on the standard and the fused route, the reference's own
  perturbations injected, at rel 1e-5;
- one ``spry`` round per kind against the reference's, as
  ``tests/test_torch_spry.py::test_round_matches_reference`` (loss and
  jvps rel 1e-5, the PEFT update rel 1e-4);
- moe, hybrid, ssm and encdec: one forward and fused-route estimate with an
  IA3 and with a BitFit tree (a leaf the family does not read keeps a zero
  estimate, as in the reference);
- ``classifier_only``'s empty (M, 0) unit mask, its per-iteration round
  (client estimate == server rebuild, bitwise), and that no tangent kernel
  runs on either route;
- fused prefill against the token loop with IA3 and BitFit trees, and
  against the reference's prefill (BitFit is left out of serving);
- ``optim.momentum`` (with and without Nesterov) and
  ``optim.clip_by_global_norm``.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import optim as joptim
from repro.core import assignment as jassign
from repro.core import forward_grad as jfg
from repro.core import spry as jspry
from repro.models import get_model as jget_model
from repro.models import registry as jreg
from repro.peft import count_trainable as jcount
from repro.peft import init_peft as jinit_peft
from repro_torch import configs as tcfgs
from repro_torch import optim as toptim
from repro_torch.convert import from_reference
from repro_torch.core import assignment as tassign
from repro_torch.core import forward_grad as tfg
from repro_torch.core import spry as tspry
from repro_torch.kernels import calls
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model as tget_model
from repro_torch.models import registry as treg
from repro_torch.peft import count_trainable, init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

from port_reference import unoptimized_reference  # noqa: F401 (autouse)
from test_torch_fused import reference_rounds

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("ia3", "bitfit", "classifier_only")
M, B, S, K = 3, 2, 16, 4
FULL_COUNTS = {"lora": (102404, 48), "ia3": (126980, 48), "bitfit": (53252, 48),
               "classifier_only": (4100, 0)}
DENSE = {"cls": "roberta-large-lora", "lm": "llama2-7b"}
FAMILIES = {"moe": "qwen3-moe-235b-a22b", "hybrid": "zamba2-1.2b",
            "ssm": "rwkv6-1.6b", "encdec": "whisper-tiny"}


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


@functools.lru_cache(maxsize=None)
def _reference_base(jc):
    return jax.jit(jget_model(jc).init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _reference_peft(jc, kind):
    """The reference's ``kind`` tree, the IA3 scales and BitFit biases
    moved off their identity values (1 + 0.1 N, 0.1 N) so the comparisons
    see them."""
    jpeft = jinit_peft(jc, jax.random.PRNGKey(1), jcfgs.SpryConfig(peft=kind))
    leaves, tdef = jax.tree.flatten_with_path(jpeft)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    moved = []
    for (path, leaf), k in zip(leaves, keys):
        name = jax.tree_util.keystr(path)
        if "ia3" in name:
            leaf = 1.0 + 0.1 * jax.random.normal(k, leaf.shape)
        elif "bias" in name:
            leaf = 0.1 * jax.random.normal(k, leaf.shape)
        moved.append(leaf)
    return jax.tree.unflatten(tdef, moved)


def _batch(jc, rng, lead=(B,)):
    b = {"tokens": rng.integers(0, jc.vocab, lead + (S,)).astype(np.int32),
         "labels": rng.integers(0, jc.n_classes, lead).astype(np.int32)}
    if jc.encoder_layers:
        b["frames"] = rng.standard_normal(
            lead + (jc.encoder_seq, jc.d_model)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _stack(arch, kind):
    jc, tc = _configs(arch)
    jbase, jpeft = _reference_base(jc), _reference_peft(jc, kind)
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    batch = _batch(jc, np.random.default_rng(0))
    return dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
                jb={k: jnp.asarray(v) for k, v in batch.items()},
                tb={k: torch.from_numpy(v) for k, v in batch.items()})


def _client_mask(peft, assign):
    index = assign.enumerate_units(peft)
    return assign.build_mask_tree(peft, index,
                                  assign.assignment_matrix(index.n_units, M, 1)[1])


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 7))
def _reference_estimates(jc, task, jbase, jpefts, k, jb, masks, routes):
    """{kind: K-perturbation estimates of ``task`` on ``routes`` (one key,
    the kind's client mask; each returns the loss, which the split loss
    computes bitwise as the plain one) and the perturbations they drew},
    for each kind's tree of ``jpefts`` in ONE jit: the base model the kinds
    share is traced and compiled once."""
    key = jax.random.PRNGKey(7)
    out = {}
    for kind, jpeft in jpefts.items():
        plain = lambda p: jreg.get_loss_fn(task)(jc, jbase, p, jb)  # noqa: E731
        out[kind] = {}
        for route in routes:
            loss = (jreg.get_loss_fn(task, split=True)(jc, jbase, jb) if route == "fused"
                    else plain)
            out[kind][route] = jfg.forward_gradient(loss, jpeft, key, k,
                                                    mask_tree=masks[kind],
                                                    fused_contraction=route == "fused")
        peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
        out[kind]["vs"] = jfg.stacked_perturbations(key, peft32, jnp.arange(k))
    return out


def _port_estimate(s, task, route, vs, mask=None):
    tc = s["tc"]
    if route == "fused":
        loss = treg.get_loss_fn(task, split=True)(tc, s["tbase"], s["tb"])
    else:
        loss = lambda p: treg.get_loss_fn(task)(tc, s["tbase"], p, s["tb"])  # noqa: E731
    return tfg.forward_gradient(loss, s["tpeft"], 0, len(tree_leaves(vs)[0]),
                                mask_tree=mask, perturbations=vs,
                                fused_contraction=route == "fused")


def _check_estimate(ref, est, jg_route):
    """Loss and jvps at rel 1e-5. Each gradient leaf is the combine
    (1/K) sum_k jvps_k v_k, so it is held at 1e-5 of the size of its terms,
    (1/K) sum_k |jvps_k| |v_k|: a leaf the loss does not read (the head
    under the lm task) has an estimate that cancels across the K lanes,
    and there the jvps' own cross-framework error is all that is left."""
    jloss, jg, jjvps = jg_route
    tloss, tg, tjvps = est
    assert _rel(tloss, jloss) <= 1e-5
    assert _rel(tjvps, jjvps) <= 1e-5
    jv = np.abs(np.asarray(jjvps, np.float64))
    for a, b, v in zip(jax.tree.leaves(jg), tree_leaves(tg), jax.tree.leaves(ref["vs"])):
        terms = np.tensordot(jv, np.abs(np.asarray(v, np.float64)), axes=(0, 0)) / len(jv)
        err = np.abs(b.double().numpy() - np.asarray(a, np.float64))
        assert np.max(err) <= 1e-5 * max(np.max(terms), 1e-30)


# ---------------------------------------------------------------------------
# trees and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("lora",) + KINDS)
def test_init_peft_trees_match_reference(kind):
    """Reduced roberta and whisper (two stacked groups): the same leaves,
    shapes and dtypes; ones / zeros where the reference's are; the same
    trainable count and units."""
    for arch in ("roberta-large-lora", "whisper-tiny"):
        jc, tc = _configs(arch)
        jp = jax.eval_shape(lambda: jinit_peft(jc, jax.random.PRNGKey(0),
                                               jcfgs.SpryConfig(peft=kind)))
        tp = init_peft(tc, torch.Generator().manual_seed(0), tcfgs.SpryConfig(peft=kind))
        jpaths = [(tuple(p.key for p in path), leaf)
                  for path, leaf in jax.tree.flatten_with_path(jp)[0]]
        tpaths = tree_paths(tp)
        assert [p for p, _ in tpaths] == [p for p, _ in jpaths]
        for (path, t), (_, j) in zip(tpaths, jpaths):
            assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32, path
            if path[-1] in ("s",):
                assert torch.equal(t, torch.ones_like(t)), path
            if path[-1] == "B" or path[-2:] == ("head", "b") or path[-2:-1] in (
                    ("bias1",), ("bias2",)):
                assert not t.any(), path
        assert count_trainable(tp) == jcount(jp)
        assert tassign.enumerate_units(tp).units == jassign.enumerate_units(jp).units


@pytest.mark.parametrize("kind", ("lora",) + KINDS)
def test_count_trainable_at_full_roberta_large(kind):
    c = tcfgs.get_config("roberta-large-lora")
    tp = init_peft(c, torch.Generator().manual_seed(0), tcfgs.SpryConfig(peft=kind))
    jp = jax.eval_shape(lambda: jinit_peft(jcfgs.get_config("roberta-large-lora"),
                                           jax.random.PRNGKey(0),
                                           jcfgs.SpryConfig(peft=kind)))
    assert (count_trainable(tp), tassign.enumerate_units(tp).n_units) == FULL_COUNTS[kind]
    assert count_trainable(tp) == jcount(jp)


def test_unknown_peft_kind_raises():
    with pytest.raises(ValueError, match="prefix"):
        init_peft(_configs("roberta-large-lora")[1], torch.Generator(),
                  tcfgs.SpryConfig(peft="prefix"))


# ---------------------------------------------------------------------------
# dense: loss and estimates on both routes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dense_reference(task):
    stacks = {kind: _stack(DENSE[task], kind) for kind in KINDS}
    s = stacks[KINDS[0]]      # the kinds share the config, the base and the batch
    return _reference_estimates(
        s["jc"], task, s["jbase"], {kind: st["jpeft"] for kind, st in stacks.items()}, K,
        s["jb"], {kind: _client_mask(st["jpeft"], jassign) for kind, st in stacks.items()},
        ("standard", "fused"))


@pytest.mark.parametrize("route", ("standard", "fused"))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("task", ("cls", "lm"))
def test_dense_loss_and_estimate_match_reference(task, kind, route):
    s, ref = _stack(DENSE[task], kind), _dense_reference(task)[kind]
    tc = s["tc"]
    assert _rel(treg.get_loss_fn(task)(tc, s["tbase"], s["tpeft"], s["tb"]),
                ref["standard"][0]) <= 1e-5
    _check_estimate(ref, _port_estimate(s, task, route, _to_t(ref["vs"]),
                                        _client_mask(s["tpeft"], tassign)), ref[route])


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _round_kw():
    return dict(n_clients_per_round=M, k_perturbations=K, local_lr=5e-3,
                server_lr=1e-2, local_iters=2, seed=3)


def _round_stack(kind):
    s = _stack("roberta-large-lora", kind)
    batch = _batch(s["jc"], np.random.default_rng(1), lead=(M, B))
    return s, {k: jnp.asarray(v) for k, v in batch.items()}, \
        {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_rounds():
    stacks = {kind: _round_stack(kind) for kind in KINDS}
    jc = stacks[KINDS[0]][0]["jc"]
    steps = {kind: jspry.make_round_step(jc, jcfgs.SpryConfig(peft=kind, **_round_kw()))
             for kind in KINDS}
    states = {kind: jspry.init_state(st[0]["jbase"], st[0]["jpeft"])
              for kind, st in stacks.items()}
    # the three kinds' batches are the same draws
    return reference_rounds(steps, states, stacks[KINDS[0]][1])


def _reference_perturbations(jpeft, iters):
    rk = jax.random.fold_in(jax.random.PRNGKey(_round_kw()["seed"]), 0)
    peft32 = jax.tree.map(lambda x: x.astype(jnp.float32), jpeft)
    draw = jax.jit(jfg.stacked_perturbations)
    return [[_to_t(draw(jax.random.fold_in(jax.random.fold_in(rk, m), it), peft32,
                        jnp.arange(K))) for it in range(iters)] for m in range(M)]


@pytest.mark.parametrize("kind", KINDS)
def test_round_matches_reference(kind):
    s, _, tbatch = _round_stack(kind)
    jstate, jmet = _reference_rounds()[kind]
    tsc = tcfgs.SpryConfig(peft=kind, **_round_kw())
    tstate, tmet = tspry.make_round_step(s["tc"], tsc)(
        tspry.init_state(s["tbase"], s["tpeft"]), tbatch,
        _reference_perturbations(s["jpeft"], 2))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["jvp_abs_mean"], jmet["jvp_abs_mean"]) <= 1e-5
    for j_new, t_new, old in zip(jax.tree.leaves(jstate.peft), tree_leaves(tstate.peft),
                                 jax.tree.leaves(s["jpeft"])):
        j_delta = np.asarray(j_new, np.float64) - np.asarray(old, np.float64)
        t_delta = t_new.double().numpy() - np.asarray(old, np.float64)
        assert _rel(t_delta, j_delta) <= 1e-4


def test_classifier_only_mask_round_and_no_tangent_kernel():
    """No units: the (M, 0) mask and (0,) counts the reference gives; the
    head alone moves in a round; the per-iteration client's jvps rebuild
    on the server bit for bit; and neither route calls a tangent kernel
    (the body carries no tangent)."""
    s, _, tbatch = _round_stack("classifier_only")
    for off in (0, 2):
        jm = jassign.assignment_matrix(0, M, off)
        tm = tassign.assignment_matrix(0, M, off)
        assert tuple(tm.shape) == tuple(jm.shape) == (M, 0)
        assert tuple(tassign.client_counts(tm).shape) == (0,)
    sc = tcfgs.SpryConfig(peft="classifier_only", **_round_kw())
    cb = {k: v[1] for k, v in tbatch.items()}
    row = tassign.assignment_matrix(0, M, 0)[1]
    _, jvps = tspry.make_client_jvp_fn(s["tc"], sc)(s["tbase"], s["tpeft"], 11, 1, row, cb)
    rebuilt = tspry.make_rebuild_fn()(s["tpeft"], 11, 1, row, jvps)
    mask = tassign.build_mask_tree(s["tpeft"], tassign.enumerate_units(s["tpeft"]), row)
    key = tfg.fold_in(tfg.fold_in(11, 1), 0)
    for fused in (False, True):
        loss = (treg.get_loss_fn("cls", split=True)(s["tc"], s["tbase"], cb) if fused
                else lambda p: treg.cls_loss(s["tc"], s["tbase"], p, cb))
        with calls.record_calls() as rec:
            _, g, j = tfg.forward_gradient(loss, s["tpeft"], key, K, mask_tree=mask,
                                           fused_contraction=fused)
        # each layer's attention primal, no tangent or contraction call
        assert [c.name for c in rec] == ["swa_attention"] * s["tc"].n_layers
        if fused:       # <gy, 0> at the site: the head's term alone, reassociated
            assert _rel(j, jvps) <= 1e-5
            continue
        assert torch.equal(j, jvps)
        for a, b in zip(tree_leaves(g), tree_leaves(rebuilt)):
            assert torch.equal(a, b)
    tsc = tcfgs.SpryConfig(peft="classifier_only", **_round_kw())
    state, _ = tspry.make_round_step_per_iteration(s["tc"], tsc)(
        tspry.init_state(s["tbase"], s["tpeft"]), tbatch)
    assert set(state.peft) == {"head"}
    assert not torch.equal(state.peft["head"]["w"], s["tpeft"]["head"]["w"])


@pytest.mark.parametrize("route", ("standard", "fused"))
@pytest.mark.parametrize("kind", KINDS)
def test_chip_smoke_round_launches_by_kind(kind, route):
    """``chip_smoke.round_launches`` for a PEFT kind against the kernel
    entry points a round calls here (the plain versions, recorded at the
    boundary where the card's launch counters sit): no LoRA projection,
    no attention tangent in layer 0 under bitfit, none under
    classifier_only, one epilogue an estimate where the fused site has a
    tangent."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    s, _, tbatch = _round_stack(kind)
    sc = tcfgs.SpryConfig(peft=kind, fused_contraction=route == "fused",
                          **dict(_round_kw(), local_iters=1))
    with calls.record_calls() as rec:
        tspry.make_round_step(s["tc"], sc)(tspry.init_state(s["tbase"], s["tpeft"]),
                                           tbatch)
    got = {n: sum(c.name == n for c in rec) for n in chip_smoke.KERNELS}
    assert got == chip_smoke.round_launches(s["tc"], route, M, peft=kind)


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------

FAMILY_KINDS = ("ia3", "bitfit")


@functools.lru_cache(maxsize=None)
def _family_reference(family):
    stacks = {kind: _stack(FAMILIES[family], kind) for kind in FAMILY_KINDS}
    s = stacks[FAMILY_KINDS[0]]
    return _reference_estimates(s["jc"], "lm", s["jbase"],
                                {kind: st["jpeft"] for kind, st in stacks.items()}, 2,
                                s["jb"], dict.fromkeys(FAMILY_KINDS), ("fused",))


@pytest.mark.parametrize("kind", FAMILY_KINDS)
@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_family_forward_and_estimate_match_reference(family, kind):
    s, ref = _stack(FAMILIES[family], kind), _family_reference(family)[kind]
    tc = s["tc"]
    assert _rel(treg.lm_loss(tc, s["tbase"], s["tpeft"], s["tb"]), ref["fused"][0]) <= 1e-5
    est = _port_estimate(s, "lm", "fused", _to_t(ref["vs"]))
    _check_estimate(ref, est, ref["fused"])
    # a leaf the family's forward does not read keeps a zero estimate there too
    for a, b in zip(jax.tree.leaves(ref["fused"][1]), tree_leaves(est[1])):
        assert bool(jnp.any(a != 0)) == bool(b.any())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=0)
def _reference_prefill(jc, jbase, jpeft, prompt):
    model = jget_model(jc)
    return model.prefill(jc, jbase, jpeft, model.init_cache(jc, B, S), prompt)[0]


@pytest.mark.parametrize("kind", ("ia3", "bitfit"))
def test_prefill_equals_token_loop_and_reference(kind):
    s = _stack("llama2-7b", kind)
    tc = s["tc"]
    model = tget_model(tc)
    prompt = s["tb"]["tokens"][:, :S // 2]
    fused = model.init_cache(tc, B, S, device="cpu")
    loop = model.init_cache(tc, B, S, device="cpu")
    lf, fused = model.prefill(tc, s["tbase"], s["tpeft"], fused, prompt)
    ll, loop = tserve.tokenwise_prefill(tc, model, s["tbase"], s["tpeft"], loop, prompt)
    assert _rel(lf, ll) <= 1e-5
    for name, want in loop.items():
        assert _rel(fused[name], want.numpy()) <= 1e-5, name
    want = _reference_prefill(s["jc"], s["jbase"], s["jpeft"], s["jb"]["tokens"][:, :S // 2])
    assert _rel(lf, want) <= 1e-5


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}


@pytest.mark.parametrize("nesterov", (False, True))
def test_momentum_matches_reference(nesterov):
    jopt = joptim.momentum(0.1, beta=0.8, nesterov=nesterov)
    topt = toptim.momentum(0.1, beta=0.8, nesterov=nesterov)
    params = _grads(0)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    tstate = topt.init(tree_map(torch.from_numpy, params))
    for step in range(3):
        g = _grads(step + 1)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate)
        tu, tstate = topt.update(tree_map(torch.from_numpy, g), tstate)
        for a, b in zip(jax.tree.leaves(ju), tree_leaves(tu)):
            assert _rel(b, a) <= 1e-6


@pytest.mark.parametrize("max_norm", (0.5, 100.0), ids=("clipped", "unclipped"))
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(4)
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = toptim.clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    assert _rel(tn, jn) <= 1e-6
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _rel(b, a) <= 1e-6
