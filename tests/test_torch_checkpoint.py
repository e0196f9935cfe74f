"""The port's crash-safe checkpoints (``repro_torch.checkpoint``), resume
through ``run_training``, and ``CheckpointAdapterStore``.

Inside the port: atomic writes, strict restores, manifest integrity; a
restored leaf has the template's type, device and dtype, a bf16 leaf bit
for bit; a run killed after 1 of 2 rounds and resumed ends bitwise where
the straight run ends (the final checkpoint's content hash, which covers
base, peft, server state and round index, and the history), for spry and
spry_periter with over-selection, dropout, the streaming executor, wire
simulation, the mild fault preset and a quorum, and for the in-process
path (its host rng restored from the manifest).

Across packages (the reference's files, written and read by the JAX
package's own ``checkpoint``): an fp32 checkpoint the reference wrote
loads in the port equal to ``convert.from_reference`` with the content
hash check passing; one the port wrote loads in the reference; the two
packages' content hashes of the same fp32 state are equal; a bf16 leaf the
reference wrote restores in the port bit for bit.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import configs as jcfgs
from repro.core.spry import init_state as jinit_state
from repro.models import transformer as jtf
from repro.peft import init_peft as jinit_peft
from repro_torch.checkpoint import (
    CheckpointError,
    RunManifest,
    load_checkpoint,
    load_pytree,
    read_manifest,
    save_checkpoint,
    save_pytree,
    tree_content_hash,
)
from repro_torch.configs import SpryConfig, get_config, reduce_config
from repro_torch.convert import from_reference
from repro_torch.core import init_state
from repro_torch.launch import train as ttrain
from repro_torch.launch.adapter_cache import AdapterCache, CheckpointAdapterStore
from repro_torch.models import get_model
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_map

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return tree_leaves(tree) if isinstance(tree, dict) else [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and (torch.equal(x, y) and x.dtype == y.dtype
                                if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(la, lb))


def _state(seed=0, scale=1.0):
    """A small SpryState: a bf16 base leaf, fp32 peft and moments, ints."""
    g = torch.Generator().manual_seed(seed)
    peft = {"head": {"W": scale * torch.randn(4, 2, generator=g)},
            "layers": {"wq": {"A": scale * torch.randn(2, 4, 1, generator=g)}}}
    st = init_state({"emb": torch.randn(8, 4, generator=g).bfloat16()}, peft)
    return st._replace(round_idx=3, server=st.server._replace(count=2))


# ---------------------------------------------------------------------------
# io and manifest
# ---------------------------------------------------------------------------

def test_roundtrip_keeps_types_dtypes_and_bits(tmp_path):
    st = _state()
    save_pytree(str(tmp_path / "s"), st)
    assert not os.path.exists(str(tmp_path / "s.npz.tmp"))
    with np.load(str(tmp_path / "s.npz")) as data:
        assert sorted(data.files) == [
            "base/emb", "peft/head/W", "peft/layers/wq/A", "round_idx",
            "server/count", "server/m/head/W", "server/m/layers/wq/A",
            "server/v/head/W", "server/v/layers/wq/A"]
        assert data["round_idx"].dtype == np.int32 and data["round_idx"] == 3
        assert data["base/emb"].dtype == np.dtype("V2")
    back = load_pytree(str(tmp_path / "s.npz"), _state(seed=1, scale=2.0))
    assert _equal(back, st)
    assert back.round_idx == 3 and back.server.count == 2
    assert tree_content_hash(back) == tree_content_hash(st)


def test_strict_keys_shapes_and_stale_tmp(tmp_path):
    st = _state()
    open(str(tmp_path / "s.npz.tmp"), "wb").write(b"torn")
    save_pytree(str(tmp_path / "s.npz"), st)
    assert not os.path.exists(str(tmp_path / "s.npz.tmp"))
    missing = st._replace(peft={**st.peft, "extra": {"x": torch.zeros(1)}})
    with pytest.raises(CheckpointError, match="missing"):
        load_pytree(str(tmp_path / "s.npz"), missing)
    fewer = st._replace(base={})
    with pytest.raises(CheckpointError, match="extra"):
        load_pytree(str(tmp_path / "s.npz"), fewer)
    wrong = st._replace(base={"emb": torch.zeros(8, 5, dtype=torch.bfloat16)})
    with pytest.raises(CheckpointError, match="shape"):
        load_pytree(str(tmp_path / "s.npz"), wrong)


def test_manifest_hash_gc_and_crash_window(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(7)
    rng.random(3)
    for r in (1, 2, 3):
        man = save_checkpoint(d, _state(seed=r), round_idx=r, algo_seed=11,
                              rng_state=rng.bit_generator.state,
                              history=[{"round": r, "loss": 0.5}],
                              extra={"bytes_up_total": 7})
    assert sorted(f for f in os.listdir(d) if f.startswith("state_")) == [
        "state_000002.npz", "state_000003.npz"]
    state, got = load_checkpoint(d, _state())
    assert _equal(state, _state(seed=3)) and got.round_idx == 3
    assert got.history == [{"round": 3, "loss": 0.5}]
    assert got.extra == {"bytes_up_total": 7} and got.content_hash == man.content_hash
    rng2 = np.random.default_rng(0)
    rng2.bit_generator.state = got.rng_state
    assert np.array_equal(rng.random(4), rng2.random(4))
    # a state file landed but its manifest did not: resume the previous one
    save_pytree(os.path.join(d, "state_000004.npz"), _state(seed=4))
    assert load_checkpoint(d, _state())[1].round_idx == 3
    # same keys and shapes, other values: only the content hash sees it
    save_pytree(os.path.join(d, man.state_file), _state(seed=9))
    with pytest.raises(CheckpointError, match="content hash"):
        load_checkpoint(d, _state())
    os.remove(os.path.join(d, man.state_file))
    with pytest.raises(CheckpointError, match="missing state"):
        load_checkpoint(d, _state())
    with pytest.raises(CheckpointError, match="no manifest"):
        read_manifest(str(tmp_path / "nowhere"))
    doc = json.loads(man.to_json())
    with pytest.raises(CheckpointError, match="schema"):
        RunManifest.from_json(json.dumps(dict(doc, schema="repro.checkpoint/v9")))
    with pytest.raises(CheckpointError, match="unknown manifest keys"):
        RunManifest.from_json(json.dumps(dict(doc, surprise=1)))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_state():
    jc = jcfgs.reduce_config(jcfgs.get_config("roberta-large-lora"))
    jbase = jax.jit(jtf.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jpeft = jax.jit(jinit_peft, static_argnums=(0, 2))(jc, jax.random.PRNGKey(1),
                                                        jcfgs.SpryConfig())
    st = jinit_state(jbase, jpeft)
    m = jax.tree.map(lambda x: x + 0.25, st.server.m)
    st = st._replace(round_idx=jnp.int32(3),
                     server=st.server._replace(count=jnp.int32(2), m=m))
    tc = reduce_config(get_config("roberta-large-lora"))
    tbase, tpeft = from_reference(tc, jax.tree.map(np.asarray, jbase),
                                  jax.tree.map(np.asarray, jpeft), "cpu")
    tst = init_state(tbase, tpeft)
    tst = tst._replace(round_idx=3, server=tst.server._replace(
        count=2, m=tree_map(lambda x: x + 0.25, tst.server.m)))
    gen = torch.Generator().manual_seed(5)     # a template with other values
    template = init_state(get_model(tc).init_base(tc, gen), init_peft(
        tc, gen, SpryConfig()))
    return st, tst, template


def test_reference_checkpoint_loads_in_port(tmp_path, reference_state):
    jst, tst, template = reference_state
    jman = jck.save_checkpoint(str(tmp_path), jst, round_idx=3, algo_seed=0)
    state, man = load_checkpoint(str(tmp_path), template)   # hash check inside
    assert man.content_hash == jman.content_hash
    assert _equal(state, tst)
    assert tree_content_hash(tst) == jck.tree_content_hash(jst)


def test_port_checkpoint_loads_in_reference(tmp_path, reference_state):
    jst, tst, _ = reference_state
    man = save_checkpoint(str(tmp_path), tst, round_idx=3, algo_seed=0)
    zeros = jax.tree.map(jnp.zeros_like, jst)
    state, jman = jck.load_checkpoint(str(tmp_path), zeros)
    assert jman.content_hash == man.content_hash == jck.tree_content_hash(jst)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(jst)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_reference_bf16_leaf_restores_bit_for_bit(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2 ** 16, (5, 7), dtype=np.uint16)
    bits[0, :4] = [0x7F80, 0xFF80, 0x0001, 0x8000]      # inf, -inf, subnormal, -0
    tree = {"a": bits.view(ml_dtypes.bfloat16), "b": np.arange(3, dtype=np.float32)}
    jck.save_pytree(str(tmp_path / "ref.npz"), tree)
    like = {"a": torch.zeros(5, 7, dtype=torch.bfloat16), "b": torch.zeros(3)}
    got = load_pytree(str(tmp_path / "ref.npz"), like)
    assert got["a"].dtype == torch.bfloat16
    assert np.array_equal(got["a"].view(torch.int16).numpy().view(np.uint16), bits)
    assert torch.equal(got["b"], torch.arange(3.0))
    assert tree_content_hash(got) == jck.tree_content_hash(tree)
    save_pytree(str(tmp_path / "port.npz"), got)         # the same file format
    with np.load(str(tmp_path / "ref.npz")) as r, \
            np.load(str(tmp_path / "port.npz")) as p:
        assert r["a"].dtype == p["a"].dtype and r["a"].tobytes() == p["a"].tobytes()


# ---------------------------------------------------------------------------
# CheckpointAdapterStore
# ---------------------------------------------------------------------------

def test_checkpoint_adapter_store_roundtrips_bf16(tmp_path):
    gen = torch.Generator().manual_seed(2)
    trees = [{"layers": {"wq": {"A": torch.randn(2, 8, 1, generator=gen).bfloat16(),
                                "B": torch.randn(2, 1, 8, generator=gen).bfloat16()}}}
             for _ in range(3)]
    template = tree_map(torch.zeros_like, trees[0])
    store = CheckpointAdapterStore(tmp_path / "adapters", template)
    for aid, t in enumerate(trees):
        store.save(aid, t)
    assert store.template() is template
    assert os.path.exists(store.path(2))
    for aid, t in enumerate(trees):
        assert _equal(store.load(aid), t)
    cache = AdapterCache(store, capacity=2)
    for aid in (0, 1, 2, 0):
        page = cache.acquire(aid)
        assert _equal(cache.page_tree(page), trees[aid])
    assert cache.stats()["evictions"] == 2


# ---------------------------------------------------------------------------
# kill and resume through run_training
# ---------------------------------------------------------------------------

_TIMING = ("t", "round_s", "round_peak_bytes")


def _history(h):
    return json.dumps([{k: v for k, v in e.items() if k not in _TIMING} for e in h],
                      sort_keys=True)


def kill_and_resume(tmp_path, **kw):
    """Run ``kw["rounds"]`` rounds straight and one fewer + (resume to
    all) into another checkpoint directory; returns (straight history,
    resumed history, the two final manifests)."""
    a, b = str(tmp_path / "straight"), str(tmp_path / "killed")
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    full = ttrain.run_training(checkpoint_dir=a, **kw)
    ttrain.run_training(checkpoint_dir=b, **dict(kw, rounds=kw["rounds"] - 1))
    resumed = ttrain.run_training(checkpoint_dir=b, resume=True, **kw)
    return full, resumed, read_manifest(a), read_manifest(b)


RUNTIME_KW = dict(rounds=2, clients_per_round=2, total_clients=8, batch_size=2,
                  k_perturbations=2, eval_every=1, runtime=True,
                  runtime_microbatch=2, over_select=1.5, dropout_rate=0.25,
                  wire_simulate=True, faults="mild", quorum=0.5, device="cpu",
                  log=lambda *a: None)


@pytest.mark.parametrize("method", ["spry", "spry_periter"])
def test_run_training_kill_and_resume_bitwise(tmp_path, method):
    full, resumed, ma, mb = kill_and_resume(tmp_path, method=method, **RUNTIME_KW)
    assert len(full) == len(resumed) == 2
    assert _history(full) == _history(resumed)
    assert ma.content_hash == mb.content_hash and ma.round_idx == mb.round_idx == 2
    assert full[-1]["cohort"] == 3 and full[-1]["health"] is not None


def test_in_process_kill_and_resume_bitwise(tmp_path):
    """The in-process path draws its clients and batches from the host rng
    every round: the manifest's rng state makes the resumed rounds equal."""
    kw = {k: v for k, v in RUNTIME_KW.items()
          if k in ("rounds", "clients_per_round", "total_clients", "batch_size",
                   "k_perturbations", "eval_every", "device", "log")}
    full, resumed, ma, mb = kill_and_resume(tmp_path, method="spry", **kw)
    assert _history(full) == _history(resumed) and len(full) == 2
    assert ma.content_hash == mb.content_hash and ma.rng_state is not None


def test_resume_refuses_other_seed_and_missing_dir(tmp_path):
    kw = dict(RUNTIME_KW, rounds=1, faults=None)
    ttrain.run_training(checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="seed"):
        ttrain.run_training(checkpoint_dir=str(tmp_path), resume=True,
                            **dict(kw, seed=1))
    with pytest.raises(ValueError, match="checkpoint-dir"):
        ttrain.run_training(resume=True, **kw)
