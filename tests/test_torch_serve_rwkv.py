"""The port's rwkv6 (ssm) serving against the JAX package, on reduced rwkv6
(fp32) with the reference's weights and synthetic adapters carried over
(``convert.from_reference`` / ``peft_from_reference``):

- ``init_cache`` shapes and dtypes equal the reference's; ``prefill``
  (P=12) logits and every cache leaf (``wkv``, ``shift_tm``, ``shift_cm``)
  at rel 1e-5, then ``decode_step`` from the reference's own prefill cache
  with a scalar and a per-row ``pos``, at rel 1e-5;
- the fused prefill equals ``tokenwise_prefill`` (logits and cache at rel
  1e-5, and the same greedy ids);
- greedy ids, and the ``ServingEngine``'s ids, adapter cache stats and
  decode steps (5 requests over 3 adapters, max_batch 2, capacity 2: rows
  admitted mid-flight, a page evicted) equal the reference's, and the
  engine's ids equal per-request greedy;
- every cache leaf carries batch on axis 1, as ``serving._scatter_row``
  assumes;
- ``forward_scanned`` equals ``forward`` within the reference's own
  tolerance (rtol = atol = 2e-5) and the reference's ``forward_scanned`` at
  rel 1e-5.

The reference runs are computed once (the ``ref`` fixture, shared helpers
of ``test_torch_serve``).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch import adapter_cache as jac
from repro.models import rwkv_model as jrwkv
from repro_torch import configs as tcfgs
from repro_torch.convert import from_reference
from repro_torch.models import rwkv_model as trwkv

from test_torch_serve import (
    _np_tree,
    check_engine,
    check_forward_scanned,
    check_fused_prefill,
    check_greedy,
    check_prefill_and_decode,
    check_scatter_axis,
    serve_reference,
)

torch.set_num_threads(1)
ARCH = "rwkv6-1.6b"
P, NEW = 12, 5


@pytest.fixture(scope="module")
def ref():
    jc = jcfgs.reduce_config(jcfgs.get_config(ARCH))
    tc = tcfgs.reduce_config(tcfgs.get_config(ARCH))
    jbase = jax.jit(jrwkv.init_base, static_argnums=0)(jc, jax.random.PRNGKey(0))
    jstore = jac.SyntheticAdapterStore(jc, seed=0)
    jstore.load = jax.jit(jstore.load)   # compiled once, not op by op
    jpeft = jstore.load(5)
    tbase, tpeft = from_reference(tc, _np_tree(jbase), _np_tree(jpeft), "cpu")
    prompt = np.random.default_rng(0).integers(0, jc.vocab, (2, P)).astype(np.int32)
    r = dict(jc=jc, tc=tc, jbase=jbase, jpeft=jpeft, tbase=tbase, tpeft=tpeft,
             jstore=jstore, prompt=prompt)
    r.update(serve_reference(jc, jbase, jpeft, jstore, prompt, NEW))
    return r


@pytest.mark.parametrize("case", ["scalar", "per_row"])
def test_prefill_and_decode_match_reference(ref, case):
    check_prefill_and_decode(ref, case)


def test_fused_prefill_equals_token_loop(ref):
    check_fused_prefill(ref, P)


def test_greedy_ids_equal_reference(ref):
    check_greedy(ref)


def test_engine_ids_equal_reference_and_greedy(ref):
    check_engine(ref)


def test_cache_leaves_carry_batch_on_axis_1(ref):
    check_scatter_axis(ref, ("wkv", "shift_tm", "shift_cm"))


def test_forward_scanned_matches_forward_and_reference(ref):
    check_forward_scanned(ref, trwkv, jrwkv)
