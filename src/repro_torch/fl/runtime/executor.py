"""Cohort executors: run a per-client function over a round's cohort.

Port of ``repro/fl/runtime/executor.py``. A *client kernel* is any
``fn(base, peft, round_key, seed_id, mask_row, batch) -> (payload_tree,
aux)`` where ``payload_tree`` is a peft-shaped tree (the per-epoch delta,
or the server-side rebuilt gradient in per-iteration mode; None for the
jvp-only client pass) and ``aux`` is a small per-client tuple (loss, jvp
scalars) that is always stacked.

Clients run one after another in a Python loop, as ``core/spry``'s round
steps run them (the reference's vmap over the cohort has no counterpart).

  SerialExecutor    microbatch=None runs the whole cohort and returns the
                    per-client payloads as a list: the engine then
                    aggregates them with the in-process round step's own
                    ``aggregate_payloads`` (bit-identity). A finite
                    microbatch m walks C/m chunks in the reference's
                    summation order: within a chunk the keep-weighted sum
                    of that chunk's payloads, across chunks added into one
                    O(|peft|) fp32 carry. A chunk's payloads are dropped
                    once added, so peak aggregation memory is
                    (m + 1)·|peft|, independent of the cohort size.
  ShardedExecutor   the reference's ``shard_map`` over the host's TPU
                    devices has no one-GPU meaning; it raises.

``collect=True`` returns every client's payload (a list) in either mode —
used for wire simulation (pack real ClientUpdate messages) and tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


def _weighted(tree, w):
    """One client's payload tree scaled by its keep weight (0-d tensor)."""
    return tree_map(lambda x: x * w.to(x.dtype), tree)


def _row(batches, i):
    """Client ``i``'s slice of a cohort-stacked dict of tensors or tensor."""
    if isinstance(batches, dict):
        return {k: v[i] for k, v in batches.items()}
    return batches[i]


def _stack_aux(auxes):
    """Per-client aux tuples -> one tuple of (C, ...) stacks."""
    return tuple(torch.stack(list(xs)) for xs in zip(*auxes))


def _sum_weighted(payloads, keep):
    """Σ keep_i·payload_i over one chunk, as one stacked sum."""
    return tree_map(lambda *xs: torch.stack(xs).sum(0),
                    *[_weighted(p, keep[i]) for i, p in enumerate(payloads)])


class SerialExecutor:
    """Single-device cohort execution (whole cohort, or streamed in chunks
    of ``microbatch`` clients)."""

    def __init__(self, microbatch: Optional[int] = None):
        self.microbatch = microbatch

    @property
    def n_devices(self) -> int:
        return 1

    def pad_to(self, C: int) -> int:
        m = self.microbatch
        if m is None:
            return C
        return C + (-C) % m

    def run(self, client_fn, base, peft, round_key, seed_ids, mask_rows,
            batches, keep, *, collect: bool = False):
        """-> (payload, aux): ``payload`` the list of per-client trees when
        ``collect`` else the keep-weighted sum (None for a payload-free
        kernel); ``aux`` stacked (C, ...). ``seed_ids`` are ints,
        ``mask_rows`` and ``keep`` (C, ...) tensors on the model's device."""
        C = len(seed_ids)

        def one(i):
            return client_fn(base, peft, round_key, int(seed_ids[i]),
                             mask_rows[i], _row(batches, i))

        m = self.microbatch
        if m is None or m >= C:
            outs = [one(i) for i in range(C)]
            payloads, auxes = [o[0] for o in outs], [o[1] for o in outs]
            if collect or payloads[0] is None:
                return (payloads if collect else None), _stack_aux(auxes)
            return _sum_weighted(payloads, keep), _stack_aux(auxes)

        if C % m != 0:
            raise ValueError(f"cohort size {C} not divisible by microbatch {m} "
                             "(pad the cohort with keep=0 rows)")
        collected, auxes, carry = [], [], None
        for start in range(0, C, m):
            outs = [one(i) for i in range(start, start + m)]
            auxes.extend(o[1] for o in outs)
            payloads = [o[0] for o in outs]
            del outs
            if collect:
                collected.extend(payloads)
            elif payloads[0] is not None:
                if carry is None:
                    carry = tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                                     payloads[0])
                chunk = _sum_weighted(payloads, keep[start:start + m])
                carry = tree_map(torch.add, carry, chunk)
            del payloads
        return (collected if collect else carry), _stack_aux(auxes)


class ShardedExecutor:
    """The reference's ``shard_map`` executor splits the cohort over a
    host's TPU devices; one GPU has no such axis, so it is not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedExecutor is shard_map over the host's TPU devices and has "
            "no one-GPU meaning; use SerialExecutor(microbatch=m) for the "
            "streaming aggregation (a multi-GPU executor is a later slice)")


def pad_cohort(executor, seed_ids, mask_rows, batches, keep):
    """Pad cohort arrays to the executor's quantum with keep=0 rows (the pad
    rows still compute, on copies of the last row, but carry zero
    aggregation weight and are sliced off per-client outputs). ``batches``
    is a dict of tensors or arrays with a leading cohort axis."""
    C = len(seed_ids)
    Cp = executor.pad_to(C)
    if Cp == C:
        return seed_ids, mask_rows, batches, keep, C
    pad = Cp - C

    def padrow(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

    return (padrow(seed_ids), padrow(mask_rows),
            {k: padrow(v) for k, v in batches.items()},
            np.concatenate([np.asarray(keep), np.zeros(pad, keep.dtype)]), C)
