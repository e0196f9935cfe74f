"""Layer-to-client assignment (paper §3.1, Alg. 1 ``MapLayersToClients``).

Port of ``repro/core/assignment.py``. A *unit* is one LoRA (A,B) pair at
one depth for one target. Cyclic rule:

    for i in range(max(U, M)):  client (i+off) % M  <-  unit i % U

so every unit is trained each round; ``off`` rotates with the round. The
classifier head is assigned to every client.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class UnitIndex:
    units: Tuple[Tuple[str, str, int], ...]   # (group, target, layer); -1 unstacked
    spans: dict                                # (group, target) -> (start, length, stacked)

    @property
    def n_units(self) -> int:
        return len(self.units)


def enumerate_units(peft) -> UnitIndex:
    units: List[Tuple[str, str, int]] = []
    spans = {}
    for group in sorted(peft):
        if group == "head":
            continue
        for target in sorted(peft[group]):
            first = tree_leaves(peft[group][target])[0]
            # stacked groups carry a leading layer axis
            stacked = group in ("layers", "enc_layers") and first.ndim >= 2
            start = len(units)
            if stacked:
                L = first.shape[0]
                units.extend((group, target, i) for i in range(L))
                spans[(group, target)] = (start, L, True)
            else:
                units.append((group, target, -1))
                spans[(group, target)] = (start, 1, False)
    return UnitIndex(tuple(units), spans)


def assignment_matrix(n_units: int, n_clients: int, round_offset: int,
                      device=None):
    """(M, U) fp32 0/1 mask. With no units (a ``classifier_only`` tree:
    the head alone, which every client trains) it is the empty (M, 0) mask,
    as the reference's scatter into it drops every update."""
    U, M = n_units, n_clients
    mask = torch.zeros((M, U), dtype=torch.float32, device=device)
    if U == 0:
        return mask
    i = torch.arange(max(U, M), device=device)
    mask[(i + round_offset) % M, i % U] = 1.0
    return mask


def client_counts(mask_matrix):
    """M-tilde per unit: number of clients training each unit (>= 1)."""
    return torch.clamp(mask_matrix.sum(dim=0), min=1.0)


def build_mask_tree(peft, index: UnitIndex, mask_row):
    """Expand one client's (U,) assignment row into a peft-shaped mask
    tree; stacked leaves get (L, 1, 1) masks, the head a scalar 1."""
    out = {}
    for group in peft:
        if group == "head":
            out[group] = tree_map(
                lambda x: torch.ones((), dtype=torch.float32, device=x.device),
                peft[group])
            continue
        gout = {}
        for target in peft[group]:
            start, length, stacked = index.spans[(group, target)]
            seg = mask_row[start:start + length]

            def leaf_mask(leaf, seg=seg, stacked=stacked):
                if stacked:
                    return seg.reshape((length,) + (1,) * (leaf.ndim - 1))
                return seg.reshape(())
            gout[target] = tree_map(leaf_mask, peft[group][target])
        out[group] = gout
    return out
