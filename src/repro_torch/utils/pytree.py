"""Helpers over nested dicts of tensors (the port's pytrees).

Port of ``repro/utils/pytree.py``. Trees are nested ``dict``s whose leaves
are tensors (or scalars); leaves are visited in sorted-key order, the order
``jax.tree`` uses for dicts, so leaf-ordered operations (perturbation
draws, flattening) are the same in both packages.
"""
from __future__ import annotations

import torch


def tree_leaves(tree):
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves):
    """Rebuild ``tree``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}     # keep the template's key order
        return next(it)
    return build(tree)


def tree_dot(a, b):
    """Inner product over the whole tree in fp32, leaves summed in leaf
    order (0.0 for an empty tree)."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        s = torch.sum(x.float() * y.float())
        total = s if total is None else total + s
    return torch.zeros(()) if total is None else total


def tree_norm(tree):
    return torch.sqrt(tree_dot(tree, tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)
