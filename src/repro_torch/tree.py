"""Small helpers for nested parameter trees.

A tree is a dict, list or tuple whose values are trees or leaves
(tensors, arrays, numbers).  Dicts are walked in sorted key order, the
order in which the JAX package flattens its pytrees, so a leaf-by-leaf
reduction adds its terms in the same order in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tune import resolve_device


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf, in flattening order.  The structure
    is ``tree``'s (a dict keeps its own key order, which ``torch.func``
    takes as part of the structure); each of ``rest`` must have it as a
    prefix, and the subtree found where ``tree`` has a leaf is passed
    whole (as the JAX package's ``tree.map`` does)."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_stack(trees):
    """Stack the leaves of equally shaped trees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_from_numpy(tree, device=None):
    """A tree of arrays (numpy, or anything ``np.asarray`` takes, such as
    the JAX package's parameters and optimizer states) as a tree of
    tensors on ``device`` (None: the card, as every entry point), each
    keeping its dtype (a step count stays int32)."""
    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x)).to(dev)
    return tree_map(leaf, tree)
