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


def is_bfloat16(a: np.ndarray) -> bool:
    """Whether a numpy array holds bfloat16: ``ml_dtypes``' bfloat16 (the
    dtype of a JAX bfloat16 array), or the two-byte void dtype that
    ``np.load`` gives such an array's file where ``ml_dtypes`` is not
    installed."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def leaf_from_numpy(x, device) -> torch.Tensor:
    """One array as a tensor on ``device``, keeping its dtype; bfloat16
    bytes are reinterpreted (int16, then a bfloat16 view), bit for bit."""
    a = np.array(x)
    if is_bfloat16(a):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree, device=None):
    """A tree of arrays (numpy, or anything ``np.asarray`` takes, such as
    the JAX package's parameters and optimizer states) as a tree of
    tensors on ``device`` (None: the card, as every entry point), each
    keeping its dtype (a step count stays int32, bfloat16 stays
    bfloat16)."""
    dev = resolve_device(device)
    return tree_map(lambda x: leaf_from_numpy(x, dev), tree)
