"""Carry the JAX package's model parameters into the port.

    params = params_from_numpy(jax.tree.map(np.asarray, repro_params), "cpu")

The port keeps ``repro``'s parameter tree (same nested keys, layers
stacked on a leading axis, weights in the same logical shapes), so the
conversion is leaf by leaf with no transpose: each array becomes a
tensor of its own dtype.  A bfloat16 leaf (``ml_dtypes``' bfloat16 from
a JAX array, or the two-byte void dtype ``np.load`` gives one without
``ml_dtypes``) keeps its bits through an int16 view.
"""

from __future__ import annotations

from repro_torch.tree import tree_from_numpy


def params_from_numpy(tree, device=None):
    """``tree`` (numpy leaves, or anything ``np.asarray`` takes) as the
    port's parameter tree on ``device`` (None: the card): the same
    structure, shapes and dtypes, the same bits."""
    return tree_from_numpy(tree, device)
