"""int8 compression: port of ``repro.dist.compression``.

**Gradients across pods.**  Links between pods are an order of magnitude
slower than those inside one, so the cross-pod gradient reduction
exchanges int8-quantized tensors (1 B/elem on the wire plus one float32
scale per tensor) instead of raw float32.  The quantization residual is
*carried*, not dropped: each step adds the previous step's residual back
into the gradient before quantizing (error feedback), so the compression
bias stays bounded by one step's quantization error.  As in the JAX
package, the dequantized values are what the collective averages
(``all_reduce`` over the ``pod`` group, divided by its size) --
numerically the int8 payload and its scale sent through the collective.

**The solver's boundary rows.**  The compressed halo
(``compress_halo=True``) sends the sharded tree's boundary rows across
the subtree->cooperative all-gather as an int8 payload plus one float32
scale per (problem, slot) lane.  The transfer is one-shot, so there is
no residual to carry into a next step: the bias is one quantization step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map

_QMAX = 127.0
_F32 = torch.float32


class CompressionState(NamedTuple):
    error: Any   # tree matching the grads, float32 residual per tensor


def init_compression_state(grads) -> CompressionState:
    """Zero residual state shaped like the gradient tree (a ``DTensor``
    gradient keeps its placements)."""
    return CompressionState(tree_map(
        lambda g: torch.zeros_like(g, dtype=_F32), grads))


def _pod_mean(deq, group):
    """Mean of ``deq`` over the ranks of ``group`` (None: one rank, the
    identity).  A ``DTensor`` is averaged shard by shard: the pod group
    is not one of its mesh's axes, and each rank's local shard lines up
    with the same shard on every other pod."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return deq
    from repro_torch.dist.sharding import _is_dtensor
    local = deq.to_local() if _is_dtensor(deq) else deq
    total = local.clone()
    dist.all_reduce(total, group=group)
    mean = total / dist.get_world_size(group)
    if _is_dtensor(deq):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(mean, deq.device_mesh, deq.placements,
                                  shape=deq.shape, stride=deq.stride())
    return mean


def _compress_one(g, err, group):
    """One gradient leaf: stage ``g + err`` in float32, quantize it with
    a per-tensor scale floored at ``tiny`` (``torch.round`` half to even,
    clipped to +-127), average the dequantized payload over ``group``.
    Returns (mean in g's dtype, new residual g32 - deq)."""
    g32 = g.to(_F32) + err
    scale = torch.amax(torch.abs(g32)) / _QMAX
    scale = torch.clamp_min(scale, torch.finfo(_F32).tiny)
    q = torch.clamp(torch.round(g32 / scale), -_QMAX, _QMAX).to(torch.int8)
    deq = q.to(_F32) * scale
    mean = _pod_mean(deq, group)
    return mean.to(g.dtype), g32 - deq


def compressed_cross_pod_mean(grads, state: CompressionState, group):
    """Mean of ``grads`` over the ranks of the process ``group`` (the
    mesh's ``pod`` axis) via int8 + error feedback.

    Every rank of the group calls it with its own gradients, leaf for leaf
    in the same order.  Returns (mean_grads, new_state); ``mean +
    new_state.error`` gives back the local float32 gradient (plus the
    residual carried in)."""
    pairs = tree_map(lambda g, e: _compress_one(g, e, group), grads,
                     state.error)
    mean = tree_map(lambda _, p: p[0], grads, pairs)
    err = tree_map(lambda _, p: p[1], grads, pairs)
    return mean, CompressionState(err)


def quantize_lanes(x):
    """int8 quantization over the last axis, one float32 scale per
    leading-dims lane: ``(q int8, scale float32 (..., 1))``.

    Staged in float32 whatever ``x``'s dtype (an int8 payload carries
    under 8 bits, so a float32 scale over-represents it for float64 too),
    with a ``tiny`` floor on the scale; ``torch.round`` rounds half to
    even as ``jnp.round`` does, so the payload equals the JAX package's
    bit for bit."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / _QMAX
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_lanes(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_lanes` up to the quantization error, in
    the caller's ``dtype`` (a float32 tree stays float32)."""
    return (q.to(torch.float32) * scale).to(dtype)
