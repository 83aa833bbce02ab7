"""Step functions of the trainer and the serving driver (port of
``repro.launch.steps``).

Factories close over (cfg, optimizer) and return plain functions:

  train_step(params, opt_state, batch, lr_scale)
                                      -> (params, opt_state, metrics)
  serve_prefill(params, tokens[, frames]) -> (logits, caches)
  serve_step(params, caches, tokens, pos) -> (logits, caches)

The train step takes its gradient with ``torch.autograd.grad`` over the
parameter leaves (``remat`` runs the layer bodies under
``torch.utils.checkpoint``, which ``torch.func`` transforms may not
compose with), clips by the global norm in float32 and applies the
functional optimizer with no autograd graph.  Metrics are 0-d tensors on
the parameters' device: reading one is the step's only host sync.

On a mesh the same step takes ``DTensor`` parameters, optimizer state and
batch (``dist.sharding.distribute_tree``): every rank runs it, DTensor's
sharding propagation inserts the collectives, each gradient is
redistributed to its parameter's placements (the FSDP reduce-scatter),
and plain tensors met on the way (positions, masks, the step count's
scalars) count as replicated (``implicit_replication``).  Metrics come
back as plain replicated 0-d tensors.
``make_train_step_compressed`` is the JAX package's int8 cross-pod step:
the loss and backward run on each pod's own slice of the batch, the
gradients cross the pods as int8 with error feedback.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.dist.sharding import _is_dtensor, set_manual_axes
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

_F32 = torch.float32


def _mesh_context(params):
    """``implicit_replication()`` where the parameters are ``DTensor``s,
    else nothing."""
    if any(_is_dtensor(p) for p in tree_leaves(params)):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _plain(x):
    """A metric as a plain tensor (a ``DTensor``'s whole value)."""
    return x.full_tensor() if _is_dtensor(x) else x


def loss_and_grads(loss_fn, params):
    """(loss, aux metrics, grads) of ``loss_fn(live)`` at ``params``; a
    ``DTensor`` leaf's gradient comes back with the leaf's placements."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live)
    leaves = tree_leaves(live)
    flat = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(flat), live)
    grads = tree_map(
        lambda g, p: (g.redistribute(p.device_mesh, p.placements)
                      if _is_dtensor(g) and g.placements != p.placements
                      else g), grads, live)
    return loss, metrics, grads


def clip_and_apply(optimizer, params, grads, opt_state, lr_scale,
                   grad_clip):
    """Global-norm clip in float32 and the optimizer, with no autograd
    graph.  Returns (params, opt_state, grad norm)."""
    with torch.no_grad():
        gnorm = _global_norm(grads)
        if grad_clip is not None:
            scale = torch.clamp(
                grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            grads = tree_map(
                lambda g: (g.to(_F32) * scale).to(g.dtype), grads)
        new_params, new_opt = optimizer.apply(params, grads, opt_state,
                                              lr_scale=lr_scale)
    return new_params, new_opt, gnorm


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves'
    terms added in flattening order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                          for g in tree_leaves(grads)))


def make_train_step(cfg: ModelConfig, optimizer, *, remat: bool = True,
                    grad_clip: Optional[float] = 1.0):
    def train_step(params, opt_state, batch, lr_scale=1.0):
        with _mesh_context(params):
            loss, metrics, grads = loss_and_grads(
                lambda p: tf.loss_fn(p, cfg, batch, remat=remat), params)
            new_params, new_opt, gnorm = clip_and_apply(
                optimizer, params, grads, opt_state, lr_scale, grad_clip)
        out_metrics = {"loss": _plain(loss.detach().to(_F32)),
                       "ce": _plain(metrics["ce"].detach().to(_F32)),
                       "grad_norm": _plain(gnorm),
                       "lr_scale": torch.as_tensor(lr_scale, dtype=_F32)}
        return new_params, new_opt, out_metrics

    return train_step


def _pod_view(x, inner):
    """A full-mesh ``DTensor`` whose mesh dim 0 is ``pod`` as the
    ``DTensor`` of this rank's pod on the ``inner`` (data, model) mesh:
    the same local shard, the pod placement dropped (a batch sharded over
    pod becomes that pod's slice)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x.placements[0], (Replicate, Shard)):
        raise ValueError(f"pod placement {x.placements[0]} has no pod-local "
                         f"view")
    return DTensor.from_local(x.to_local(), inner, list(x.placements[1:]),
                              run_check=False)


def _lift(x, mesh):
    """A pod-replicated value on the inner mesh back on the full mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x.to_local(), mesh,
                              [Replicate()] + list(x.placements),
                              shape=x.shape, stride=x.stride())


def _pod_mean_scalar(x, group):
    """The mean over the pod group of a replicated 0-d metric."""
    import torch.distributed as dist

    total = _plain(x).detach().to(_F32).clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group)


def make_train_step_compressed(cfg: ModelConfig, optimizer, mesh, *,
                               remat: bool = True,
                               grad_clip: Optional[float] = 1.0):
    """Training step with int8 error-feedback gradient compression on the
    cross-pod axis (``dist/compression.py``).

    ``mesh`` is a (pod, data, model) ``DeviceMesh``; parameters and
    optimizer state are replicated over ``pod`` (the rules never shard
    over it) and the batch is sharded over it.  Each rank runs the loss
    and backward on its pod's slice of the batch, as ``DTensor``s of the
    (data, model) mesh inside its pod (the JAX package's ``shard_map``
    over 'pod' alone, with 'pod' Manual): each pod reduces its gradient
    inside the pod in float32, then the pods exchange int8-quantized
    gradients with an error-feedback residual that each rank carries
    (``err_state``, a tree of float32 ``DTensor``s of the inner mesh:
    ``init_compression_state`` of a gradient tree).  Loss and ce are
    averaged over the pods, then the clip and the optimizer run as in
    :func:`make_train_step`.  Returns (params, opt_state, metrics,
    err_state)."""
    from repro_torch.dist.compression import (CompressionState,
                                              compressed_cross_pod_mean)
    names = tuple(mesh.mesh_dim_names)
    if names[0] != "pod":
        raise ValueError(f"the compressed step needs a mesh whose first "
                         f"axis is 'pod', got {names}")
    inner = mesh[names[1:]]
    pod_group = mesh.get_group("pod")

    def train_step(params, opt_state, batch, err_state, lr_scale=1.0):
        local_p = tree_map(lambda p: _pod_view(p, inner), params)
        local_b = {k: _pod_view(v, inner) for k, v in batch.items()}
        set_manual_axes({"pod"})
        try:
            with _mesh_context(params):
                loss, metrics, grads = loss_and_grads(
                    lambda p: tf.loss_fn(p, cfg, local_b, remat=remat),
                    local_p)
        finally:
            set_manual_axes(set())
        with torch.no_grad(), _mesh_context(params):
            grads, new_state = compressed_cross_pod_mean(
                grads, CompressionState(err_state), pod_group)
            grads = tree_map(lambda g: _lift(g, mesh), grads)
        loss = _pod_mean_scalar(loss, pod_group)
        ce = _pod_mean_scalar(metrics["ce"], pod_group)
        with _mesh_context(params):
            new_params, new_opt, gnorm = clip_and_apply(
                optimizer, params, grads, opt_state, lr_scale, grad_clip)
        out_metrics = {"loss": loss, "ce": ce, "grad_norm": _plain(gnorm),
                       "lr_scale": torch.as_tensor(lr_scale, dtype=_F32)}
        return new_params, new_opt, out_metrics, new_state.error

    return train_step


def make_serve_prefill(cfg: ModelConfig, max_seq: int):
    def serve_prefill(params, tokens, frames=None):
        with _mesh_context(params):
            return tf.prefill(params, cfg, tokens, max_seq,
                              encoder_input=frames)
    return serve_prefill


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, pos):
        with _mesh_context(params):
            return tf.decode_step(params, cfg, tokens, caches, pos)
    return serve_step
