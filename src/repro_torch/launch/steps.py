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
the parameters' device: reading one is the step's only host sync.  The
JAX package's ``make_train_step_compressed`` (int8 cross-pod gradients)
is multi-device: ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

_F32 = torch.float32


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves'
    terms added in flattening order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                          for g in tree_leaves(grads)))


def make_train_step(cfg: ModelConfig, optimizer, *, remat: bool = True,
                    grad_clip: Optional[float] = 1.0):
    def train_step(params, opt_state, batch, lr_scale=1.0):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = tf.loss_fn(live, cfg, batch, remat=remat)
        leaves = tree_leaves(live)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(flat), live)

        with torch.no_grad():
            gnorm = _global_norm(grads)
            if grad_clip is not None:
                scale = torch.clamp(
                    grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                grads = tree_map(
                    lambda g: (g.to(_F32) * scale).to(g.dtype), grads)
            new_params, new_opt = optimizer.apply(params, grads, opt_state,
                                                  lr_scale=lr_scale)
        out_metrics = {"loss": loss.detach().to(_F32),
                       "ce": metrics["ce"].detach().to(_F32),
                       "grad_norm": gnorm,
                       "lr_scale": torch.as_tensor(lr_scale, dtype=_F32)}
        return new_params, new_opt, out_metrics

    return train_step


def make_serve_prefill(cfg: ModelConfig, max_seq: int):
    def serve_prefill(params, tokens, frames=None):
        return tf.prefill(params, cfg, tokens, max_seq, encoder_input=frames)
    return serve_prefill


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, pos):
        return tf.decode_step(params, cfg, tokens, caches, pos)
    return serve_step
