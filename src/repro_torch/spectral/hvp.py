"""Curvature-operator matvecs over a parameter tree (port of
``repro.spectral.hvp``), on ``torch.func``.

make_hvp:  v -> H v   (Hessian of the loss wrt params: jvp of grad; exact,
                       one extra forward and backward per matvec)
make_gnvp: v -> G v   (Gauss-Newton: J^T H_out J v through the loss head;
                       positive semi-definite)

``params`` and ``v`` are trees of tensors (``repro_torch.tree``); both
matvecs are pure functions of ``v``, so ``torch.func.vmap`` batches them
over probes (``lanczos_tridiag_batch``).
"""

from __future__ import annotations

from typing import Callable

import torch


def make_hvp(loss_of_params: Callable, params) -> Callable:
    grad_fn = torch.func.grad(loss_of_params)

    def hvp(v):
        return torch.func.jvp(grad_fn, (params,), (v,))[1]

    return hvp


def make_gnvp(logits_of_params: Callable, loss_of_logits: Callable,
              params) -> Callable:
    """Gauss-Newton vector product: J^T H_out J v."""
    grad_out = torch.func.grad(loss_of_logits)

    def gnvp(v):
        logits, jv = torch.func.jvp(logits_of_params, (params,), (v,))
        h_out = torch.func.grad(
            lambda lg: torch.sum(grad_out(lg) * jv))(logits)
        _, vjp_fn = torch.func.vjp(logits_of_params, params)
        return vjp_fn(h_out)[0]

    return gnvp
