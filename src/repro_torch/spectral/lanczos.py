"""Lanczos tridiagonalization of tree-valued linear operators (port of
``repro.spectral.lanczos``).

m Lanczos steps against a curvature operator reduce it to a symmetric
tridiagonal (alpha, beta): the input the boundary-row D&C solver takes.
Vectors are trees of tensors (``repro_torch.tree``) in float32; dot
products sum each leaf in float32 and add the leaves in flattening order.
Full reorthogonalization is on by default (m is small: 2m tree dots a
step).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def _dot(a, b):
    return sum(torch.sum(x.to(torch.float32) * y.to(torch.float32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _axpy(alpha, x, y):
    return tree_map(lambda xi, yi: alpha * xi.to(torch.float32)
                    + yi.to(torch.float32), x, y)


def _scale(alpha, x):
    return tree_map(lambda xi: alpha * xi.to(torch.float32), x)


def lanczos_tridiag(matvec: Callable, probe, num_steps: int, *,
                    full_reorth: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``num_steps`` Lanczos iterations from ``probe`` (a tree).

    Returns (alpha (m,), beta (m-1,)) of the Krylov tridiagonal, float32
    on the probe's device.  A Python loop: m is small and each step is a
    whole operator application.
    """
    nrm = torch.sqrt(_dot(probe, probe))
    v = _scale(1.0 / nrm, probe)
    v_prev = tree_map(torch.zeros_like, v)
    basis = [v] if full_reorth else None
    device = tree_leaves(probe)[0].device

    alphas, betas = [], []
    beta = torch.zeros((), dtype=torch.float32, device=device)
    for step in range(num_steps):
        w = matvec(v)
        alpha = _dot(w, v)
        w = _axpy(-alpha, v, w)
        w = _axpy(-beta, v_prev, w)
        if full_reorth:
            for u in basis:
                w = _axpy(-_dot(w, u), u, w)
        beta = torch.sqrt(torch.clamp(_dot(w, w), min=0.0))
        alphas.append(alpha)
        if step < num_steps - 1:
            betas.append(beta)
            v_prev = v
            v = _scale(1.0 / torch.clamp(beta, min=1e-30), w)
            if full_reorth:
                basis.append(v)
    return torch.stack(alphas), (
        torch.stack(betas) if betas
        else torch.zeros((0,), dtype=torch.float32, device=device))


def lanczos_tridiag_batch(matvec: Callable, probes, num_steps: int, *,
                          full_reorth: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Lanczos: every probe advances together, one batched
    operator application a step.

    ``probes`` is a tree whose leaves carry a leading probe axis (P, ...);
    ``matvec`` runs under ``torch.func.vmap`` over that axis, so it must
    be made of torch operations (``make_hvp`` and ``make_gnvp`` are).
    Returns (alpha (P, m), beta (P, m-1)) on the probes' device: the
    (B, n) / (B, n-1) layout the batched eigensolver takes, with no host
    round trip in between.
    """
    return torch.func.vmap(
        lambda p: lanczos_tridiag(matvec, p, num_steps,
                                  full_reorth=full_reorth))(probes)
