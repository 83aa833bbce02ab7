"""Stochastic Lanczos quadrature on the port's batched boundary-row
solver (port of ``repro.spectral.slq``).

The Gauss quadrature rule of a Lanczos tridiagonal T_m needs the
eigenvalues of T_m and the squared first components of its eigenvectors.
That first-component vector is blo(Q), the paper's boundary-row state, so
the BR solve gives the rule natively: values and one boundary row, O(m)
memory a probe.

The probe set runs as one pipeline: batched Lanczos (one batched matvec a
step, ``torch.func.vmap``) feeding one batched solve in float64 on the
probes' device, then one host transfer of nodes and weights.  With
``client=`` (a :class:`repro_torch.serve.EigensolverClient`) the solve is
one ``kind="slq"`` (or ``"edges"``) service request instead, which
coalesces with other traffic of its bucket and returns the direct path's
bits.

Random probes come from a ``torch.Generator`` (the JAX package takes a
PRNG key): Rademacher signs, drawn leaf by leaf in flattening order on
the generator's device.

    est = slq_spectrum(hvp, params, gen, num_probes=4, num_steps=64)
    lr_scale = governor.update(est.lam_max)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bisect import eigvalsh_tridiagonal_range
from repro_torch.core.br_dc import eigvalsh_tridiagonal_batch
from repro_torch.core.tune import resolve_device
from repro_torch.spectral.lanczos import lanczos_tridiag_batch
from repro_torch.tree import tree_leaves, tree_map, tree_stack


@dataclasses.dataclass
class SpectralEstimate:
    nodes: np.ndarray       # (probes, m) Ritz values (quadrature nodes)
    weights: np.ndarray     # (probes, m) Gauss weights = blo(Q_T)^2
    lam_max: float
    lam_min: float
    trace_est: float        # dim * mean_k sum_i w_i lam_i

    def density(self, grid, sigma=None):
        """Smoothed spectral density on ``grid`` (Gaussian kernel), one
        broadcast (grid, probes * m) evaluation."""
        lo, hi = float(np.min(self.nodes)), float(np.max(self.nodes))
        sigma = sigma or max((hi - lo) / 100.0, 1e-12)
        grid = np.asarray(grid, np.float64)
        lam = np.asarray(self.nodes, np.float64).reshape(-1)
        w = np.asarray(self.weights, np.float64).reshape(-1)
        dens = np.sum(
            w[None, :] * np.exp(-0.5 * ((grid[:, None] - lam[None, :])
                                        / sigma) ** 2),
            axis=1)
        dens /= (self.nodes.shape[0] * np.sqrt(2 * np.pi) * sigma)
        return dens


def _rademacher_like(generator: torch.Generator, tree):
    """A tree of float32 +-1 signs shaped like ``tree``, each leaf on its
    own leaf's device."""
    def draw(x):
        bits = torch.randint(0, 2, tuple(x.shape), generator=generator,
                             device=generator.device)
        return (bits.to(torch.float32) * 2 - 1).to(x.device)
    return tree_map(draw, tree)


def _probes(generator, params_like, num_probes: int):
    return tree_stack([_rademacher_like(generator, params_like)
                       for _ in range(num_probes)])


def _solve_input(x, device=None) -> torch.Tensor:
    """A Krylov tridiagonal's stacked diagonal or off-diagonal as a
    float64 tensor: tensors stay on their device, anything else goes to
    ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.array(x, dtype=np.float64),
                           device=resolve_device(device))


def _estimate(alpha, beta, dim: int, *, leaf: int = 8, client=None,
              device=None) -> SpectralEstimate:
    """The SLQ estimate of stacked (P, m) Krylov tridiagonals: one batched
    float64 BR solve with boundary rows (or one ``kind="slq"`` request
    through ``client``); nodes are its eigenvalues, weights its first
    boundary row squared."""
    alpha = _solve_input(alpha, device)
    beta = _solve_input(beta, alpha.device)
    if client is not None:
        from repro_torch.core.request import SolveRequest
        res = client.submit(SolveRequest(
            d=alpha, e=beta, kind="slq", knobs={"leaf": leaf},
            device=alpha.device)).result()
    else:
        res = eigvalsh_tridiagonal_batch(alpha, beta, leaf=leaf,
                                         return_boundary=True,
                                         device=alpha.device)
    nodes = res.eigenvalues.cpu().numpy()
    weights = res.blo.cpu().numpy() ** 2         # Gauss weights
    trace = dim * float(np.mean(np.sum(weights * nodes, axis=1)))
    return SpectralEstimate(
        nodes=nodes, weights=weights,
        lam_max=float(np.max(nodes)), lam_min=float(np.min(nodes)),
        trace_est=trace)


def slq_spectrum(matvec: Callable, params_like, generator, *,
                 num_probes: int = 4, num_steps: int = 32, leaf: int = 8,
                 client=None) -> SpectralEstimate:
    """Estimate the operator's spectrum by SLQ, with the batched BR solve
    as the tridiagonal eigensolver (values + boundary rows -> nodes +
    weights).

    ``params_like`` is a tree of tensors shaped like the operator's input
    (its device is where Lanczos and the solve run); ``generator`` draws
    the Rademacher probes.  All ``num_probes`` Krylov tridiagonals are
    solved in one batched float64 solve.  ``client`` submits that solve
    as one ``kind="slq"`` service request: bit for bit the direct result.
    """
    dim = sum(x.numel() for x in tree_leaves(params_like))
    alpha, beta = lanczos_tridiag_batch(
        matvec, _probes(generator, params_like, num_probes), num_steps)
    return _estimate(alpha, beta, dim, leaf=leaf, client=client)


def edges_from_tridiag(alpha, beta, *, k: int = 1, client=None,
                       device=None):
    """k smallest and k largest eigenvalues of stacked (B, m)
    tridiagonals, as numpy (lo, hi) of shape (B, k), ascending along k.

    Tensors solve on their own device, anything else on ``device`` (None:
    the card), in float64.  ``client`` submits one ``kind="edges"``
    request: both windows of all B problems in one launch, bit for bit
    the two direct range solves.
    """
    alpha = _solve_input(alpha, device)
    beta = _solve_input(beta, alpha.device)
    m = alpha.shape[1]
    k = min(k, m)
    if client is not None:
        from repro_torch.core.request import SolveRequest
        res = client.submit(SolveRequest(
            d=alpha, e=beta, kind="edges", knobs={"k": k},
            device=alpha.device)).result()
        lam = res.eigenvalues.cpu().numpy()      # (2B, k): [bottom; top]
        B = lam.shape[0] // 2
        return lam[:B], lam[B:]
    lo = eigvalsh_tridiagonal_range(alpha, beta, select="i", il=0,
                                    iu=k - 1, device=alpha.device)
    hi = eigvalsh_tridiagonal_range(alpha, beta, select="i", il=m - k,
                                    iu=m - 1, device=alpha.device)
    return lo.cpu().numpy(), hi.cpu().numpy()


def spectral_edges(matvec: Callable, params_like, generator, *,
                   num_probes: int = 1, num_steps: int = 16, k: int = 1,
                   client=None):
    """k smallest and k largest Ritz values per probe by spectrum
    slicing: 2k eigenvalues of each Krylov tridiagonal by Sturm bisection
    (no boundary rows, no merge tree).  Returns numpy (lo, hi) of shape
    (num_probes, k), ascending along k; ``client`` as in
    :func:`edges_from_tridiag`."""
    alpha, beta = lanczos_tridiag_batch(
        matvec, _probes(generator, params_like, num_probes), num_steps)
    return edges_from_tridiag(alpha, beta, k=k, client=client)


def sharpness(matvec: Callable, params_like, generator, *,
              num_steps: int = 16, client=None) -> float:
    """A cheap lam_max estimate: one probe, a small m, and a one-
    eigenvalue sliced solve of its Krylov tridiagonal.  ``client``
    submits the solve as a ``kind="edges"`` request (the direct bits)."""
    _, hi = spectral_edges(matvec, params_like, generator, num_probes=1,
                           num_steps=num_steps, k=1, client=client)
    return float(np.max(hi))
