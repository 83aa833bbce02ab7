"""The plain reference that decides ``correct``: Sturm counts of the
benchmark's own inputs, in plain PyTorch.

The number of eigenvalues of T = tridiag(e, d, e) at or below a shift x
is the number of non-positive pivots of the LDL^T factorization of
T - xI (DSTEBZ's recurrence: a pivot within pivmin of zero becomes
-pivmin and counts).  The i-th eigenvalue (0-based, ascending) lies
within t of a returned value lam exactly when

    count(lam - t) <= i   and   count(lam + t) >= i + 1,

so counts at lam -+ t certify each returned eigenvalue against the
matrix itself, clusters included, without a second eigensolver.  The
counted matrix carries rounding of a few ulps in each entry, so the
certified error is good to a few eps * ||T||.

Everything here works on the (d, e) the benchmark made and on the
eigenvalues the program returned; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = float(np.finfo(np.float64).eps)
TINY = float(np.finfo(np.float64).tiny)

# Offsets t, in units of eps * max(1, ||T||_inf), at which a sampled
# eigenvalue is graded: steps of sqrt(2) up to 2^12, then of 4 up to 2^40.
GRID = tuple([2.0 ** (k / 2) for k in range(-2, 25)]
             + [2.0 ** k for k in range(14, 41, 2)])
# A graded eigenvalue that no offset certifies reads this.
BEYOND = 2.0 ** 41


def tinf(d: np.ndarray, e: np.ndarray) -> np.ndarray:
    """||T||_inf of each problem: d (P, n), e (P, n - 1) -> (P,)."""
    row = np.abs(d).copy()
    row[:, :-1] += np.abs(e)
    row[:, 1:] += np.abs(e)
    return row.max(axis=1)


def sturm_counts(d: torch.Tensor, e: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Eigenvalues at or below each shift: d (P, n), e (P, n - 1) and
    shifts x (P, S), float64 on one device -> (P, S) int32."""
    e2 = e * e
    pivmin = TINY * torch.clamp(e2.amax(dim=1, keepdim=True), min=1.0)
    neg = -pivmin
    q = d[:, :1] - x
    q = torch.where(q.abs() < pivmin, neg, q)
    count = (q <= 0).to(torch.int32)
    for j in range(1, d.shape[1]):
        q = (d[:, j:j + 1] - x) - e2[:, j - 1:j] / q
        q = torch.where(q.abs() < pivmin, neg, q)
        count += q <= 0
    return count


def certify(d: np.ndarray, e: np.ndarray, lam: np.ndarray,
            index: np.ndarray, graded: np.ndarray, limit: float,
            device) -> dict:
    """Judge returned eigenvalues against their matrices.

    d (P, n), e (P, n - 1): the problems; lam (P, k): what the program
    returned, lam[p, j] for the index[p, j]-th eigenvalue (0-based,
    ascending) of problem p;
    graded (P, g): positions in [0, k) whose error is read on the GRID.
    Every returned value is also held to ``limit`` (in eps * max(1,
    ||T||_inf)).  Returns {"err_eps": the largest graded error, "missed":
    returned values not within the limit of their eigenvalue, "checked":
    values held to the limit, "graded": values graded}.
    """
    P, k = lam.shape
    u = EPS * np.maximum(1.0, tinf(d, e))                         # (P,)
    grid = np.asarray(GRID)
    lam_g = np.take_along_axis(lam, graded, axis=1)               # (P, g)
    g = graded.shape[1]
    offsets = np.concatenate([np.full((P, k), limit),
                              np.repeat(grid[None], P * g, 0).reshape(
                                  P, g * len(grid))], axis=1) * u[:, None]
    centers = np.concatenate([lam, np.repeat(lam_g, len(grid), axis=1)],
                             axis=1)
    x = np.concatenate([centers - offsets, centers + offsets], axis=1)
    finite = np.isfinite(x)
    dev = torch.device(device)
    counts = sturm_counts(torch.as_tensor(d, device=dev),
                          torch.as_tensor(e, device=dev),
                          torch.as_tensor(np.where(finite, x, 0.0),
                                          device=dev)).cpu().numpy()
    half = x.shape[1] // 2
    below, above = counts[:, :half], counts[:, half:]
    ok = finite[:, :half] & finite[:, half:]
    index = np.concatenate([index, np.repeat(
        np.take_along_axis(index, graded, axis=1), len(grid), axis=1)],
        axis=1)
    ok &= (below <= index) & (above >= index + 1)
    missed = int((~ok[:, :k]).sum())
    cert = ok[:, k:].reshape(P, g, len(grid))
    # The smallest certifying offset of each graded value: certification
    # at t implies it at every larger t, so the first True is the least.
    first_ok = np.where(cert.any(axis=2), cert.argmax(axis=2), len(grid))
    read = np.append(grid, BEYOND)[first_ok]
    return {"err_eps": float(read.max()) if read.size else 0.0,
            "missed": missed, "checked": int(P * k), "graded": int(P * g)}


def graded_positions(k: int, count: int, rng: np.random.Generator):
    """``count`` positions of [0, k) to grade, drawn by ``rng``, always
    with both ends; all of them when count >= k."""
    if count >= k:
        return np.arange(k)
    inner = rng.choice(np.arange(1, k - 1), size=count - 2, replace=False)
    return np.sort(np.concatenate([[0, k - 1], inner]))


def limit_reading(value: float) -> str:
    """A graded reading as printed: the number, or that it lies beyond
    the grid."""
    return ("%.6g" % value if value < BEYOND
            else "> 2^%d" % int(math.log2(GRID[-1])))
