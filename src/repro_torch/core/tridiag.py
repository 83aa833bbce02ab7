"""Symmetric tridiagonal matrix utilities and the paper's test families.

NumPy copy of ``repro.core.tridiag`` (the port imports nothing of the
JAX package).  The four spectral families follow the paper's Section 5.1:

  uniform:   d ~ U[-1, 1],   e ~ U[0.10, 0.30]
  normal:    d ~ N(0, 1),    e ~ U[0.10, 0.30]
  toeplitz:  d = 2,          e = 0.25
  clustered: d = 1 + 1e-12*(i - (n+1)/2),  e = 1e-4*(1 + 0.1*cos(0.33*i))

One difference from the JAX package: the default seed of a family is
keyed on a *stable* hash of its name (``zlib.crc32``), not on Python's
per-process ``hash``, so a default-seeded matrix is the same in every
process.  Parity tests pass explicit seeds to both packages.
"""

from __future__ import annotations

import zlib

import numpy as np


def dense_from_tridiag(d, e):
    """Materialize the dense symmetric matrix (test/oracle use only)."""
    d = np.asarray(d)
    e = np.asarray(e)
    n = d.shape[0]
    A = np.zeros((n, n), d.dtype)
    A[np.arange(n), np.arange(n)] = d
    if n > 1:
        i = np.arange(n - 1)
        A[i, i + 1] = e
        A[i + 1, i] = e
    return A


def gershgorin_bounds(d, e):
    """(lo, hi) enclosing all eigenvalues."""
    d = np.asarray(d)
    e = np.asarray(e)
    n = d.shape[0]
    if n == 1:
        return d[0], d[0]
    radius = np.zeros(n, d.dtype)
    radius[:-1] += np.abs(e)
    radius[1:] += np.abs(e)
    return np.min(d - radius), np.max(d + radius)


def _seed_for(family: str, n: int) -> int:
    return (zlib.crc32(family.encode()) ^ (n * 0x9E3779B9)) & 0x7FFFFFFF


def make_family(family: str, n: int, dtype=np.float64, seed: int | None = None):
    """Generate (d, e) for one of the paper's test families (numpy arrays)."""
    if seed is None:
        seed = _seed_for(family, n)
    rng = np.random.default_rng(seed)
    i = np.arange(1, n + 1, dtype=np.float64)
    if family == "uniform":
        d = rng.uniform(-1.0, 1.0, n)
        e = rng.uniform(0.10, 0.30, n - 1)
    elif family == "normal":
        d = rng.standard_normal(n)
        e = rng.uniform(0.10, 0.30, n - 1)
    elif family == "toeplitz":
        d = np.full(n, 2.0)
        e = np.full(n - 1, 0.25)
    elif family == "clustered":
        d = 1.0 + 1e-12 * (i - (n + 1) / 2.0)
        e = 1e-4 * (1.0 + 0.1 * np.cos(0.33 * i[:-1]))
    elif family == "wilkinson":
        # W_n^+ : classic near-degenerate stress matrix (extra coverage).
        m = (n - 1) / 2.0
        d = np.abs(i - 1 - m)
        e = np.ones(n - 1)
    elif family == "glued_wilkinson":
        # Copies of a small W^+ block glued with weak couplings (1e-4):
        # the canonical deflation-heavy D&C stress input -- nearly every
        # merge deflates almost everything.  Not in FAMILIES.
        blk = min(21, n)
        blk -= (blk % 2 == 0)           # odd Wilkinson block size
        ib = np.arange(1, blk + 1, dtype=np.float64)
        db = np.abs(ib - 1 - (blk - 1) / 2.0)
        d = np.tile(db, n // blk + 1)[:n]
        e = np.ones(n - 1)
        e[blk - 1::blk] = 1e-4          # glue strength
    else:
        raise ValueError(f"unknown family: {family}")
    return d.astype(dtype), e.astype(dtype)


def make_family_batch(family: str, n: int, batch: int, dtype=np.float64,
                      seed0: int = 0):
    """Stacked (B, n)/(B, n-1) batch of one family, seeds seed0..seed0+B-1."""
    problems = [make_family(family, n, dtype=dtype, seed=seed0 + s)
                for s in range(batch)]
    return (np.stack([d for d, _ in problems]),
            np.stack([e for _, e in problems]))


FAMILIES = ("uniform", "normal", "toeplitz", "clustered", "wilkinson")
