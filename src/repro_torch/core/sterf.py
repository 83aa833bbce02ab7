"""Eigenvalue-only QR/QL baseline (LAPACK xSTERF analogue): port of
``repro.core.sterf``.

Classic implicit-shift QL iteration on the (d, e) arrays only -- the
lowest-memory eigenvalue-only tridiagonal solver and the paper's primary
CPU baseline (Table 2).  The computation is one dependent chain: an outer
loop peels off converged eigenvalues, and each QL sweep is a rotation
chain over the active block.

On the card the iteration is the kernel ``csrc/sterf.cu`` (one warp per
problem); on the CPU it is :func:`sterf_plain`, a host loop over Python
floats that performs the kernel's operations in the kernel's order, each
rounded to the working type (for float32, a float64 operation rounded to
float32 is the correctly rounded float32 result).  The plain loop is for
the tests: it takes seconds at n = 256.

A rotation forms its radius r and 1 / r from one reciprocal square root
of f^2 + g^2 (r = (f^2 + g^2) / sqrt(f^2 + g^2), s = f / r, c = g / r as
products), where the kernel takes the hardware estimate plus Newton steps
and this loop ``1 / math.sqrt``: the two walk the same trajectory up to
rounding.  Where f^2 + g^2 leaves :data:`RSQRT_RANGE` (a square may
overflow, underflow or lose bits to subnormals) the rotation takes
``hypot`` and two divisions instead, the one path that can see r = 0
(premature deflation).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# The f^2 + g^2 for which a rotation takes one reciprocal square root
# (compiled into csrc/sterf.cu as RSQRT_LO / RSQRT_HI): far enough inside
# the normal range that both squares keep their bits wherever they matter
# and the root and its reciprocal stay normal.
RSQRT_RANGE = {torch.float64: (2.0 ** -960, 2.0 ** 960),
               torch.float32: (2.0 ** -120, 2.0 ** 120)}


def _ql_sweep(d, e, l, m, n, f, lo, hi):
    """One QL sweep on block [l, m] of the lists (d, e) (NR ``tqli``),
    rounding every operation with ``f``; f^2 + g^2 in [lo, hi] takes the
    reciprocal square root, the rest hypot.  Returns the rotations run."""
    d_l, d_l1, e_l = d[l], d[min(l + 1, n - 1)], e[l]
    g0 = f(f(d_l1 - d_l) / f(2.0 * (1.0 if e_l == 0.0 else e_l)))
    r0 = f(math.hypot(g0, 1.0))
    denom = f(g0 + (r0 if g0 >= 0.0 else -r0))
    g = f(f(d[m] - d_l) + f(e_l / (1.0 if denom == 0.0 else denom)))
    s, c, p = 1.0, 1.0, 0.0
    for i in range(m - 1, l - 1, -1):
        fi = f(s * e[i])
        b = f(c * e[i])
        ss = f(f(fi * fi) + f(g * g))
        if lo <= ss <= hi:
            ir = f(1.0 / math.sqrt(ss))
            r = f(ss * ir)
            e[i + 1] = r
            s = f(fi * ir)
            c = f(g * ir)
        else:
            r = f(math.hypot(fi, g))
            e[i + 1] = r
            if r == 0.0:
                # Premature deflation: the sweep stops here.
                d[i + 1] = f(d[i + 1] - p)
                e[m] = 0.0
                return m - i
            s = f(fi / r)
            c = f(g / r)
        gn = f(d[i + 1] - p)
        r2 = f(f(f(d[i] - gn) * s) + f(f(2.0 * c) * b))
        p = f(s * r2)
        d[i + 1] = f(gn + p)
        g = f(f(c * r2) - b)
    d[l] = f(d[l] - p)
    e[l] = g
    e[m] = 0.0
    return m - l


def _sterf_one(d, e, dtype):
    """QL on one problem; returns (eigenvalues unsorted, rotations)."""
    n = len(d)
    if dtype == torch.float32:
        def f(x):
            return float(np.float32(x))
    else:
        def f(x):
            return x
    d = [f(float(x)) for x in d]
    e = [f(float(x)) for x in e] + [0.0]    # e[n-1]: zero sentinel
    eps = float(torch.finfo(dtype).eps)
    lo, hi = RSQRT_RANGE[dtype]
    it, steps, l = 0, 0, 0
    while l < n and it < 30 * n:
        m = l
        while m < n - 1 and not (abs(e[m]) <= f(eps * f(abs(d[m])
                                                         + abs(d[m + 1])))):
            m += 1
        if m == l:
            l += 1
        else:
            steps += _ql_sweep(d, e, l, m, n, f, lo, hi)
        it += 1
    return d, steps


def sterf_plain(d, e):
    """All eigenvalues of each problem by implicit-shift QL, on the CPU.

    d: (B, n), e: (B, n-1) CPU tensors of one float dtype.  Returns
    (eigenvalues (B, n) ascending, rotations (B,) int64) -- the plain
    version of the card's ``kernels.sterf.sterf_cuda``.
    """
    B, n = d.shape
    rows, steps = [], []
    # float32 rounding of a square past float32's range is inf, as on the
    # card: the rotation then takes hypot.
    with np.errstate(over="ignore"):
        for b in range(B):
            lam, s = _sterf_one(d[b].tolist(), e[b].tolist(), d.dtype)
            rows.append(lam)
            steps.append(s)
    lam = torch.tensor(rows, dtype=d.dtype).reshape(B, n)
    return torch.sort(lam, dim=1).values, torch.tensor(steps,
                                                       dtype=torch.int64)


def eigvalsh_tridiagonal_sterf(d, e, *, dtype=None, device=None):
    """All eigenvalues of (d, e) via sequential implicit-shift QL.

    Runs on the CUDA card unless ``device="cpu"`` (the plain host loop,
    for small n).  Returns an (n,) tensor, ascending.
    """
    from repro_torch.core.tune import resolve_device
    from repro_torch.kernels import ops as _ops  # deferred: ops imports core
    dev = resolve_device(device)
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev)
    if dtype is not None:
        d = d.to(dtype)
        e = e.to(dtype)
    e = e.to(d.dtype)
    if d.shape[0] == 1:
        return d
    lam, _ = _ops.sterf_batched(d[None], e[None])
    return lam[0]
