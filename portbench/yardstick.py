"""The benchmark's yardstick: peak rates, operation and byte counts of the
conquer kernels and the Sturm counts, and the roofline bound built on them.

Frozen copies of ``chip_smoke.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``,
``_secular_ops``, ``_postpass_ops``, ``_zhat_ops``, ``_boundary_ops``,
``_sturm_ops``, ``_sturm_bytes``, ``_tree_bytes`` and ``_bound_ms``),
taking the sum of kprime^2 over a level's nodes instead of a kprime
array.  They live here so that a change to the program cannot change
what its kernels are measured against.  ``NITER`` fixes the secular
iteration count of the count at 16, the float64 default of the port
when these counts were frozen: the yardstick reads the same work
whatever implements it.
"""

from __future__ import annotations

# Peak rates of one NVIDIA H100 SXM (data sheet, full 700 W limit): FP64
# outside the tensor cores and FP32, and HBM bandwidth.
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Secular iterations a root is counted with.
NITER = 16

# Rows of R an eigenvalue-only solve carries through the tree (blo, bhi).
ROWS = 2


def secular_ops(pairs: float, niter: int = NITER) -> float:
    """Operations of the root solve per (root, pole) pair: 1 (weight sum)
    + 3 (f(mid)) + 5 + 5 (the two model sweeps) + 6 per iteration + 4
    (final g); a division counts as one operation.  ``pairs`` is the sum
    of kprime^2 over the nodes."""
    return pairs * (18 + 6 * niter)


def postpass_ops(pairs: float, r: int) -> float:
    """The post-pass: pass A (5 per pair) + pass B (5 + 2r per pair)."""
    return pairs * (10 + 2 * r)


def zhat_ops(pairs: float) -> float:
    """The ratio product of zhat: three subtractions, one division and
    one multiplication per (active pole, active root) pair."""
    return pairs * 5


def boundary_ops(pairs: float, r: int) -> tuple[float, float]:
    """The row update per (active pole, active root) pair: the difference
    (2), one division, r multiply-adds (2r) and the norm's (2).  Returns
    (FMA operations of the product, the rest)."""
    return pairs * 2 * r, pairs * 5


def sturm_ops(B: int, n: int, S: int, newton: bool) -> float:
    """Operations of one count sweep: two subtractions and one division
    per (problem, shift, row); the derivative adds a multiply, an add, a
    division and the sum's add."""
    return float(B) * S * n * (7 if newton else 3)


def sturm_bytes(B: int, n: int, S: int, newton: bool,
                itemsize: int = 8) -> int:
    """Each input read once (d, e2, shifts, pivmin), each output written
    once (int32 counts, plus the derivative sums)."""
    return (B * (2 * n - 1 + S + 1) * itemsize + B * S * 4
            + (B * S * itemsize if newton else 0))


def tree_bytes(B: int, n: int, k: int, itemsize: int = 8) -> int:
    """m halvings' inputs read once (d, e2, pivmin, tol, int32 targets,
    lo, hi) and outputs written once (lo, hi)."""
    return B * (2 * n + 1) * itemsize + B * k * (4 + 4 * itemsize)


def resident_bytes(nodes: int, K: int, r: int = ROWS,
                   itemsize: int = 8) -> int:
    """A merge level that solves its roots and updates r rows, as the
    resident kernel's table row counts it: d, z, R in, rows, tau, origin
    out, and the per-node scalars."""
    return ((2 * r + 6) * itemsize + 4) * nodes * K + 12 * nodes


def postpass_bytes(nodes: int, K: int, r: int = ROWS,
                   itemsize: int = 8) -> int:
    """The post-pass alone, as its table row counts it."""
    return ((2 * r + 4) * itemsize + 4) * nodes * K + 12 * nodes


def secular_bytes(nodes: int, K: int, itemsize: int = 8) -> int:
    """A root-only level, as the secular kernel's table row counts it."""
    return (2 * itemsize + 4 + itemsize) * nodes * K + 12 * nodes


def bound_s(flops: float, nbytes: float, dtype: str = "float64") -> float:
    """The least seconds the card could take: operations over the peak
    rate or bytes over the peak bandwidth, whichever is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def conquer_level_bound_s(kprime_sum: float, nodes: int, K: int,
                          root: bool, r: int = ROWS) -> float:
    """Bound of one merge level of the conquer kernels (kernel table rows
    1-3): every node's roots, and its r rows unless the level is the
    root.  The deflation gauge keeps the level's sum of kprime, so the
    sum of kprime^2 is taken as (sum kprime)^2 / nodes, its least value
    (Cauchy-Schwarz): the bound can only read low."""
    pairs = kprime_sum * kprime_sum / nodes
    if root:
        return bound_s(secular_ops(pairs), secular_bytes(nodes, K))
    return bound_s(secular_ops(pairs) + postpass_ops(pairs, r),
                   resident_bytes(nodes, K, r))
