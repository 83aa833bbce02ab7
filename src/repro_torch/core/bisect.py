"""Partial-spectrum slicing: Sturm-count bisection + safeguarded Newton
(port of ``repro.core.bisect``).

  * ``sturm_count_plain`` -- #{eigenvalues <= shift} via the LAPACK DSTEBZ
    pivot recurrence (negcount of LDL^T) over (B, S) shift tensors: the
    plain version of the ``csrc/sturm_count.cu`` kernel.
    ``kernels.ops.sturm_count_batched`` runs it on CPU tensors and the
    kernel on CUDA tensors; ``_count_and_newton`` is the same sweep plus
    its derivative sum (``ops.count_and_newton_batched``).
  * ``_slice_targets`` -- all requested roots bisect their brackets at
    once, then a short safeguarded Newton polish.  JAX's
    ``lax.while_loop`` is a host loop here that checks convergence every
    ``_CHECK_EVERY`` halvings.  Each launch takes m halvings of every
    bracket (``bisect_tree_plain``, the ``sturm_bisect_tree`` kernel on
    the card): the whole depth-m bisection tree is counted at once and
    walked with the loop's own rule, so the result is the loop's bit for
    bit, whatever m; m comes from ``tune.bisect_depth`` (1 on the CPU).
  * ``eigvalsh_tridiagonal_range`` -- select-by-index / select-by-value,
    through the request core and ``plan.RangePlan``.
  * ``certify_spectrum`` / ``refine_clusters`` -- the robustness layer's
    certifier (one sorted 2N-shift count sweep) and the mixed-precision
    pipeline's f64 stage (polish only the uncertified lanes, with the
    live set compacted between launches).

Every public function runs on the CUDA card unless the caller passes
``device="cpu"``; the internal executors run where their tensors lie.
Memory: O(B * (n + k)); work O(B * k * n) per sweep.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import guard as _guard
from repro_torch.core.instrument import SolveCounter
from repro_torch.core.tune import (backend_defaults, bisect_depth,
                                   resolve_device)

# Bisection halvings cap.  The loop exits as soon as every bracket is
# below its tolerance (~53 + log2(spread/scale) halvings at float64); the
# cap only bounds the trip count for adversarial inputs.
DEFAULT_MAX_BISECT = 96

# Safeguarded Newton polish steps after bisection: quadratic convergence
# from inside an isolated bracket pins the root to ~eps * ||T|| even when
# bisection stopped a few ulps short; each step also tightens the bracket
# through its own Sturm count, so the polish never leaves it.
DEFAULT_POLISH = 2

# Certification tolerance of the mixed-precision pipeline, in units of
# eps_f64 * max(1, ||T||_inf): a quarter of the 64-eps conformance bar.
DEFAULT_REFINE_TOL = 16.0

# Certify -> refine rounds cap.  Soundness comes from re-certifying after
# each refine pass (the refine loop's freeze criterion is a heuristic);
# measured trajectories collapse after one pass, 4 bounds adversarial
# spectra.
DEFAULT_REFINE_ROUNDS = 4

# Refine trips per launch before the host loop compacts the live set.
_REFINE_TRIPS = 4

# Refine launches per certify round: 24 * 4 trips = 96 bracket halvings
# in the pure-bisection worst case, the budget of DEFAULT_MAX_BISECT.
_REFINE_MAX_LAUNCHES = 24

# Bisection halvings between two convergence checks of the host loop
# (rounded up to whole launches of the tree's depth).  Each check is one
# host sync; converged brackets freeze, so the halvings run after the
# last bracket converged change nothing, and a check every halving gives
# bit-identical results (tests/test_torch_bisect.py).
_CHECK_EVERY = 8

# One build per (executor, batch, lane width, dtype, device) shape of the
# certify / refine executors -- the analogue of the JAX package's trace
# counter; surfaced through plan.plan_cache_stats(), reset by
# plan.clear_plan_cache().
REFINE_EXECUTOR_TRACES = SolveCounter("refine_executor_traces")
_BUILT: set = set()
_BUILT_LOCK = threading.Lock()


def _note_build(*shape) -> None:
    with _BUILT_LOCK:
        if shape in _BUILT:
            return
        _BUILT.add(shape)
    REFINE_EXECUTOR_TRACES.increment()


def reset_refine_builds() -> None:
    """Forget the executor shapes seen and zero REFINE_EXECUTOR_TRACES."""
    with _BUILT_LOCK:
        _BUILT.clear()
    REFINE_EXECUTOR_TRACES.reset()


def _pivot_floor(e2):
    """DSTEBZ-style pivot floor ``safmin * max(1, max e2)``, shape
    (..., 1), in e2's dtype: a pivot within it of zero is replaced by
    ``-pivmin`` (counted as negative: LAPACK's "eigenvalues <= shift")."""
    safmin = torch.finfo(e2.dtype).tiny
    emax = (e2.amax(dim=-1, keepdim=True) if e2.shape[-1]
            else torch.zeros(e2.shape[:-1] + (1,), dtype=e2.dtype,
                             device=e2.device))
    return safmin * emax.clamp(min=1.0)


def sturm_count_plain(d, e2, shifts, pivmin):
    """Batched Sturm counts: #{eigenvalues of problem b <= shifts[b, s]}.

    d: (B, n); e2: (B, n-1); shifts: (B, S); pivmin: (B, 1).  A loop over
    the n rows carrying all B x S pivot lanes (the plain version of the
    ``sturm_count`` kernel; port of ``sturm_count_xla``).  Returns (B, S)
    int32.
    """
    neg = -pivmin
    q = d[:, :1] - shifts
    q = torch.where(q.abs() < pivmin, neg, q)
    cnt = (q <= 0.0).to(torch.int32)
    for i in range(1, d.shape[1]):
        q = (d[:, i:i + 1] - shifts) - e2[:, i - 1:i] / q
        q = torch.where(q.abs() < pivmin, neg, q)
        cnt += q <= 0.0
    return cnt


def _count_and_newton(d, e2, x, pivmin):
    """One pivot sweep returning (count, s) at each shift.

    Same recurrence as :func:`sturm_count_plain` plus its derivative:
    with q_i the pivots of T - xI, r_i = q_i'/q_i accumulates
    s = d/dx log|det(T - xI)| = -sum_k 1/(lam_k - x), so the Newton step
    for the nearest eigenvalue is ``x - 1/s``.  The plain version of the
    ``sturm_count_newton`` kernel: each operation rounds on its own (no
    fused multiply-add), which the kernel reproduces bit for bit.
    """
    neg = -pivmin
    q = d[:, :1] - x
    q = torch.where(q.abs() < pivmin, neg, q)
    cnt = (q <= 0.0).to(torch.int32)
    r = -1.0 / q                                      # q_1' = -1
    s = r
    for i in range(1, d.shape[1]):
        u = e2[:, i - 1:i] / q                        # e2 / q_{i-1}
        qn = (d[:, i:i + 1] - x) - u
        qn = torch.where(qn.abs() < pivmin, neg, qn)
        dq = -1.0 + u * r                             # q_i' via r_{i-1}
        r = dq / qn
        cnt += qn <= 0.0
        s = s + r
        q = qn
    return cnt, s


def bisect_tree_plain(d, e2, pivmin, tol, targets, lo, hi, *, depth: int,
                      steps: int):
    """``steps`` <= ``depth`` halvings of every bisection bracket in one
    sweep: the plain version of the ``sturm_bisect_tree`` kernel.

    d: (B, n); e2: (B, n-1); pivmin, tol: (B, 1); targets: (B, k) int32;
    lo, hi: (B, k).  The 2^depth - 1 midpoints of each bracket's
    bisection tree (heap order: node i's children are 2i + 1 and 2i + 2,
    each the ``0.5 * (a + b)`` of its interval, as the loop forms it) are
    counted in ONE :func:`sturm_count_plain` sweep; then each bracket
    walks ``steps`` levels down with the host loop's rule (live =
    (hi - lo) > tol; above = count(mid) > target; hi = mid where above and
    live, lo = mid where not above and live).  Every midpoint on a
    bracket's path is the one the loop would form, so the result equals
    ``steps`` trips of the loop bit for bit.  Returns (lo, hi, counts
    (B, k, 2^depth - 1) int32).
    """
    B, k = targets.shape
    a, b = lo[..., None], hi[..., None]
    mids = []
    for _ in range(depth):                 # one level of the tree a pass
        mid = 0.5 * (a + b)
        mids.append(mid)
        a = torch.stack([a, mid], dim=-1).reshape(B, k, -1)
        b = torch.stack([mid, b], dim=-1).reshape(B, k, -1)
    shifts = torch.cat(mids, dim=-1)                      # (B, k, nodes)
    counts = sturm_count_plain(d, e2, shifts.reshape(B, -1), pivmin
                               ).reshape(shifts.shape)
    node = torch.zeros((B, k, 1), dtype=torch.int64, device=d.device)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        above = torch.gather(counts, 2, node)[..., 0] > targets
        live = (hi - lo) > tol
        hi = torch.where(above & live, mid, hi)
        lo = torch.where(~above & live, mid, lo)
        node = 2 * node + 1 + (~above)[..., None].to(torch.int64)
    return lo, hi, counts


def _gershgorin(d, e_abs, pivmin):
    """Per-problem Gershgorin enclosure (glo, ghi), each (B, 1), widened
    by one pivot floor so count(glo) <= j < count(ghi) holds."""
    radius = torch.zeros_like(d)
    if e_abs.shape[1]:
        radius[:, :-1] += e_abs
        radius[:, 1:] += e_abs
    glo = (d - radius).amin(dim=1, keepdim=True) - pivmin
    ghi = (d + radius).amax(dim=1, keepdim=True) + pivmin
    return glo, ghi


def _slice_targets(d, e, targets, *, maxiter: int = DEFAULT_MAX_BISECT,
                   polish: int = DEFAULT_POLISH):
    """Eigenvalues lam[targets[b]] of each problem b.

    d: (B, n); e: (B, n-1); targets: (B, k) int32 ascending indices in
    [0, n), all on one device.  Every B x k bracket starts at its
    problem's Gershgorin bounds; each halving counts the k midpoints and
    halves each live bracket on its own count, until the widest bracket
    converges or ``maxiter`` halvings ran.  Converged brackets freeze, so
    a root's value does not depend on how long the others iterate.  One
    launch takes ``tune.bisect_depth`` halvings for the device and B * k
    (the bisection tree: the same bits as one halving a launch).  A
    safeguarded Newton polish follows.  Returns (B, k) eigenvalues.
    """
    from repro_torch.kernels import ops as _ops  # deferred: ops imports us
    dtype = d.dtype
    e2 = e * e
    pivmin = _pivot_floor(e2)                         # (B, 1)
    glo, ghi = _gershgorin(d, e.abs(), pivmin)
    scale = torch.maximum(glo.abs(), ghi.abs())       # ~ ||T||
    tol = (2.0 * torch.finfo(dtype).eps
           * scale.clamp(min=torch.finfo(dtype).tiny) + 2.0 * pivmin)

    B, k = targets.shape
    depth = bisect_depth(B * k, backend_defaults(
        d.device.type)["bisect_chains"])
    lo = glo.expand(B, k)
    hi = ghi.expand(B, k)
    it = 0
    while it < maxiter and bool(((hi - lo) > tol).any()):
        for _ in range(-(-_CHECK_EVERY // depth)):
            if it == maxiter:
                break
            steps = min(depth, maxiter - it)
            lo, hi, _ = _ops.bisect_tree_batched(d, e2, pivmin, tol, targets,
                                                 lo, hi, depth=depth,
                                                 steps=steps)
            it += steps
    x = 0.5 * (lo + hi)

    for _ in range(polish):
        cnt, s = _ops.count_and_newton_batched(d, e2, x, pivmin)
        above = cnt > targets
        hi = torch.where(above, x, hi)
        lo = torch.where(above, lo, x)
        cand = x - 1.0 / s
        inb = torch.isfinite(cand) & (cand > lo) & (cand < hi)
        x = torch.where(inb, cand, 0.5 * (lo + hi))
    return x


def sturm_count(d, e, shifts, *, device=None):
    """#{eigenvalues of the tridiagonal (d, e) <= shift}, any shift shape.

    Single-problem convenience over the batched count (DSTEBZ negcount
    convention).  d: (n,); e: (n-1,); shifts: any shape.  Returns int32
    of ``shifts.shape`` on ``device`` (default: the CUDA card).
    Malformed input raises :class:`repro_torch.core.guard.InvalidInputError`.
    """
    from repro_torch.kernels import ops as _ops  # deferred: ops imports us
    if np.ndim(d) != 1:
        raise _guard.InvalidInputError(
            f"sturm_count: d must be 1-D (n,), got shape {tuple(np.shape(d))}"
            f" (use the plan/request layer for batched problems)",
            field="d")
    _guard.validate_problem(d, e, name="sturm_count")
    dev = resolve_device(device)
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev).to(d.dtype)
    shifts = torch.as_tensor(shifts, dtype=d.dtype, device=dev)
    e2 = (e * e)[None]
    cnt = _ops.sturm_count_batched(d[None], e2, shifts.reshape(1, -1),
                                   _pivot_floor(e2))
    return cnt.reshape(shifts.shape)


class SpectrumCertificate(NamedTuple):
    """Result of :func:`certify_spectrum`.

    certified: (n,) or (B, n) bool -- True where the true j-th eigenvalue
        provably lies within ``tol`` of ``lam[..., j]``.
    lo / hi: tightest count-verified enclosure the sweep observed for
        each eigenvalue (always valid, certified or not).
    tol: (1,) or (B, 1) absolute tolerance the certificate used.
    """
    certified: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    tol: torch.Tensor

    @property
    def all_certified(self) -> bool:
        return bool(self.certified.all())


def certify_spectrum(d, e, lam, *, tol: float = DEFAULT_REFINE_TOL,
                     nvalid=None, device=None):
    """Certify approximate eigenvalues with ONE batched Sturm count sweep.

    For each ``lam[..., j]`` the sweep verifies, by exact integer Sturm
    counts against the original ``(d, e)``, whether the true j-th
    eigenvalue lies in ``(lam_j - tol_abs, lam_j + tol_abs]`` with
    ``tol_abs = tol * eps * max(1, ||T||_inf)`` in the input dtype.

    Args:
      d: (n,) or (B, n) diagonals.  e: (n-1,) or (B, n-1).
      lam: approximate eigenvalues, ascending, same leading shape as d.
      tol: tolerance in ``eps * max(1, ||T||_inf)`` units.
      nvalid: optional (B,) real-lane counts for rows carrying decoupled
        sentinel padding; padded lanes certify vacuously.
      device: where the sweep runs (default: the CUDA card).

    Returns:
      :class:`SpectrumCertificate` of tensors on ``device``; shapes
      follow the input (1-D in, 1-D out).
    """
    _guard.validate_problem(d, e, name="certify_spectrum")
    single = np.ndim(d) == 1
    dev = resolve_device(device)
    d = torch.atleast_2d(torch.as_tensor(d, device=dev))
    e = torch.atleast_2d(torch.as_tensor(e, device=dev)).to(d.dtype)
    lam = torch.atleast_2d(torch.as_tensor(lam, device=dev)).to(d.dtype)
    if lam.shape != d.shape:
        raise _guard.InvalidInputError(
            f"certify_spectrum: lam must match d's shape {tuple(d.shape)} "
            f"(one estimate per eigenvalue), got {tuple(lam.shape)}",
            field="lam")
    B, n = d.shape
    nvalid_arr = (torch.full((B,), n, dtype=torch.int32, device=dev)
                  if nvalid is None else torch.atleast_1d(torch.as_tensor(
                      nvalid, dtype=torch.int32, device=dev)))
    if float(tol) <= 0.0:
        raise _guard.InvalidInputError(
            f"certify_spectrum: tol must be positive, got {tol}",
            field="tol")
    cert, lo, hi, tol_abs = _certify_executor(d, e * e, lam, nvalid_arr,
                                              float(tol))
    if single:
        cert, lo, hi, tol_abs = cert[0], lo[0], hi[0], tol_abs[0]
    return SpectrumCertificate(cert, lo, hi, tol_abs)


# ---------------------------------------------------------------------------
# Mixed-precision refinement: f64 Sturm certification + targeted polish
# ---------------------------------------------------------------------------


def _certify_executor(d, e2, lam, nvalid, tol_factor: float):
    """Certify all approximate eigenvalues with ONE count sweep.

    d: (B, N); e2: (B, N-1); lam: (B, N) (rows may carry decoupled
    sentinel padding at index >= nvalid[b]); nvalid: (B,) int32.  The 2N
    shifts ``lam_j -+ tol`` run as one sweep; target j is certified iff
    ``count(lam_j - tol) <= j`` and ``count(lam_j + tol) >= j + 1``.
    Sorting the (shift, count) pairs makes the counts monotone, so each
    target also gets the TIGHTEST verified bracket the sweep observed.
    Returns (cert (B, N) bool, lo (B, N), hi (B, N), tol (B, 1)).
    """
    from repro_torch.kernels import ops as _ops  # deferred: ops imports us
    B, N = d.shape
    dtype = d.dtype
    _note_build("certify", B, N, dtype, str(d.device))
    pivmin = _pivot_floor(e2)
    j = torch.arange(N, dtype=torch.int32, device=d.device)[None, :]
    valid = j < nvalid[:, None]

    # Scale masked to real rows: padded sentinel diagonals sit above the
    # real Gershgorin bound and would inflate the tolerance; sentinel
    # couplings are exactly zero, so e2 needs no mask.
    e_abs = torch.sqrt(e2)
    dmax = torch.where(valid, d.abs(), torch.zeros((), dtype=dtype,
                                                   device=d.device)
                       ).amax(dim=1, keepdim=True)
    emax = (e_abs.amax(dim=1, keepdim=True) if e2.shape[1]
            else torch.zeros((B, 1), dtype=dtype, device=d.device))
    tol = (tol_factor * torch.finfo(dtype).eps
           * (dmax + 2.0 * emax).clamp(min=1.0))

    shifts = torch.cat([lam - tol, lam + tol], dim=1)          # (B, 2N)
    cnt = _ops.sturm_count_batched(d, e2, shifts, pivmin)       # (B, 2N)
    cert = ((cnt[:, :N] <= j) & (cnt[:, N:] >= j + 1)) | ~valid

    # Counts are monotone along the sorted shifts: the largest evaluated
    # shift with count <= j is a verified lower bound of lam_j, the
    # smallest with count >= j+1 a verified upper bound.
    ss, order = torch.sort(shifts, dim=1, stable=True)
    cs = torch.gather(cnt, 1, order)
    jj = j.expand(B, N).contiguous()
    ilo = torch.searchsorted(cs, jj, right=True) - 1
    ihi = torch.searchsorted(cs, jj + 1)
    # Gershgorin fallback at the sweep's extremes (padded rows only widen
    # the enclosure, so the unmasked bound stays sound).
    glo, ghi = _gershgorin(d, e_abs, pivmin)
    lo = torch.where(ilo >= 0, torch.gather(ss, 1, ilo.clamp(min=0)), glo)
    hi = torch.where(ihi < 2 * N,
                     torch.gather(ss, 1, ihi.clamp(max=2 * N - 1)), ghi)
    return cert, lo, hi, tol


def _refine_executor(d, e2, x, lo, hi, xp, gp, tgt, live, tol, *,
                     maxiter: int):
    """Bracket-guarded f64 polish of the compacted live lanes.

    d: (B, n); e2: (B, n-1); x, lo, hi: (B, k) iterates and
    count-verified brackets; xp, gp: previous (iterate, g) pair seeding
    the secant slope (xp == x: no history, the first trip falls back to
    Newton); tgt: (B, k) int32 targets; live: (B, k) bool; tol: (B, 1).

    Each trip runs ONE count + derivative sweep over all lanes.  With
    g = 1/s the secant step ``x - g (x - xp) / (g - gp)`` measures the
    true slope near close pairs (plain Newton ``x - g`` crawls there);
    candidates are accepted only when finite, strictly inside the
    count-updated bracket, and (secant) on a slope above 0.05, falling
    back to Newton then to the midpoint.  Convergence freezes a lane's
    whole state.  A host loop of at most ``maxiter`` trips.  Returns
    (x, lo, hi, xp, gp, live, iterations).
    """
    from repro_torch.kernels import ops as _ops  # deferred: ops imports us
    _note_build("refine", *x.shape, d.dtype, str(d.device))
    pivmin = _pivot_floor(e2)
    tolf = 0.5 * tol     # freeze at half the certification tolerance
    its = torch.zeros((), dtype=torch.int64, device=d.device)
    it = 0
    while it < maxiter and bool(live.any()):
        cnt, s = _ops.count_and_newton_batched(d, e2, x, pivmin)
        above = cnt > tgt                  # count(x) >= j+1: lam_j <= x
        nhi = torch.where(above & live, x, hi)
        nlo = torch.where(~above & live, x, lo)
        g = 1.0 / s
        cand_n = x - g
        slope = (g - gp) / (x - xp)
        cand_s = x - g / slope
        ok_s = (torch.isfinite(cand_s) & (cand_s > nlo) & (cand_s < nhi)
                & (slope > 0.05))
        ok_n = torch.isfinite(cand_n) & (cand_n > nlo) & (cand_n < nhi)
        nx = torch.where(ok_s, cand_s,
                         torch.where(ok_n, cand_n, 0.5 * (nlo + nhi)))
        conv = (nhi - nlo <= tolf) | ((nx - x).abs() <= 0.25 * tolf)
        xp = torch.where(live, x, xp)
        gp = torch.where(live, g, gp)
        x = torch.where(live, nx, x)
        its = its + live.sum()
        lo, hi, live = nlo, nhi, live & ~conv
        it += 1
    return x, lo, hi, xp, gp, live, int(its)


def _bucket(k: int) -> int:
    """Next power of two (min 1): lane-count buckets keep the refine
    executor's shapes logarithmic in n."""
    return 1 << max(0, (int(k) - 1).bit_length())


def _refine_misses(d, e2, lamh, loh, hih, tol_dev, miss):
    """Host-driven refinement of the miss set with live-lane compaction.

    d, e2: (B, n)/(B, n-1) tensors; lamh, loh, hih: HOST (B, n) float64
    state arrays (refined lanes are scattered back in place); tol_dev:
    (B, 1) tensor; miss: host (B, n) bool.  Every ``_REFINE_TRIPS``
    trips the still-live lanes are compacted to each problem's live set
    (padded to the batch max, bucketed to a power of two) and relaunched,
    with the secant history carried across.  Freeze-per-bracket makes
    each lane's trajectory independent of the compaction schedule.
    Returns the total polish iterations.
    """
    B, n = miss.shape
    dev = d.device
    xph = lamh.copy()      # xp == x: no secant history yet
    gph = np.zeros_like(lamh)
    idxs = [np.nonzero(miss[b])[0] for b in range(B)]
    iters = 0
    for _ in range(_REFINE_MAX_LAUNCHES):
        kmax = max(len(ix) for ix in idxs)
        if kmax == 0:
            break
        k = min(_bucket(kmax), n)
        gidx = np.zeros((B, k), np.int64)
        live = np.zeros((B, k), bool)
        for b, ix in enumerate(idxs):
            gidx[b, :len(ix)] = ix
            live[b, :len(ix)] = True

        def take(a):
            return torch.from_numpy(np.take_along_axis(a, gidx, 1)).to(dev)

        outs = _refine_executor(
            d, e2, take(lamh), take(loh), take(hih), take(xph), take(gph),
            torch.from_numpy(gidx.astype(np.int32)).to(dev),
            torch.from_numpy(live).to(dev), tol_dev, maxiter=_REFINE_TRIPS)
        iters += outs[-1]
        x1, lo1, hi1, xp1, gp1, live1 = (o.cpu().numpy() for o in outs[:-1])
        for b in range(B):
            ix = gidx[b, live[b]]
            for src, dst in ((x1, lamh), (lo1, loh), (hi1, hih),
                             (xp1, xph), (gp1, gph)):
                dst[b, ix] = src[b, live[b]]
            idxs[b] = gidx[b, live[b] & live1[b]]
    return iters


def refine_clusters(d, e, lam, *, nvalid=None,
                    tol_factor: float = DEFAULT_REFINE_TOL,
                    rounds: int = DEFAULT_REFINE_ROUNDS, sort: bool = True,
                    device=None):
    """Sturm-certified float64 refinement of approximate eigenvalues.

    The mixed-precision pipeline's second stage: ``lam`` holds all n
    estimates of each problem (the f32 tree's output, upcast); each round
    certifies everything with one f64 count sweep and polishes ONLY the
    uncertified lanes, until a sweep certifies every target or ``rounds``
    rounds ran.

    Args:
      d: (B, n) diagonals (rows may carry decoupled sentinel padding above
        ``nvalid[b]``; sentinel lanes are never touched).
      e: (B, n-1) off-diagonals.  lam: (B, n) ascending estimates.
      nvalid: optional (B,) count of real eigenvalues per row.
      tol_factor: certification tolerance in eps_f64 * ||T|| units.
      rounds: certify -> refine rounds cap.
      sort: re-sort each row before returning (callers that must permute
        companion state identically pass False and argsort themselves).
      device: where it runs (default: the CUDA card).

    Returns:
      (lam_refined (B, n) float64 tensor, info) with info keys
      ``targets``, ``polished``, ``iterations``, ``rounds``,
      ``polished_mask`` (host (B, n) bool: the lanes the polish touched;
      the others come back bit-identical to their input) and
      ``uncertified`` (host (B, n) bool: lanes that still miss the
      tolerance after the last round).  The JAX package stops after its
      last refine round without certifying its result; here a final
      sweep follows the last round, so a lane the rounds could not
      certify is reported instead of returned as if it were (measured:
      glued Wilkinson at n >= 512, where the secant's slope guard rejects
      clusters of more than 20 near-equal eigenvalues and Newton crawls;
      ROADMAP Queue 3).
    """
    dev = resolve_device(device)

    def f64(x):
        return torch.as_tensor(x, device=dev).to(torch.float64)

    d, e, lam = f64(d), f64(e), f64(lam)
    B, n = d.shape
    e2 = e * e
    nvalid_arr = (torch.full((B,), n, dtype=torch.int32, device=dev)
                  if nvalid is None else torch.as_tensor(
                      nvalid, dtype=torch.int32, device=dev))

    polished_mask = np.zeros((B, n), bool)
    iters = 0
    rounds_used = 0
    rounds = max(1, int(rounds))
    for r in range(rounds + 1):
        cert, lo, hi, tol_dev = _certify_executor(d, e2, lam, nvalid_arr,
                                                  float(tol_factor))
        miss = ~cert.cpu().numpy()
        if not miss.any() or r == rounds:
            break
        rounds_used += 1
        polished_mask |= miss
        lamh = lam.cpu().numpy().copy()
        iters += _refine_misses(d, e2, lamh, lo.cpu().numpy().copy(),
                                hi.cpu().numpy().copy(), tol_dev, miss)
        lam = torch.from_numpy(lamh).to(dev)
    if sort:
        lam = torch.sort(lam, dim=1).values
    info = {"targets": int(nvalid_arr.clamp(max=n).sum()),
            "polished": int(polished_mask.sum()),
            "iterations": iters, "rounds": rounds_used,
            "polished_mask": polished_mask, "uncertified": miss}
    return lam, info


def _validate_index_range(n: int, il, iu):
    il, iu = int(il), int(iu)
    if not (0 <= il <= iu < n):
        raise ValueError(
            f"index range must satisfy 0 <= il <= iu < n; got il={il}, "
            f"iu={iu}, n={n} (indices are 0-based and inclusive)")
    return il, iu


def eigvalsh_tridiagonal_range(d, e, *, select: str = "i",
                               il=None, iu=None, vl=None, vu=None,
                               maxiter: int | None = None,
                               polish: int | None = None,
                               dtype=None, device=None):
    """Selected eigenvalues of the symmetric tridiagonal (d, e).

    Brackets exactly the requested eigenvalues with Sturm-count bisection
    (all intervals refined in parallel) and polishes each with a
    bracket-safeguarded Newton iteration: O(k * n) work, O(n + k) memory.

    Args:
      d: (n,) diagonal, or (B, n) for a problem batch.
      e: (n-1,) off-diagonal, or (B, n-1).
      select: "i" -- 0-based ascending indices in the inclusive range
        [il, iu]; "v" -- eigenvalues in the half-open interval (vl, vu]
        (single problem only).
      maxiter: bisection halvings cap (None: DEFAULT_MAX_BISECT).
      polish: Newton polish steps (None: DEFAULT_POLISH).
      device: where it runs (default: the CUDA card; "cpu" for the plain
        torch path).

    Returns:
      (k,) ascending eigenvalues (or (B, k) for batched inputs); each
      within 8 * eps * ||T|| of the full solve's.
    """
    from repro_torch.core.request import SolveRequest, execute_request
    knobs = {"maxiter": maxiter, "polish": polish}
    if dtype is not None:
        knobs["dtype"] = dtype
    req = SolveRequest(d=d, e=e, kind="range", select=select, il=il, iu=iu,
                       vl=vl, vu=vu, knobs=knobs, device=device)
    return execute_request(req).eigenvalues
