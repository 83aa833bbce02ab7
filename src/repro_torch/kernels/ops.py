"""Device-routed dispatchers for the eigensolver's kernels.

Dispatch goes by the device of the tensors, never by a process-wide
switch:

  * a CPU tensor runs the plain torch version (``repro_torch.core.secular``
    for the merge kernels, ``repro_torch.core.merge`` for the deflation
    chain, ``repro_torch.core.bisect`` for the Sturm counts,
    ``repro_torch.core.sterf`` for the QL iteration);
    ``dense=`` picks its dense (one (K, K) tile) or chunked form, as in the
    JAX package's size-adaptive level dispatch;
  * a CUDA tensor launches the hand-written kernel, or raises.  It never
    falls back to the plain version, and ``dense``/``chunk`` select nothing
    there: the kernels tile the pole axis themselves.

``niter=None`` resolves to the dtype's secular budget (:func:`resolve_niter`).
"""

from __future__ import annotations

import torch

from repro_torch.core import bisect as _bis
from repro_torch.core import secular as _sec
from repro_torch.core import sterf as _sterf
from repro_torch.core.secular import DEFAULT_NITER, DEFAULT_NITER_F32
from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
from repro_torch.kernels.deflate_chain import deflate_chain_cuda
from repro_torch.kernels.fused_update import secular_postpass_cuda
from repro_torch.kernels.resident_merge import resident_merge_cuda
from repro_torch.kernels.secular_roots import (secular_solve_cuda,
                                               secular_solve_window_cuda)
from repro_torch.kernels.sterf import sterf_cuda
from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                             sturm_count_cuda,
                                             sturm_count_newton_cuda)
from repro_torch.kernels.zhat import zhat_reconstruct_cuda

# Most selected rows the fused post-pass and the resident merge take (the
# boundary rows of the tree: 2, or 3 with a tracked row).  A level with
# more rows -- r = K in the full-vector and lazy baselines -- runs the
# two-pass conquer, whose row update takes any r.
FUSED_MAX_ROWS = 4


def resolve_niter(niter: int | None, dtype) -> int:
    """Per-dtype default secular iteration budget; an explicit niter wins."""
    if niter is not None:
        return int(niter)
    return DEFAULT_NITER_F32 if dtype == torch.float32 else DEFAULT_NITER


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got a tensor "
                         f"on {t.device}")
    return False


def _int32(t):
    return t.to(torch.int32).contiguous()


def secular_solve_batched(d, z2, rho, kprime, *, niter: int | None = None,
                          chunk: int = 256, dense: bool = False):
    """Problem-batched secular solve: d, z2 (B, K); rho, kprime (B,).
    Returns (origin (B, K) int32, tau (B, K))."""
    niter = resolve_niter(niter, d.dtype)
    if _on_card(d):
        return secular_solve_cuda(d.contiguous(), z2.contiguous(),
                                  rho.contiguous(), _int32(kprime),
                                  niter=niter)
    return _sec.secular_solve_batched(d, z2, rho, kprime, niter=niter,
                                      chunk=chunk, dense=dense)


def secular_solve_window_batched(d, z2, rho, kprime, start: int,
                                 nroots: int, *, niter: int | None = None,
                                 chunk: int = 256, dense: bool = False):
    """Roots ``[start, start + nroots)`` of B problems: d, z2 (B, K); rho,
    kprime (B,).  On the card the root-window entry of the root-solve
    kernel (one launch, this window's roots only).  Returns (origin
    (B, nroots) int32, tau (B, nroots))."""
    niter = resolve_niter(niter, d.dtype)
    if _on_card(d):
        return secular_solve_window_cuda(d.contiguous(), z2.contiguous(),
                                         rho.contiguous(), _int32(kprime),
                                         start, nroots, niter=niter)
    return _sec.secular_solve_window_batched(d, z2, rho, kprime, start,
                                             nroots, niter=niter,
                                             chunk=chunk, dense=dense)


def secular_postpass_batched(R, d, z, origin, tau, kprime, rho, *,
                             use_zhat: bool = True, chunk: int = 256,
                             dense: bool = False):
    """Problem-batched fused post-pass: R (B, r, K); d, z, origin, tau
    (B, K); kprime, rho (B,).  Returns (zhat (B, K), rows (B, r, K))."""
    if _on_card(d):
        return secular_postpass_cuda(
            R.contiguous(), d.contiguous(), z.contiguous(), _int32(origin),
            tau.contiguous(), _int32(kprime), rho.contiguous(),
            use_zhat=use_zhat)
    return _sec.secular_postpass_batched(R, d, z, origin, tau, kprime, rho,
                                         use_zhat=use_zhat, chunk=chunk,
                                         dense=dense)


def secular_merge_resident_batched(d, z, R, rho, kprime, *,
                                   niter: int | None = None,
                                   use_zhat: bool = True):
    """Problem-batched single-dispatch merge: d, z (B, K); R (B, r, K);
    rho, kprime (B,).  One kernel launch per level on the card.  Returns
    (origin (B, K) int32, tau (B, K), zhat (B, K), rows (B, r, K))."""
    niter = resolve_niter(niter, d.dtype)
    if _on_card(d):
        return resident_merge_cuda(d.contiguous(), z.contiguous(),
                                   R.contiguous(), rho.contiguous(),
                                   _int32(kprime), niter=niter,
                                   use_zhat=use_zhat)
    return _sec.secular_merge_resident_batched(d, z, R, rho, kprime,
                                               niter=niter,
                                               use_zhat=use_zhat)


def deflate_chain_batched(d, z, R, small, tol):
    """The DLAED2 close-pole chain of W merge lanes: d, z, small (W, K);
    R (W, r, K), any r; tol (W,).  One launch on the card.  Returns new
    (d, z, R, deflated (W, K) bool)."""
    if _on_card(d):
        return deflate_chain_cuda(d.contiguous(), z.contiguous(),
                                  R.contiguous(), small.contiguous(),
                                  tol.contiguous())
    from repro_torch.core import merge as _merge  # deferred: merge imports ops
    return _merge._close_pole_scan(d, z, R, small, tol)


def sturm_count_batched(d, e2, shifts, pivmin):
    """Batched Sturm counts: d (B, n); e2 (B, n-1); shifts (B, S); pivmin
    (B, 1) or (B,).  Returns (B, S) int32 counts of eigenvalues <= shift
    (the bisection front end's and the certify sweep's workhorse)."""
    if _on_card(d):
        return sturm_count_cuda(d.contiguous(), e2.contiguous(),
                                shifts.contiguous(),
                                pivmin.reshape(-1).contiguous())
    return _bis.sturm_count_plain(d, e2, shifts, pivmin.reshape(-1, 1))


def zhat_reconstruct_batched(d, z, origin, tau, kprime, rho, *,
                             chunk: int = 256):
    """Problem-batched log-space weights of the two-pass conquer: d, z,
    origin, tau (B, K); kprime, rho (B,).  Returns zhat (B, K)."""
    if _on_card(d):
        return zhat_reconstruct_cuda(d.contiguous(), z.contiguous(),
                                     _int32(origin), tau.contiguous(),
                                     _int32(kprime), rho.contiguous())
    return _sec.zhat_reconstruct_batched(d, z, origin, tau, kprime, rho,
                                         chunk=chunk)


def boundary_rows_update_batched(R, d, z, origin, tau, kprime, *,
                                 chunk: int = 256):
    """Problem-batched row update of the two-pass conquer, any row count:
    R (B, r, K); d, z (the weights), origin, tau (B, K); kprime (B,).
    Returns rows (B, r, K)."""
    if _on_card(d):
        return boundary_rows_update_cuda(R.contiguous(), d.contiguous(),
                                         z.contiguous(), _int32(origin),
                                         tau.contiguous(), _int32(kprime))
    return _sec.boundary_rows_update_batched(R, d, z, origin, tau, kprime,
                                             chunk=chunk)


def sterf_batched(d, e):
    """Implicit-shift QL eigenvalues of B problems: d (B, n), e (B, n-1).
    Returns (eigenvalues (B, n) ascending, rotations (B,) int64)."""
    if _on_card(d):
        return sterf_cuda(d.contiguous(), e.contiguous())
    return _sterf.sterf_plain(d, e)


def count_and_newton_batched(d, e2, x, pivmin):
    """Sturm counts plus the pivot recurrence's derivative sum at every
    shift (shapes as :func:`sturm_count_batched`).  Returns (count (B, S)
    int32, s (B, S)): the Newton polish's and the refine loop's sweep."""
    if _on_card(d):
        return sturm_count_newton_cuda(d.contiguous(), e2.contiguous(),
                                       x.contiguous(),
                                       pivmin.reshape(-1).contiguous())
    return _bis._count_and_newton(d, e2, x, pivmin.reshape(-1, 1))


def bisect_tree_batched(d, e2, pivmin, tol, targets, lo, hi, *, depth: int,
                        steps: int):
    """``steps`` <= ``depth`` halvings of every bisection bracket in one
    sweep of its depth-``depth`` bisection tree: d (B, n); e2 (B, n-1);
    pivmin, tol (B, 1) or (B,); targets (B, k) int32; lo, hi (B, k).
    Returns (lo, hi, node counts (B, k, 2^depth - 1) int32), the same bits
    as ``steps`` trips of the bisection host loop."""
    if _on_card(d):
        return sturm_bisect_tree_cuda(
            d.contiguous(), e2.contiguous(), pivmin.reshape(-1).contiguous(),
            tol.reshape(-1).contiguous(), _int32(targets), lo.contiguous(),
            hi.contiguous(), depth=depth, steps=steps)
    return _bis.bisect_tree_plain(d, e2, pivmin.reshape(-1, 1),
                                  tol.reshape(-1, 1), targets, lo, hi,
                                  depth=depth, steps=steps)


def _as_scalar(x, like, dtype=None):
    return torch.as_tensor(x, dtype=dtype or like.dtype,
                           device=like.device).reshape(1)


def secular_solve(d, z2, rho, kprime, *, niter: int | None = None,
                  chunk: int = 256, dense: bool = False):
    """Single-problem view: d, z2 (K,); rho, kprime scalars."""
    o, t = secular_solve_batched(d[None], z2[None], _as_scalar(rho, d),
                                 _as_scalar(kprime, d, torch.int32),
                                 niter=niter, chunk=chunk, dense=dense)
    return o[0], t[0]


def secular_postpass(R, d, z, origin, tau, kprime, rho, *,
                     use_zhat: bool = True, chunk: int = 256,
                     dense: bool = False):
    """Single-problem view: R (r, K); d, z, origin, tau (K,)."""
    zhat, rows = secular_postpass_batched(
        R[None], d[None], z[None], origin[None], tau[None],
        _as_scalar(kprime, d, torch.int32), _as_scalar(rho, d),
        use_zhat=use_zhat, chunk=chunk, dense=dense)
    return zhat[0], rows[0]


def secular_merge_resident(d, z, R, rho, kprime, *,
                           niter: int | None = None, use_zhat: bool = True):
    """Single-problem view: d, z (K,); R (r, K)."""
    outs = secular_merge_resident_batched(
        d[None], z[None], R[None], _as_scalar(rho, d),
        _as_scalar(kprime, d, torch.int32), niter=niter, use_zhat=use_zhat)
    return tuple(o[0] for o in outs)


def zhat_reconstruct(d, z, origin, tau, kprime, rho, *, chunk: int = 256):
    """Single-problem view: d, z, origin, tau (K,); kprime, rho scalars."""
    return zhat_reconstruct_batched(
        d[None], z[None], origin[None], tau[None],
        _as_scalar(kprime, d, torch.int32), _as_scalar(rho, d),
        chunk=chunk)[0]


def boundary_rows_update(R, d, z, origin, tau, kprime, *, chunk: int = 256):
    """Single-problem view: R (r, K); d, z, origin, tau (K,)."""
    return boundary_rows_update_batched(
        R[None], d[None], z[None], origin[None], tau[None],
        _as_scalar(kprime, d, torch.int32), chunk=chunk)[0]
