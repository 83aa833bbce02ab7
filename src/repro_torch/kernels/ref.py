"""Dense oracles for the port's kernels (torch port of the first part of
``repro.kernels.ref``).

Deliberately naive: each oracle materializes the full (K, K) intermediate
the kernels exist to avoid, so any tiling bug in a kernel shows up as a
mismatch.  The root oracle is plain bisection in float64 numpy, whose
only error is ~2^-niter of the initial bracket -- independent of the
kernels' rational iteration.  The Sturm and certify oracles are scalar
loops of the DSTEBZ count recurrence in float64 numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def secular_roots_ref(d, z2, rho, kprime, *, niter: int = 100):
    """Dense-bracket bisection oracle in the compact (origin, tau) form.

    Runs in numpy float64 whatever the input dtype; returns torch tensors
    (origin int32, tau float64) on the CPU.
    """
    d = _np(d).astype(np.float64)
    z2 = _np(z2).astype(np.float64)
    rho = float(rho)
    kprime = int(kprime)
    K = d.shape[0]
    origin = np.arange(K, dtype=np.int32)
    tau = np.zeros(K)

    span = rho * float(np.sum(z2[:kprime]))

    def g(lam):
        return 1.0 + rho * np.sum(z2[:kprime] / (d[:kprime] - lam))

    for j in range(kprime):
        if kprime == 1:
            origin[0], tau[0] = 0, rho * z2[0]
            break
        is_last = j == kprime - 1
        gap_hi = d[j] + span if is_last else d[j + 1]
        lo_lam, hi_lam = d[j], gap_hi
        for _ in range(niter):
            mid = 0.5 * (lo_lam + hi_lam)
            if g(mid) > 0:
                hi_lam = mid
            else:
                lo_lam = mid
        lam = 0.5 * (lo_lam + hi_lam)
        org = j if abs(lam - d[j]) <= abs(lam - gap_hi) or is_last else j + 1
        origin[j] = org
        tau[j] = lam - d[org]
    return torch.from_numpy(origin), torch.from_numpy(tau)


def zhat_reconstruct_ref(d, z, origin, tau, kprime, rho):
    """Dense pairwise log-product weight oracle."""
    K = d.shape[0]
    d_org = d[origin.long().clamp(max=K - 1)]
    active = torch.arange(K, device=d.device) < int(kprime)
    tiny = torch.finfo(d.dtype).tiny
    lam_diff = (d_org[None, :] - d[:, None]) + tau[None, :]   # (K_i, K_j)
    pole_diff = d[None, :] - d[:, None]
    jmask = active[None, :]
    selfmask = torch.eye(K, dtype=torch.bool, device=d.device)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    log_num = torch.where(jmask, torch.log(lam_diff.abs().clamp(min=tiny)),
                          zero).sum(1)
    log_den = torch.where(jmask & ~selfmask,
                          torch.log(pole_diff.abs().clamp(min=tiny)),
                          zero).sum(1)
    z2hat = torch.exp(log_num - log_den) / rho
    zhat = torch.sign(z) * torch.sqrt(z2hat.clamp(min=0.0))
    return torch.where(active, zhat, z)


def boundary_rows_update_ref(R, d, z, origin, tau, kprime):
    """Materializes the full K x K secular eigenvector block Y and applies
    R @ Y densely; deflated columns are identity pass-through."""
    K = d.shape[0]
    d_org = d[origin.long().clamp(max=K - 1)]
    active = torch.arange(K, device=d.device) < int(kprime)
    delta = (d[:, None] - d_org[None, :]) - tau[None, :]      # (K_i, K_j)
    ok = active[:, None] & (delta != 0.0)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    Y = torch.where(ok, z[:, None] / torch.where(ok, delta, one),
                    torch.zeros_like(delta))
    nrm = torch.sqrt((Y * Y).sum(0))
    Y = Y / torch.where(nrm > 0.0, nrm, one)[None, :]
    eye = torch.eye(K, dtype=R.dtype, device=d.device)
    Y = torch.where(active[None, :], Y, eye)
    return R @ Y


def secular_postpass_ref(R, d, z, origin, tau, kprime, rho, *,
                         use_zhat=True):
    """Dense oracle for the fused post-pass: full weight reconstruction
    followed by the dense K x K row update.  Returns (zhat, rows)."""
    zhat = (zhat_reconstruct_ref(d, z, origin, tau, kprime, rho)
            if use_zhat else z)
    return zhat, boundary_rows_update_ref(R, d, zhat, origin, tau, kprime)


def secular_roots_batch_ref(d, z2, rho, kprime, *, niter: int = 100):
    """Batched bisection oracle: a literal loop of single-problem oracles."""
    outs = [secular_roots_ref(d[b], z2[b], rho[b], kprime[b], niter=niter)
            for b in range(d.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def secular_postpass_batch_ref(R, d, z, origin, tau, kprime, rho, *,
                               use_zhat=True):
    """Batched dense oracle: loop of single-problem dense post-passes."""
    outs = [secular_postpass_ref(R[b], d[b], z[b], origin[b], tau[b],
                                 kprime[b], rho[b], use_zhat=use_zhat)
            for b in range(d.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def resident_merge_ref(d, z, R, rho, kprime, *, use_zhat=True,
                       niter: int = 100):
    """Dense oracle for the single-launch resident merge: bisection root
    solve followed by the dense post-pass.  Returns (origin, tau, zhat,
    rows)."""
    origin, tau = secular_roots_ref(d, z * z, rho, kprime, niter=niter)
    origin = origin.to(d.device)
    tau = tau.to(device=d.device, dtype=d.dtype)
    zhat, rows = secular_postpass_ref(R, d, z, origin, tau, kprime, rho,
                                      use_zhat=use_zhat)
    return origin, tau, zhat, rows


def resident_merge_batch_ref(d, z, R, rho, kprime, *, use_zhat=True,
                             niter: int = 100):
    """Batched resident-merge oracle: a literal loop of single-problem
    oracles."""
    outs = [resident_merge_ref(d[b], z[b], R[b], rho[b], kprime[b],
                               use_zhat=use_zhat, niter=niter)
            for b in range(d.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


def sturm_count_ref(d, e2, shifts, pivmin):
    """Literal per-(problem, shift) Python-loop Sturm count oracle.

    The exact DSTEBZ negcount recurrence in scalar numpy float64 -- any
    tiling bug in the batched kernel (lane mixing, pivot floor broadcast,
    row-tile edges) shows up as an integer mismatch.  d: (B, n);
    e2: (B, n-1); shifts: (B, S); pivmin: (B, 1) or (B,).  Returns a
    (B, S) int32 tensor on the CPU.
    """
    d = _np(d).astype(np.float64)
    e2 = _np(e2).astype(np.float64)
    shifts = _np(shifts).astype(np.float64)
    pivmin = _np(pivmin).astype(np.float64).reshape(d.shape[0])
    B, n = d.shape
    out = np.zeros(shifts.shape, np.int32)
    for b in range(B):
        for s in range(shifts.shape[1]):
            sig = shifts[b, s]
            q = d[b, 0] - sig
            if abs(q) < pivmin[b]:
                q = -pivmin[b]
            cnt = 1 if q <= 0.0 else 0
            for i in range(1, n):
                q = (d[b, i] - sig) - e2[b, i - 1] / q
                if abs(q) < pivmin[b]:
                    q = -pivmin[b]
                cnt += 1 if q <= 0.0 else 0
            out[b, s] = cnt
    return torch.from_numpy(out)


def certify_ref(d, e, lam, tol):
    """Literal certification oracle for the mixed-precision pipeline.

    ``lam[b, j]`` is certified when the float64 Sturm counts bracket the
    j-th true eigenvalue within ``tol[b]``: ``count(lam - tol) <= j`` and
    ``count(lam + tol) >= j + 1``.  Built on :func:`sturm_count_ref`; the
    vectorized 2N-shift certify sweep must agree with it exactly.
    d: (B, n); e: (B, n-1); lam: (B, n); tol: (B,) or (B, 1).  Returns a
    (B, n) bool tensor on the CPU.
    """
    d = _np(d).astype(np.float64)
    e = _np(e).astype(np.float64)
    lam = _np(lam).astype(np.float64)
    tol = _np(tol).astype(np.float64).reshape(d.shape[0], 1)
    e2 = e * e
    safmin = np.finfo(np.float64).tiny
    pivmin = safmin * np.maximum(1.0, e2.max(axis=1, initial=0.0))
    j = np.arange(d.shape[1])[None, :]
    lo = sturm_count_ref(d, e2, lam - tol, pivmin).numpy()
    hi = sturm_count_ref(d, e2, lam + tol, pivmin).numpy()
    return torch.from_numpy((lo <= j) & (hi >= j + 1))
