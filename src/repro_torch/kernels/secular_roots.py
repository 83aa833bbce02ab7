"""Batched secular root solve on the card: wrapper of
``csrc/secular_roots.cu`` (replaces the Pallas TPU kernel
``repro.kernels.secular_roots.secular_solve_pallas_batch``).

A team of lanes per root, 256-thread blocks, one grid row per problem,
poles streamed through a cp.async ring of shared-memory tiles; see the
source for the design.  The plain version beside it is
``repro_torch.core.secular.secular_solve_batched``: on a CPU tensor
``kernels.ops`` runs that; on a CUDA tensor it launches this kernel.

:func:`secular_solve_window_cuda` launches the same kernel on a root
window (roots ``[start, start + nroots)``, plain version
``secular.secular_solve_window_batched``), the solve of one shard of the
distributed conquer's cooperative levels; it counts its launches apart
from the full launch's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "secular_roots_f64", torch.float32: "secular_roots_f32"}


def _entry(dtype):
    lib = _build.load("secular_roots")
    fn = getattr(lib, _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(d, z2, rho, kprime, start: int, nroots: int, niter: int):
    """Launch roots ``[start, start + nroots)`` of each problem (the full
    launch is the window (0, K)).  Returns (origin (B, nroots) int32, tau
    (B, nroots)) and whether the kernel was launched."""
    B, K = d.shape
    _build.check_operands(d, z2, rho, kprime)
    if z2.shape != (B, K) or rho.shape != (B,) or kprime.shape != (B,):
        raise ValueError(f"shapes d {tuple(d.shape)}, z2 {tuple(z2.shape)}, "
                         f"rho {tuple(rho.shape)}, kprime "
                         f"{tuple(kprime.shape)} do not match")
    if z2.dtype != d.dtype or rho.dtype != d.dtype:
        raise TypeError("z2 and rho must have d's dtype")
    if kprime.dtype != torch.int32:
        raise TypeError(f"kprime must be int32, got {kprime.dtype}")
    if B > 65535:
        raise ValueError(f"at most 65535 problems per launch, got {B}")
    start, nroots = int(start), int(nroots)
    if start < 0 or nroots < 0 or start + nroots > K:
        raise ValueError(f"window [{start}, {start + nroots}) is not inside "
                         f"[0, {K})")
    origin = torch.empty((B, nroots), dtype=torch.int32, device=d.device)
    tau = torch.empty((B, nroots), dtype=d.dtype, device=d.device)
    if B == 0 or nroots == 0:
        return origin, tau, False
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z2), _build.ptr(rho),
                 _build.ptr(kprime), _build.ptr(origin), _build.ptr(tau),
                 B, K, start, nroots, int(niter),
                 _build.stream_ptr(d.device))
    _build.check(err, "secular_roots")
    return origin, tau, True


def secular_solve_cuda(d, z2, rho, kprime, *, niter: int):
    """Launch the root-solve kernel: d, z2 (B, K); rho (B,) of d's dtype;
    kprime (B,) int32.  Returns (origin (B, K) int32, tau (B, K))."""
    origin, tau, ran = _launch(d, z2, rho, kprime, 0, d.shape[1], niter)
    secular_solve_cuda.launches += ran
    return origin, tau


secular_solve_cuda.launches = 0


def secular_solve_window_cuda(d, z2, rho, kprime, start: int, nroots: int,
                              *, niter: int):
    """Launch the kernel on roots ``[start, start + nroots)`` of each
    problem only; operands as :func:`secular_solve_cuda`.  Returns
    (origin (B, nroots) int32, tau (B, nroots)), equal to those columns of
    the full launch bit for bit."""
    origin, tau, ran = _launch(d, z2, rho, kprime, start, nroots, niter)
    secular_solve_window_cuda.launches += ran
    return origin, tau


secular_solve_window_cuda.launches = 0
