"""Gu-Eisenstat weights of the two-pass conquer on the card: wrapper of
``csrc/zhat.cu`` (replaces the Pallas TPU kernel
``repro.kernels.zhat.zhat_reconstruct_pallas``).

One team of lanes per pole, DLAED3's ratio product (the fused post-pass's
pass A, ``csrc/weights.cuh``), the roots staged through double-buffered
shared-memory tiles; see the source for the design.  The plain version
beside it is ``repro_torch.core.secular.zhat_reconstruct_batched`` (log
space, as in ``repro``): on a CPU tensor ``kernels.ops`` runs that; on a
CUDA tensor it launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "zhat_f64", torch.float32: "zhat_f32"}


def _entry(dtype):
    fn = getattr(_build.load("zhat"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def zhat_reconstruct_cuda(d, z, origin, tau, kprime, rho):
    """Launch the weight kernel: d, z, tau (B, K); origin (B, K) int32;
    kprime (B,) int32; rho (B,) of d's dtype.  Returns zhat (B, K)."""
    B, K = d.shape
    _build.check_operands(d, z, origin, tau, kprime, rho)
    for name, t in (("z", z), ("origin", origin), ("tau", tau)):
        if t.shape != (B, K):
            raise ValueError(f"{name} must be {(B, K)}, got {tuple(t.shape)}")
    if kprime.shape != (B,) or rho.shape != (B,):
        raise ValueError("kprime and rho must be (B,)")
    if any(t.dtype != d.dtype for t in (z, tau, rho)):
        raise TypeError("z, tau and rho must have d's dtype")
    if origin.dtype != torch.int32 or kprime.dtype != torch.int32:
        raise TypeError("origin and kprime must be int32")
    if B > 65535:
        raise ValueError(f"at most 65535 problems per launch, got {B}")
    zhat = torch.empty((B, K), dtype=d.dtype, device=d.device)
    if B == 0 or K == 0:
        return zhat
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(origin),
                 _build.ptr(tau), _build.ptr(rho), _build.ptr(kprime),
                 _build.ptr(zhat), B, K, _build.stream_ptr(d.device))
    _build.check(err, "zhat")
    zhat_reconstruct_cuda.launches += 1
    return zhat


zhat_reconstruct_cuda.launches = 0
