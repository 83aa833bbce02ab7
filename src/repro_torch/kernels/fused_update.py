"""Fused conquer post-pass on the card: wrapper of ``csrc/fused_update.cu``
(replaces the Pallas TPU kernel
``repro.kernels.fused_update.secular_postpass_pallas_batch``).

Two passes in one call on the current stream: pole-major weights, then
root-major columns (the TPU kernel's ordered grid has no CUDA analogue),
each output taken by a team of lanes; see the source for the design.
The plain version beside it is
``repro_torch.core.secular.secular_postpass_batched``: on a CPU tensor
``kernels.ops`` runs that; on a CUDA tensor it launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "fused_update_f64", torch.float32: "fused_update_f32"}


def _entry(dtype):
    lib = _build.load("fused_update")
    fn = getattr(lib, _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def secular_postpass_cuda(R, d, z, origin, tau, kprime, rho, *,
                          use_zhat: bool = True):
    """Launch the post-pass: R (B, r, K) with r <= 4; d, z, tau (B, K);
    origin (B, K) int32; kprime (B,) int32; rho (B,) of d's dtype.
    Returns (zhat (B, K), rows (B, r, K))."""
    B, r, K = R.shape
    _build.check_operands(d, R, z, origin, tau, kprime, rho)
    for name, t in (("d", d), ("z", z), ("origin", origin), ("tau", tau)):
        if t.shape != (B, K):
            raise ValueError(f"{name} must be {(B, K)}, got {tuple(t.shape)}")
    if kprime.shape != (B,) or rho.shape != (B,):
        raise ValueError("kprime and rho must be (B,)")
    if not 1 <= r <= 4:
        raise ValueError(f"the post-pass kernel takes 1 to 4 rows, got {r}")
    if any(t.dtype != d.dtype for t in (R, z, tau, rho)):
        raise TypeError("R, z, tau and rho must have d's dtype")
    if origin.dtype != torch.int32 or kprime.dtype != torch.int32:
        raise TypeError("origin and kprime must be int32")
    if B > 65535:
        raise ValueError(f"at most 65535 problems per launch, got {B}")
    zhat = torch.empty((B, K), dtype=d.dtype, device=d.device)
    rows = torch.empty((B, r, K), dtype=d.dtype, device=d.device)
    if B == 0 or K == 0:
        return zhat, rows
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(R), _build.ptr(d), _build.ptr(z),
                 _build.ptr(origin), _build.ptr(tau), _build.ptr(kprime),
                 _build.ptr(rho), _build.ptr(zhat), _build.ptr(rows),
                 B, r, K, int(bool(use_zhat)), _build.stream_ptr(d.device))
    _build.check(err, "fused_update")
    secular_postpass_cuda.launches += 1
    return zhat, rows


secular_postpass_cuda.launches = 0
