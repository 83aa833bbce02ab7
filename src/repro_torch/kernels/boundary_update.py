"""Selected-row update of the two-pass conquer on the card, any number of
rows: wrapper of ``csrc/boundary_update.cu`` (replaces the Pallas TPU
kernel ``repro.kernels.boundary_update.boundary_rows_update_pallas``).

One launch per call; the source picks its tiling by the row count (one
thread per root column for r <= 4, 64 x 64 output tiles with the secular
vectors built in shared memory for larger r, up to r = K in the
full-vector and lazy baselines); see the source for the design.  The
plain version beside it is
``repro_torch.core.secular.boundary_rows_update_batched``: on a CPU
tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "boundary_update_f64",
       torch.float32: "boundary_update_f32"}


def _entry(dtype):
    fn = getattr(_build.load("boundary_update"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def boundary_rows_update_cuda(R, d, z, origin, tau, kprime):
    """Launch the row update: R (B, r, K), any r >= 1; d, z, tau (B, K);
    origin (B, K) int32; kprime (B,) int32.  ``z`` holds the weights
    (zhat, or z itself).  Returns rows (B, r, K)."""
    B, r, K = R.shape
    _build.check_operands(d, R, z, origin, tau, kprime)
    for name, t in (("d", d), ("z", z), ("origin", origin), ("tau", tau)):
        if t.shape != (B, K):
            raise ValueError(f"{name} must be {(B, K)}, got {tuple(t.shape)}")
    if kprime.shape != (B,):
        raise ValueError("kprime must be (B,)")
    if any(t.dtype != d.dtype for t in (R, z, tau)):
        raise TypeError("R, z and tau must have d's dtype")
    if origin.dtype != torch.int32 or kprime.dtype != torch.int32:
        raise TypeError("origin and kprime must be int32")
    if B > 65535 or r > 64 * 65535:
        raise ValueError(f"at most 65535 problems and {64 * 65535} rows per "
                         f"launch, got B={B}, r={r}")
    rows = torch.empty((B, r, K), dtype=d.dtype, device=d.device)
    if B == 0 or r == 0 or K == 0:
        return rows
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(R), _build.ptr(d), _build.ptr(z),
                 _build.ptr(origin), _build.ptr(tau), _build.ptr(kprime),
                 _build.ptr(rows), B, r, K, _build.stream_ptr(d.device))
    _build.check(err, "boundary_update")
    boundary_rows_update_cuda.launches += 1
    return rows


boundary_rows_update_cuda.launches = 0
