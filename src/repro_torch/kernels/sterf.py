"""Implicit-shift QL eigenvalues on the card: wrapper of
``csrc/sterf.cu``.  It replaces no Pallas kernel: the JAX package runs
the iteration as an XLA loop (``repro.core.sterf._sterf_jit``), which in
eager PyTorch would be some fifteen launches per rotation.

One thread per problem walks the whole iteration; see the source for the
design.  The plain version beside it is
``repro_torch.core.sterf.sterf_plain``: on a CPU tensor ``kernels.ops``
runs that; on a CUDA tensor it launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "sterf_f64", torch.float32: "sterf_f32"}


def _entry(dtype):
    fn = getattr(_build.load("sterf"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sterf_cuda(d, e):
    """Launch the QL kernel: d (B, n), e (B, n-1) of one float dtype on one
    card.  Returns (eigenvalues (B, n) ascending, rotations (B,) int64:
    the rotation steps each problem's iteration ran)."""
    _build.check_operands(d, e)
    B, n = d.shape
    if e.shape != (B, max(n - 1, 0)) or e.dtype != d.dtype:
        raise ValueError(f"e must be {(B, max(n - 1, 0))} of d's dtype, got "
                         f"{tuple(e.shape)} {e.dtype}")
    if n < 1:
        raise ValueError("a QL solve needs n >= 1")
    lam = torch.empty((B, n), dtype=d.dtype, device=d.device)
    work = torch.empty((B, n), dtype=d.dtype, device=d.device)
    steps = torch.empty((B,), dtype=torch.int64, device=d.device)
    if B == 0:
        return lam, steps
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e), _build.ptr(lam),
                 _build.ptr(work), _build.ptr(steps), B, n,
                 _build.stream_ptr(d.device))
    _build.check(err, "sterf")
    sterf_cuda.launches += 1
    return torch.sort(lam, dim=1).values, steps


sterf_cuda.launches = 0
