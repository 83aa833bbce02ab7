"""The DLAED2 close-pole deflation chain of a merge level on the card:
wrapper of ``csrc/deflate_chain.cu``.  It replaces no Pallas kernel: the
JAX package runs the chain as XLA scans (``repro.core.merge.
_close_pole_scan`` and ``_deflate_apply``), which in eager PyTorch are
some twenty launches a step.

One warp per merge lane, one launch per level: the warp tests 32 poles
against their predecessors at once, applies the first rotation that
fires and restarts after it; see the source for the design.  The plain
version beside it is ``repro_torch.core.merge._close_pole_scan``: on a
CPU tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this
kernel, whose result equals the plain chain run on the card bit for bit.
:func:`chain_probe_cuda` times one dependent step of the chain on one
warp with its operands in registers: the chain bound of a level.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "deflate_chain_f64", torch.float32: "deflate_chain_f32"}


def _entry(dtype):
    fn = getattr(_build.load("deflate_chain"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def deflate_chain_cuda(d, z, R, small, tol):
    """Launch the chain: d, z (W, K) sorted poles and z entries (z-small
    entries zeroed); R (W, r, K), any r; small (W, K) bool; tol (W,) of
    d's dtype.  Returns new (d, z, R, deflated (W, K) bool), the inputs
    untouched."""
    _build.check_operands(d, z, R, small, tol)
    W, K = d.shape
    if z.shape != (W, K) or small.shape != (W, K):
        raise ValueError(f"z and small must be {(W, K)}, got "
                         f"{tuple(z.shape)} and {tuple(small.shape)}")
    if R.ndim != 3 or R.shape[0] != W or R.shape[2] != K:
        raise ValueError(f"R must be (W={W}, r, K={K}), got "
                         f"{tuple(R.shape)}")
    if tol.shape != (W,):
        raise ValueError(f"tol must be ({W},), got {tuple(tol.shape)}")
    if any(t.dtype != d.dtype for t in (z, R, tol)):
        raise TypeError("z, R and tol must have d's dtype")
    if small.dtype != torch.bool:
        raise TypeError(f"small must be bool, got {small.dtype}")
    if max(W, R.shape[1], K) >= 2**31:
        raise ValueError("a dimension exceeds the kernel's int range")
    R_out = R.clone()
    if W == 0 or K == 0:
        return d.clone(), z.clone(), R_out, small.clone()
    d_out = torch.empty_like(d)
    z_out = torch.empty_like(z)
    defl = torch.empty_like(small)
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(small),
                 _build.ptr(tol), _build.ptr(d_out), _build.ptr(z_out),
                 _build.ptr(R_out), _build.ptr(defl), W, R.shape[1], K,
                 _build.stream_ptr(d.device))
    _build.check(err, "deflate_chain")
    deflate_chain_cuda.launches += 1
    return d_out, z_out, R_out, defl


deflate_chain_cuda.launches = 0


def chain_probe_cuda(d, z, small, tol: float, reps: int):
    """One warp runs ``reps`` dependent window steps of the chain on the
    first 32 poles of one lane (float64 d, z (K,), small (K,) bool, on one
    card), held in registers, each step on the carry the last one left.
    Returns device tensors (SM clock cycles of the loop, the steps that
    rotated)."""
    _build.check_operands(d, z, small)
    if d.dtype != torch.float64 or z.dtype != torch.float64:
        raise TypeError("the chain probe runs float64")
    if d.ndim != 1 or z.shape != d.shape or small.shape != d.shape:
        raise ValueError("d, z and small must be one lane's (K,)")
    if small.dtype != torch.bool:
        raise TypeError(f"small must be bool, got {small.dtype}")
    if reps < 1:
        raise ValueError("reps must be >= 1")
    fn = _build.load("deflate_chain").deflate_chain_probe_f64
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_double]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    cycles = torch.empty((1,), dtype=torch.int64, device=d.device)
    fires = torch.empty((1,), dtype=torch.int32, device=d.device)
    sink = torch.empty((1,), dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(small),
                 float(tol), int(reps), d.shape[0], _build.ptr(cycles),
                 _build.ptr(fires), _build.ptr(sink),
                 _build.stream_ptr(d.device))
    _build.check(err, "deflate_chain_probe")
    return cycles, fires
