"""Batched Sturm counts on the card: wrapper of ``csrc/sturm_count.cu``
(replaces the Pallas TPU kernel
``repro.kernels.sturm_count.sturm_count_pallas_batch``).

Two launches from one source:

  * :func:`sturm_count_cuda` -- #{eigenvalues <= shift} for every
    (problem, shift); plain version ``core.bisect.sturm_count_plain``;
  * :func:`sturm_count_newton_cuda` -- the same sweep plus the derivative
    sum of the pivot recurrence; plain version
    ``core.bisect._count_and_newton``.  The JAX package runs this sweep
    as an XLA scan; in eager PyTorch it would be a Python loop of about
    ten launches per matrix row, so it is a kernel here.

:func:`chain_probe_cuda` is a measurement, not a step of any solve: one
thread walks one shift's chain, and its time is the latency bound of a
bisection trip.

One thread per (problem, shift), the problem's rows staged through
shared memory; see the source for the design.  On a CPU tensor
``kernels.ops`` runs the plain versions; on a CUDA tensor it launches
these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Threads (shifts) per block; must equal SHIFTS_PER_BLOCK in the source.
SHIFTS_PER_BLOCK = 64

_DTYPE = {torch.float64: "f64", torch.float32: "f32"}


def _entry(name: str, dtype, newton: bool):
    lib = _build.load("sturm_count")
    fn = getattr(lib, f"{name}_{_DTYPE[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * (6 if newton else 5)
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, newton: bool, d, e2, shifts, pivmin):
    _build.check_operands(d, e2, shifts, pivmin)
    B, n = d.shape
    S = shifts.shape[1] if shifts.ndim == 2 else -1
    if (e2.shape != (B, max(n - 1, 0)) or shifts.shape != (B, S)
            or pivmin.shape != (B,)):
        raise ValueError(f"shapes d {tuple(d.shape)}, e2 {tuple(e2.shape)}, "
                         f"shifts {tuple(shifts.shape)}, pivmin "
                         f"{tuple(pivmin.shape)} do not match (B, n), "
                         f"(B, n-1), (B, S), (B,)")
    if any(t.dtype != d.dtype for t in (e2, shifts, pivmin)):
        raise TypeError("e2, shifts and pivmin must have d's dtype")
    if n < 1:
        raise ValueError("a Sturm count needs n >= 1")
    count = torch.empty((B, S), dtype=torch.int32, device=d.device)
    deriv = (torch.empty((B, S), dtype=d.dtype, device=d.device)
             if newton else None)
    if B == 0 or S == 0:
        return count, deriv
    blocks = B * -(-S // SHIFTS_PER_BLOCK)
    if blocks > 2**31 - 1:
        raise ValueError(f"{blocks} blocks exceed one launch's grid")
    fn = _entry(name, d.dtype, newton)
    outs = [count] + ([deriv] if newton else [])
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e2), _build.ptr(shifts),
                 _build.ptr(pivmin), *map(_build.ptr, outs), B, n, S,
                 _build.stream_ptr(d.device))
    _build.check(err, name)
    wrapper.launches += 1
    return count, deriv


def sturm_count_cuda(d, e2, shifts, pivmin):
    """Launch the count kernel: d (B, n); e2 (B, n-1); shifts (B, S);
    pivmin (B,), all of one float dtype on one card.  Returns (B, S)
    int32 counts of eigenvalues <= shift."""
    return _launch(sturm_count_cuda, "sturm_count", False, d, e2, shifts,
                   pivmin)[0]


def sturm_count_newton_cuda(d, e2, shifts, pivmin):
    """Launch the count + derivative kernel (shapes as
    :func:`sturm_count_cuda`).  Returns (count (B, S) int32, s (B, S))
    with s = d/dx log|det(T - xI)| at each shift."""
    return _launch(sturm_count_newton_cuda, "sturm_count_newton", True, d,
                   e2, shifts, pivmin)


sturm_count_cuda.launches = 0
sturm_count_newton_cuda.launches = 0


def chain_probe_cuda(d, e2, shift: float, pivmin: float):
    """Time one shift's chain on one thread: d (n,), e2 (n-1,) float64 on
    one card.  Returns (count, cycles) as device tensors: the Sturm count
    at ``shift`` (equal to the count kernel's) and the SM clock cycles of
    the sweep, n times the latency of one row's dependent operations."""
    _build.check_operands(d, e2)
    n = d.shape[0]
    if d.dtype != torch.float64 or e2.dtype != torch.float64:
        raise TypeError("the chain probe runs float64")
    if d.ndim != 1 or e2.shape != (max(n - 1, 0),) or n < 1:
        raise ValueError(f"shapes d {tuple(d.shape)}, e2 {tuple(e2.shape)} "
                         f"are not (n,), (n-1,) with n >= 1")
    lib = _build.load("sturm_count")
    fn = lib.sturm_chain_probe_f64
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_double] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    count = torch.empty((1,), dtype=torch.int32, device=d.device)
    cycles = torch.empty((1,), dtype=torch.int64, device=d.device)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e2), float(shift), float(pivmin),
                 _build.ptr(count), _build.ptr(cycles), n,
                 _build.stream_ptr(d.device))
    _build.check(err, "sturm_chain_probe")
    return count, cycles
