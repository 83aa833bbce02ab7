"""Implicit-shift QL eigenvalues on the card: wrapper of
``csrc/sterf.cu``.  It replaces no Pallas kernel: the JAX package runs
the iteration as an XLA loop (``repro.core.sterf._sterf_jit``), which in
eager PyTorch would be some fifteen launches per rotation.

One warp per problem: a ballot split search, the rotation chain on one
lane, (d, e) in shared memory once the active rows fit
(:func:`launch_shape`); see the source for the design.  The plain
version beside it is ``repro_torch.core.sterf.sterf_plain``: on a CPU
tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this
kernel.
:func:`chain_probe_cuda` times the kernel's rotation on one thread, with
its rows in registers: the chain bound of a QL solve.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "sterf_f64", torch.float32: "sterf_f32"}

# Dynamic shared memory a Hopper block may use (227 KB).
SMEM_LIMIT = 232448
# Compiled into csrc/sterf.cu: one warp per problem, and the chain
# probe's register block of rows.
THREADS = 32
PROBE_ROWS = 16


class LaunchShape(NamedTuple):
    threads: int    # one warp per problem
    rows: int       # rows of (d, e) the block's shared memory holds
    smem: int       # dynamic shared memory of a block, bytes
    grid: int       # blocks: one per problem


def launch_shape(B: int, n: int, dtype) -> LaunchShape:
    """One warp per problem, and as many rows of (d, e) -- two elements
    each -- as the block's shared memory holds, at most n: a larger
    problem works in device memory until its active rows fit.  A function
    of its arguments only: results do not depend on it, only speed
    does."""
    item = torch.empty((), dtype=dtype).element_size()
    rows = min(n, SMEM_LIMIT // (2 * item))
    return LaunchShape(THREADS, rows, 2 * rows * item, B)


def _entry(dtype):
    fn = getattr(_build.load("sterf"), _FN[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(d, e, cap, rows=None):
    """Run at most ``cap`` outer steps on every problem; returns (d, e) as
    the iteration leaves them (unsorted; e[:, n-1] == 0) and the
    rotations (B,) int64.  ``rows`` overrides launch_shape's shared-memory
    rows (0: device memory throughout), so that tests run a small problem
    in a large one's regimes; results are the same bits whatever it is."""
    _build.check_operands(d, e)
    B, n = d.shape
    if e.shape != (B, max(n - 1, 0)) or e.dtype != d.dtype:
        raise ValueError(f"e must be {(B, max(n - 1, 0))} of d's dtype, got "
                         f"{tuple(e.shape)} {e.dtype}")
    if n < 1:
        raise ValueError("a QL solve needs n >= 1")
    if B > 2**31 - 1:
        raise ValueError(f"{B} problems exceed one launch's grid")
    shape = launch_shape(B, n, d.dtype)
    if rows is not None:
        if not 0 <= rows <= shape.rows:
            raise ValueError(f"rows must be in [0, {shape.rows}], got {rows}")
        shape = shape._replace(rows=rows,
                               smem=2 * rows * d.element_size())
    lam = torch.empty((B, n), dtype=d.dtype, device=d.device)
    work = torch.empty((B, n), dtype=d.dtype, device=d.device)
    steps = torch.empty((B,), dtype=torch.int64, device=d.device)
    if B == 0:
        return lam, work, steps
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e), _build.ptr(lam),
                 _build.ptr(work), _build.ptr(steps), B, n, int(cap),
                 shape.threads, shape.rows, shape.smem,
                 _build.stream_ptr(d.device))
    _build.check(err, "sterf")
    sterf_cuda.launches += 1
    return lam, work, steps


def sterf_cuda(d, e):
    """Launch the QL kernel: d (B, n), e (B, n-1) of one float dtype on one
    card.  Returns (eigenvalues (B, n) ascending, rotations (B,) int64:
    the rotation steps each problem's iteration ran)."""
    lam, _, steps = _launch(d, e, 30 * d.shape[1])
    return torch.sort(lam, dim=1).values, steps


sterf_cuda.launches = 0


def chain_probe_cuda(d, e, reps: int):
    """One thread runs the kernel's rotation chain on the first
    PROBE_ROWS + 1 rows of (d, e) (float64, on one card), held in
    registers: the first sweep's shift, then ``reps`` passes of PROBE_ROWS
    rotations over the rows with the chain carried on.  Returns (d, e)
    of the block as the last pass leaves it (for reps == 1 the kernel's
    first sweep of a matrix whose first split is at PROBE_ROWS), the
    rotations run, the SM clock cycles they took and whether every
    rotation stayed in the reciprocal square root's range (the kernel's
    straight-line path), all device tensors."""
    _build.check_operands(d, e)
    if d.dtype != torch.float64 or e.dtype != torch.float64:
        raise TypeError("the chain probe runs float64")
    if d.ndim != 1 or e.ndim != 1 or d.shape[0] < PROBE_ROWS + 1 or (
            e.shape[0] < PROBE_ROWS):
        raise ValueError(f"the chain probe needs d of at least "
                         f"{PROBE_ROWS + 1} rows and e of {PROBE_ROWS}")
    if reps < 1:
        raise ValueError("reps must be >= 1")
    fn = _build.load("sterf").sterf_chain_probe_f64
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    d_out = torch.empty((PROBE_ROWS + 1,), dtype=d.dtype, device=d.device)
    e_out = torch.empty((PROBE_ROWS + 1,), dtype=d.dtype, device=d.device)
    rotations = torch.empty((1,), dtype=torch.int64, device=d.device)
    cycles = torch.empty((1,), dtype=torch.int64, device=d.device)
    in_range = torch.empty((1,), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e), int(reps), _build.ptr(d_out),
                 _build.ptr(e_out), _build.ptr(rotations),
                 _build.ptr(cycles), _build.ptr(in_range),
                 _build.stream_ptr(d.device))
    _build.check(err, "sterf_chain_probe")
    return d_out, e_out, rotations, cycles, in_range
