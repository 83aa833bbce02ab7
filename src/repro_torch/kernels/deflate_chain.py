"""The DLAED2 close-pole deflation chain of a merge level on the card:
wrapper of ``csrc/deflate_chain.cu``.  It replaces no Pallas kernel: the
JAX package runs the chain as XLA scans (``repro.core.merge.
_close_pole_scan`` and ``_deflate_apply``), which in eager PyTorch are
some twenty launches a step.

One warp per merge lane decides the rotations: it tests 32 poles against
their predecessors at once, takes the first rotation that fires and
restarts after it.  R's rows take the rotations by one of two routes,
chosen by :func:`launch_shape` from the row count: "fused" for
r < ``SPLIT_MIN_R`` (the deciding warp rotates R's two columns at each
rotation) and "split" (the warp writes the lane's rotation list while the
launch's other blocks copy R; a second launch applies the list to every
row and share of the lane's cascades at once); see the source for the
design.  The plain version beside it is
``repro_torch.core.merge._close_pole_scan``: on a CPU tensor
``kernels.ops`` runs that; on a CUDA tensor it launches this kernel,
whose result equals the plain chain run on the card bit for bit on
either route.  :func:`chain_probe_cuda` times one dependent step of the
chain on one warp with its operands in registers: the chain bound of a
level.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "deflate_chain_f64", torch.float32: "deflate_chain_f32"}
_ROUTE_CODE = {"fused": 0, "split": 1}

# CUDA's grid limits (x, y, z).
GRID_LIMIT = (2**31 - 1, 65535, 65535)

# Compiled into csrc/deflate_chain.cu; the source refuses a launch shape
# that disagrees.
WARPS = 4              # merge lanes (warps) a block of the chain launch
APPLY_THREADS = 128    # rows a block of the split route's application
MAX_SEGMENTS = 64      # cascade segments a row, at most

# Rows from which the split route runs, and the threads its application
# aims for (segments = the least power of two that gives W * r *
# segments this many), measured on the card with ``python3
# scripts/time_merge_kernels.py --kernels chain --sweep``: from r = 32
# the split route beat the fused one on every lane that rotates (W = 1 x
# K = 4096, W = 2 x 2048, W = 8 x 512, W = 64 x 2048 glued lanes) and
# lost 0.014-0.02 ms on one that does not (W = 1 x K = 16384 uniform,
# the cost of its second launch); below it the two tied on the K = 512
# lanes.  The main path's rows (2, 3) stay fused.  About 16k threads
# (4 segments at r = K = 4096) ran the r = K levels fastest.  The most
# blocks of the chain launch that copy R: 8 a streaming multiprocessor
# of an H100.
SPLIT_MIN_R = 32
APPLY_TARGET = 1 << 14
COPY_BLOCKS = 1056


class LaunchShape(NamedTuple):
    route: str          # "fused" (r < SPLIT_MIN_R) or "split"
    threads: int        # threads a block of the chain launch
    chain_blocks: int   # blocks of the chain launch that run merge lanes
    copy_blocks: int    # its blocks that copy R ("split"; 0 otherwise)
    apply_threads: int  # threads a block of the application (0: "fused")
    apply_grid: tuple   # (W, row tiles, segments) ((0, 0, 0): "fused")


def launch_shape(W: int, r: int, K: int, dtype) -> LaunchShape:
    """The route and launches of the chain of W lanes of K poles, r rows.

    The chain launch has a warp a lane, WARPS lanes a block.  r below
    SPLIT_MIN_R takes the fused route.  Otherwise the chain launch also
    has up to COPY_BLOCKS blocks that copy R (four 16-byte words a thread
    a pass), and the application a thread per (lane, row, segment),
    APPLY_THREADS rows a block, with as many segments (a power of two, at
    most MAX_SEGMENTS and K / 2, the most cascades a lane can have) as
    bring W * r * segments to APPLY_TARGET.  A function of its arguments
    only: a lane's bits do not depend on the route or the shape."""
    return _shape(W, r, K, dtype, "fused" if r < SPLIT_MIN_R else "split")


def _shape(W, r, K, dtype, route, segments=None):
    """:func:`launch_shape` on a given route, with ``segments`` forced
    (the tests and the timing sweep take both routes at any r)."""
    chain_blocks = -(-W // WARPS)
    if route == "fused":
        return LaunchShape("fused", WARPS * 32, chain_blocks, 0, 0,
                           (0, 0, 0))
    item = torch.empty((), dtype=dtype).element_size()
    copy_blocks = max(1, min(COPY_BLOCKS,
                             -(-W * r * K * item // (16 * 4 * WARPS * 32))))
    if segments is None:
        segments = 1
        cap = min(MAX_SEGMENTS, max(1, K // 2))
        while segments < cap and W * r * segments < APPLY_TARGET:
            segments *= 2
    return LaunchShape("split", WARPS * 32, chain_blocks, copy_blocks,
                       APPLY_THREADS, (W, -(-r // APPLY_THREADS), segments))


def _entry(dtype):
    fn = getattr(_build.load("deflate_chain"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(d, z, R, small, tol, shape):
    """Both launches of ``shape`` (any route and segment count the source
    takes: the same bits); returns (d, z, R, deflated)."""
    W, K = d.shape
    r = R.shape[1]
    for grid in ((shape.chain_blocks + shape.copy_blocks, 1, 1),
                 shape.apply_grid):
        if any(g > lim for g, lim in zip(grid, GRID_LIMIT)):
            raise ValueError(f"W={W}, r={r}, K={K} needs a grid of {grid} "
                             f"blocks, over CUDA's limits {GRID_LIMIT}")
    d_out = torch.empty_like(d)
    z_out = torch.empty_like(z)
    defl = torch.empty_like(small)
    split = shape.route == "split"
    if split:
        R_out = torch.empty_like(R)
        pf = torch.empty((W, K, 2), dtype=torch.int32, device=d.device)
        cs = torch.empty((W, K, 2), dtype=d.dtype, device=d.device)
        starts = torch.empty((W, K), dtype=torch.int32, device=d.device)
        counts = torch.empty((W, 2), dtype=torch.int32, device=d.device)
        lists = [_build.ptr(t) for t in (pf, cs, starts, counts)]
    else:
        R_out = R.clone()                 # rotated in place by the chain
        lists = [ctypes.c_void_p(0)] * 4
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(small),
                 _build.ptr(tol), _build.ptr(d_out), _build.ptr(z_out),
                 _build.ptr(defl), _build.ptr(R), _build.ptr(R_out), *lists,
                 W, r, K, _ROUTE_CODE[shape.route], shape.threads,
                 shape.chain_blocks, shape.copy_blocks, shape.apply_threads,
                 shape.apply_grid[1], shape.apply_grid[2],
                 _build.stream_ptr(d.device))
    _build.check(err, "deflate_chain")
    deflate_chain_cuda.launches += 1
    if split:
        deflate_chain_cuda.apply_launches += 1
    return d_out, z_out, R_out, defl


def deflate_chain_cuda(d, z, R, small, tol):
    """Launch the chain: d, z (W, K) sorted poles and z entries (z-small
    entries zeroed); R (W, r, K), any r; small (W, K) bool; tol (W,) of
    d's dtype.  Returns new (d, z, R, deflated (W, K) bool), the inputs
    untouched.  ``launches`` counts calls (one a merge level),
    ``apply_launches`` the split route's second launches."""
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
    if W == 0 or K == 0:
        return d.clone(), z.clone(), R.clone(), small.clone()
    return _launch(d, z, R, small, tol,
                   launch_shape(W, R.shape[1], K, d.dtype))


deflate_chain_cuda.launches = 0
deflate_chain_cuda.apply_launches = 0


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
