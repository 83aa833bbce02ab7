"""Selected-row update of the two-pass conquer on the card, any number of
rows: wrapper of ``csrc/boundary_update.cu`` (replaces the Pallas TPU
kernel ``repro.kernels.boundary_update.boundary_rows_update_pallas``).

Three paths, chosen by :func:`launch_shape` from the row count and dtype:
"team" for r <= 4 (a team of lanes per root column, poles streamed
through a shared-memory ring), "mma" for r > 4 in float64 (128 x 128
output tiles on the FP64 tensor cores, the secular vectors built in
shared memory; a first launch of the team kernel sums the column norms),
"simt" for r > 4 in float32 (64 x 64 tiles of FMAs); see the source for
the design.  The plain version beside it is
``repro_torch.core.secular.boundary_rows_update_batched``: on a CPU
tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this
kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "boundary_update_f64",
       torch.float32: "boundary_update_f32"}
_PATH_CODE = {"team": 0, "mma": 1, "simt": 2}

# Dynamic shared memory a Hopper block may use (227 KB), and CUDA's grid
# limits (x, y, z).
SMEM_LIMIT = 232448
GRID_LIMIT = (2**31 - 1, 65535, 65535)

# Compiled into csrc/boundary_update.cu (and TEAM into
# csrc/secular_common.cuh); the kernel refuses a launch shape that
# disagrees.
TEAM = 8
MAX_R_COL = 4
COL_THREADS = 256
COL_TILE = 256
COL_STAGES = 3
MMA_BM = 128
MMA_BN = 128
MMA_BK = 32
MMA_LDK = MMA_BK + 4
MMA_STAGES = 3
MMA_THREADS = 512
BM = 64
BN = 64
BK = 16
TILE_THREADS = 256


class LaunchShape(NamedTuple):
    path: str        # "team" (r <= 4), "mma" (r > 4, f64), "simt" (r > 4, f32)
    tile_rows: int   # output rows of one block
    tile_cols: int   # root columns of one block
    tile_poles: int  # poles per pipeline stage
    team: int        # lanes per root column ("team"; 0 otherwise)
    stages: int      # pipeline stages (1: staged without a ring)
    threads: int     # threads of one block
    smem: int        # dynamic shared memory of one block, bytes
    grid: tuple      # (x, y, z) blocks


def launch_shape(B: int, r: int, K: int, dtype) -> LaunchShape:
    """The path and launch of a row update of B lanes, r rows, K roots.

    r <= 4 takes a team per column, COL_THREADS / TEAM columns a block,
    grid (columns, B); larger r takes output tiles, grid (root tiles, row
    tiles, B): 128 x 128 on the FP64 tensor cores in float64, 64 x 64 SIMT
    tiles in float32.  (The "mma" path's first launch, the column norms,
    is the team kernel's shape with no rows.)  A function of its arguments
    only: a lane's results depend on the path, never on B."""
    item = torch.empty((), dtype=dtype).element_size()
    if r <= MAX_R_COL:
        cols = COL_THREADS // TEAM
        return LaunchShape("team", r, cols, COL_TILE, TEAM, COL_STAGES,
                           COL_THREADS,
                           COL_STAGES * COL_TILE * (2 + r) * item,
                           (-(-K // cols), B, 1))
    if dtype == torch.float64:
        smem = (MMA_STAGES * MMA_BM * MMA_LDK + 2 * MMA_BN * MMA_LDK
                + MMA_STAGES * 2 * MMA_BK + 3 * MMA_BN) * item
        return LaunchShape("mma", MMA_BM, MMA_BN, MMA_BK, 0, MMA_STAGES,
                           MMA_THREADS, smem,
                           (-(-K // MMA_BN), -(-r // MMA_BM), B))
    return LaunchShape("simt", BM, BN, BK, 0, 1, TILE_THREADS, 0,
                       (-(-K // BN), -(-r // BM), B))


def _entry(dtype):
    fn = getattr(_build.load("boundary_update"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
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
    rows = torch.empty((B, r, K), dtype=d.dtype, device=d.device)
    if B == 0 or r == 0 or K == 0:
        return rows
    shape = launch_shape(B, r, K, d.dtype)
    if any(g > lim for g, lim in zip(shape.grid, GRID_LIMIT)):
        raise ValueError(f"B={B}, r={r}, K={K} needs a grid of {shape.grid} "
                         f"blocks, over CUDA's limits {GRID_LIMIT}")
    # The "mma" path's column divisors (B, K), written by its first launch.
    scale = (torch.empty((B, K), dtype=d.dtype, device=d.device)
             if shape.path == "mma" else rows)
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(R), _build.ptr(d), _build.ptr(z),
                 _build.ptr(origin), _build.ptr(tau), _build.ptr(kprime),
                 _build.ptr(rows), _build.ptr(scale), B, r, K,
                 _PATH_CODE[shape.path], *shape.grid, shape.threads,
                 shape.smem, _build.stream_ptr(d.device))
    _build.check(err, "boundary_update")
    boundary_rows_update_cuda.launches += 1
    return rows


boundary_rows_update_cuda.launches = 0
