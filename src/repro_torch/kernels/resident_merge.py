"""Single-launch resident merge on the card: wrapper of
``csrc/resident_merge.cu`` (replaces the Pallas TPU kernel
``repro.kernels.resident_merge.resident_merge_pallas_batch``).

One thread-block cluster of C CTAs per merge lane, teams of lanes per
root, the lane's O(K) vectors in each CTA's shared memory and shared
across the cluster, three phases (roots, weights, columns); see the
source for the design.  :func:`launch_shape` picks C and the CTA size
from the launch's shape alone.  The plain version beside it is
``repro_torch.core.secular.secular_merge_resident_batched``: on a CPU
tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "resident_merge_f64",
       torch.float32: "resident_merge_f32"}
_OCCUPANCY = {torch.float64: "resident_merge_max_clusters_f64",
              torch.float32: "resident_merge_max_clusters_f32"}

# Dynamic shared memory a Hopper block may use (227 KB).
SMEM_LIMIT = 232448

# Compiled into csrc/resident_merge.cu and csrc/secular_common.cuh; the
# kernel refuses a launch whose team size or CTA size disagrees.
TEAM = 8
MAX_THREADS = 256
MAX_CLUSTER = 16
# Fewest roots a CTA is given: below this a cluster would split a lane
# finer than one root per team of a MAX_THREADS CTA.
MIN_ROOTS_PER_CTA = 32
# CTAs per SM beyond which a level is not split further: enough small
# CTAs to spread over the SMs, and each more CTA repeats the fixed cost of
# loading the lane and of the cluster barriers.
CTAS_PER_SM = 8


class LaunchShape(NamedTuple):
    team: int      # lanes that solve one root together
    cluster: int   # CTAs that merge one lane (C)
    threads: int   # threads of one CTA
    smem: int      # dynamic shared memory of one CTA, bytes


def smem_bytes(r: int, K: int, dtype) -> int:
    """Shared memory one CTA needs: d, z (then zhat), d[origin], tau and
    the r rows, K entries each."""
    return (4 + r) * K * torch.empty((), dtype=dtype).element_size()


def launch_shape(B: int, K: int, r: int, dtype, sm_count: int) -> LaunchShape:
    """The cluster and CTA size for B lanes of K roots with r rows.

    C is the largest power of two that is at most MAX_CLUSTER, at most
    K / MIN_ROOTS_PER_CTA (so a CTA never gets fewer roots than that) and,
    unless that leaves C = 1, keeps B * C <= CTAS_PER_SM * sm_count: split
    a level's lanes as finely as K allows while a level has few lanes
    (many small CTAs spread over the card's SMs and its GPCs, whose
    cluster capacity is uneven, better than a few that nearly fill it),
    not at all once it has thousands.  The CTA gets one team per root of
    its share, rounded up to whole warps, at most MAX_THREADS threads.  A
    function of its arguments only: a lane's results do not depend on it,
    only its speed does.
    """
    cap = max(1, min(MAX_CLUSTER, K // MIN_ROOTS_PER_CTA))
    C = 1
    while 2 * C <= cap and B * 2 * C <= CTAS_PER_SM * sm_count:
        C *= 2
    share = -(-K // C)
    threads = min(MAX_THREADS, -(-share * TEAM // 32) * 32)
    return LaunchShape(TEAM, C, threads, smem_bytes(r, K, dtype))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_active_clusters(index: int, dtype, r: int, K: int,
                        shape: LaunchShape) -> int:
    """cudaOccupancyMaxActiveClusters for this shape on card ``index``."""
    lib = _build.load("resident_merge")
    fn = getattr(lib, _OCCUPANCY[dtype])
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(r, K, shape.cluster, shape.threads, shape.team,
                 ctypes.cast(ctypes.pointer(out), ctypes.c_void_p))
    _build.check(err, "resident_merge occupancy")
    return out.value


def _entry(dtype):
    lib = _build.load("resident_merge")
    fn = getattr(lib, _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resident_merge_cuda(d, z, R, rho, kprime, *, niter: int,
                        use_zhat: bool = True):
    """Launch the resident merge: d, z (B, K); R (B, r, K) with r <= 4;
    rho (B,) of d's dtype; kprime (B,) int32.  Returns (origin (B, K)
    int32, tau (B, K), zhat (B, K), rows (B, r, K))."""
    B, r, K = R.shape
    _build.check_operands(d, z, R, rho, kprime)
    if d.shape != (B, K) or z.shape != (B, K):
        raise ValueError(f"d and z must be {(B, K)}")
    if kprime.shape != (B,) or rho.shape != (B,):
        raise ValueError("kprime and rho must be (B,)")
    if not 1 <= r <= 4:
        raise ValueError(f"the resident kernel takes 1 to 4 rows, got {r}")
    if any(t.dtype != d.dtype for t in (z, R, rho)):
        raise TypeError("z, R and rho must have d's dtype")
    if kprime.dtype != torch.int32:
        raise TypeError("kprime must be int32")
    if smem_bytes(r, K, d.dtype) > SMEM_LIMIT:
        raise ValueError(
            f"K={K} with r={r} needs {smem_bytes(r, K, d.dtype)} bytes of "
            f"shared memory, over the {SMEM_LIMIT}-byte block limit; lower "
            f"resident_threshold")
    origin = torch.empty((B, K), dtype=torch.int32, device=d.device)
    tau = torch.empty((B, K), dtype=d.dtype, device=d.device)
    zhat = torch.empty((B, K), dtype=d.dtype, device=d.device)
    rows = torch.empty((B, r, K), dtype=d.dtype, device=d.device)
    if B == 0 or K == 0:
        return origin, tau, zhat, rows
    index = d.device.index
    shape = launch_shape(B, K, r, d.dtype, sm_count(index))
    if max_active_clusters(index, d.dtype, r, K, shape) < 1:
        raise RuntimeError(
            f"resident_merge: a cluster of {shape.cluster} CTAs of "
            f"{shape.threads} threads and {shape.smem} bytes of shared "
            f"memory cannot be scheduled on this card")
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(R),
                 _build.ptr(rho), _build.ptr(kprime), _build.ptr(origin),
                 _build.ptr(tau), _build.ptr(zhat), _build.ptr(rows),
                 B, r, K, int(niter), int(bool(use_zhat)), shape.cluster,
                 shape.threads, shape.team, _build.stream_ptr(d.device))
    _build.check(err, "resident_merge")
    resident_merge_cuda.launches += 1
    return origin, tau, zhat, rows


resident_merge_cuda.launches = 0
