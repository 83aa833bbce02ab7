"""Single-launch resident merge on the card: wrapper of
``csrc/resident_merge.cu`` (replaces the Pallas TPU kernel
``repro.kernels.resident_merge.resident_merge_pallas_batch``).

One block per merge lane, its O(K) vectors in shared memory, three
phases (roots, weights, columns); see the source for the design.  The
plain version beside it is
``repro_torch.core.secular.secular_merge_resident_batched``: on a CPU
tensor ``kernels.ops`` runs that; on a CUDA tensor it launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.float64: "resident_merge_f64",
       torch.float32: "resident_merge_f32"}

# Dynamic shared memory a Hopper block may use (227 KB).
SMEM_LIMIT = 232448


def smem_bytes(r: int, K: int, dtype) -> int:
    """Shared memory one lane needs: d, z, d[origin], tau, zhat and the r
    rows, K entries each."""
    return (5 + r) * K * torch.empty((), dtype=dtype).element_size()


def _entry(dtype):
    lib = _build.load("resident_merge")
    fn = getattr(lib, _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
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
    fn = _entry(d.dtype)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(z), _build.ptr(R),
                 _build.ptr(rho), _build.ptr(kprime), _build.ptr(origin),
                 _build.ptr(tau), _build.ptr(zhat), _build.ptr(rows),
                 B, r, K, int(niter), int(bool(use_zhat)),
                 _build.stream_ptr(d.device))
    _build.check(err, "resident_merge")
    resident_merge_cuda.launches += 1
    return origin, tau, zhat, rows


resident_merge_cuda.launches = 0
