#!/usr/bin/env python3
"""Measure the FP64 tensor-core (DMMA) rate of each ``mma.sync`` f64 shape
on one CUDA card, and check the fragment layout of the m16n8k* shapes.

    python3 scripts/dmma_rate.py

Why: the row update's tensor-core path (``csrc/boundary_update.cu``) takes
the shape that reaches the card's DMMA rate.  Each warp of 132 x
{1, 2, 4} blocks of 8 warps issues 16 independent accumulations of one
shape in a loop of 4096 steps, on registers only; the rate is the
operations (2 M N K per instruction) over the time between CUDA events,
median of 5.  The layout check multiplies a 16 x K by a K x 8 matrix with
one instruction, its fragments loaded as the row update loads them
(lane (g, t) = (lane / 4, lane % 4) holds A rows g, g + 8 at columns
t + 4i, B rows t + 4i at column g), and compares with torch.matmul.  The
source is built with nvcc for sm_90a into build/dmma_rate/.  Every line
printed is one JSON object with the card's name and power limit.  It
shares its timing (CUDA events, median of 5 after a warm-up) with
``scripts/time_merge_kernels.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

from time_merge_kernels import card, median_ms

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "..", "build", "dmma_rate")

# (name, M, N, K) of each shape, by the index the source's templates take.
SHAPES = {0: ("m8n8k4", 8, 8, 4), 1: ("m16n8k4", 16, 8, 4),
          2: ("m16n8k8", 16, 8, 8), 3: ("m16n8k16", 16, 8, 16)}

SOURCE = r"""
#include <cuda_runtime.h>
template <int S> struct Sh;
template <> struct Sh<0> { static constexpr int NA = 1, NB = 1, NC = 2; };
template <> struct Sh<1> { static constexpr int NA = 2, NB = 1, NC = 4; };
template <> struct Sh<2> { static constexpr int NA = 4, NB = 2, NC = 4; };
template <> struct Sh<3> { static constexpr int NA = 8, NB = 4, NC = 4; };
template <int S>
__device__ __forceinline__ void mma(double* c, const double* a,
                                    const double* b) {
  if (S == 0)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1},{%2},{%3},{%0,%1};"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  if (S == 1)
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3},{%4,%5},{%6},{%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  if (S == 2)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                   "d"(b[1]));
  if (S == 3)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3},{%4,%5,%6,%7,%8,%9,%10,%11},"
                 "{%12,%13,%14,%15},{%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                   "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                   "d"(b[2]), "d"(b[3]));
}
template <int S>
__global__ void __launch_bounds__(256) rate(double* out, int iters) {
  double a[Sh<S>::NA], b[Sh<S>::NB], c[16][Sh<S>::NC];
  for (int i = 0; i < Sh<S>::NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < Sh<S>::NB; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int t = 0; t < 16; ++t)
    for (int i = 0; i < Sh<S>::NC; ++i) c[t][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t) mma<S>(c[t], a, b);
  }
  double s = 0;
  for (int t = 0; t < 16; ++t)
    for (int i = 0; i < Sh<S>::NC; ++i) s += c[t][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int S, int K>
__global__ void layout(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[Sh<S>::NA], b[Sh<S>::NB], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < Sh<S>::NA; ++i)
    a[i] = A[(g + 8 * (i & 1)) * K + t + 4 * (i >> 1)];
  for (int i = 0; i < Sh<S>::NB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  mma<S>(c, a, b);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}
extern "C" {
int run_rate(int s, double* out, int blocks, int iters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s == 0) rate<0><<<blocks, 256, 0, st>>>(out, iters);
  if (s == 1) rate<1><<<blocks, 256, 0, st>>>(out, iters);
  if (s == 2) rate<2><<<blocks, 256, 0, st>>>(out, iters);
  if (s == 3) rate<3><<<blocks, 256, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
int run_layout(int s, const double* A, const double* B, double* C) {
  if (s == 1) layout<1, 4><<<1, 32>>>(A, B, C);
  if (s == 2) layout<2, 8><<<1, 32>>>(A, B, C);
  if (s == 3) layout<3, 16><<<1, 32>>>(A, B, C);
  return (int)cudaGetLastError();
}
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dmma_rate: no CUDA device visible", file=sys.stderr)
        return 2
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "dmma_rate.cu")
    lib_path = os.path.join(BUILD, "libdmma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.run_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.run_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    dev = torch.device("cuda", 0)
    smi = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    iters = 4096
    for s, (name, M, N, K) in SHAPES.items():
        for per_sm in (1, 2, 4):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, dtype=torch.float64, device=dev)
            ms = median_ms(lambda: lib.run_rate(
                s, ctypes.c_void_p(out.data_ptr()), blocks, iters, stream))
            ops = blocks * 8 * iters * 16 * 2 * M * N * K
            print(json.dumps(dict(shape=name, blocks_per_sm=per_sm, ms=ms,
                                  tflops=ops / (ms * 1e-3) / 1e12,
                                  card=smi)), flush=True)
    for s in (1, 2, 3):
        name, K = SHAPES[s][0], SHAPES[s][3]
        A = torch.randn(16, K, dtype=torch.float64, device=dev)
        B = torch.randn(K, 8, dtype=torch.float64, device=dev)
        C = torch.zeros(16, 8, dtype=torch.float64, device=dev)
        lib.run_layout(s, ctypes.c_void_p(A.data_ptr()),
                       ctypes.c_void_p(B.data_ptr()),
                       ctypes.c_void_p(C.data_ptr()))
        torch.cuda.synchronize()
        print(json.dumps(dict(shape=name, layout_max_abs_err=float(
            (C - A @ B).abs().max()), card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
