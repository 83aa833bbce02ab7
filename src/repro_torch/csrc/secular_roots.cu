// Batched secular root solve for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/secular_roots.py::secular_solve_pallas_batch
// (the Pallas TPU kernel _secular_kernel; grid = problems x root blocks).
// Plain version beside it: repro_torch.core.secular.secular_solve_batched.
//
// What bounds it on this card: FP64 arithmetic.  Each root sweeps all
// kprime active poles niter + 5 times, about six operations (two of them
// divisions) per root and pole per sweep, so a merge does O(niter * K^2)
// work on O(K) bytes: far above the H100's operations-per-byte balance.
// The FP64 divide sequence is the costliest part of each term.
//
// What the design does about it: one thread per root, so every thread
// runs its own iteration with no cross-thread reduction and no atomics
// (each output element has exactly one writer, so batched and looped
// launches give identical results).  The poles and squared weights of a
// problem are staged through shared memory in tiles of POLE_TILE, read by
// every thread of the block at the same address (a broadcast, no bank
// conflicts), so device memory is read once per block per sweep.
//
// Sizes (derived for Hopper, not taken from the TPU kernel): a block is
// ROOTS_PER_BLOCK = 64 threads (two warps) so that the main path's top
// merge, one problem of K = 16384 roots, still spreads over 256 blocks,
// about two per SM of the 132.  A tile of POLE_TILE = 256 poles is 4 KiB
// of shared memory in double precision and takes each thread four loads.
#include "secular_common.cuh"

namespace {

constexpr int ROOTS_PER_BLOCK = 64;
constexpr int POLE_TILE = 256;

template <typename T>
struct TiledPoles {
  const T* d;
  const T* z2;
  int K;
  T* sd;
  T* sz;

  template <class F>
  __device__ void sweep(F f) {
    for (int start = 0; start < K; start += POLE_TILE) {
      const int n = K - start < POLE_TILE ? K - start : POLE_TILE;
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        sd[t] = d[start + t];
        sz[t] = z2[start + t];
      }
      __syncthreads();
      for (int t = 0; t < n; ++t) f(start + t, sd[t], sz[t]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(ROOTS_PER_BLOCK)
secular_roots_kernel(const T* __restrict__ d, const T* __restrict__ z2,
                     const T* __restrict__ rho, const int* __restrict__ kprime,
                     int* __restrict__ origin, T* __restrict__ tau,
                     int K, int niter) {
  __shared__ T sd[POLE_TILE];
  __shared__ T sz[POLE_TILE];
  const int b = blockIdx.y;
  const int j = blockIdx.x * ROOTS_PER_BLOCK + threadIdx.x;
  const T* db = d + (size_t)b * K;
  const T* zb = z2 + (size_t)b * K;
  TiledPoles<T> src{db, zb, K, sd, sz};
  int o;
  T t;
  // Threads past K still run the sweeps: the tile loads synchronise the
  // whole block.  Their results are not written.
  secular::solve_root<T>(
      j, K, kprime[b], rho[b], niter, src,
      [&](int i) { return db[i]; }, [&](int i) { return zb[i]; }, &o, &t);
  if (j < K) {
    origin[(size_t)b * K + j] = o;
    tau[(size_t)b * K + j] = t;
  }
}

template <typename T>
int launch(const T* d, const T* z2, const T* rho, const int* kprime,
           int* origin, T* tau, int B, int K, int niter, void* stream) {
  dim3 grid((K + ROOTS_PER_BLOCK - 1) / ROOTS_PER_BLOCK, B);
  secular_roots_kernel<T><<<grid, ROOTS_PER_BLOCK, 0,
                            (cudaStream_t)stream>>>(
      d, z2, rho, kprime, origin, tau, K, niter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int secular_roots_f64(const double* d, const double* z2, const double* rho,
                      const int* kprime, int* origin, double* tau, int B,
                      int K, int niter, void* stream) {
  return launch<double>(d, z2, rho, kprime, origin, tau, B, K, niter, stream);
}

int secular_roots_f32(const float* d, const float* z2, const float* rho,
                      const int* kprime, int* origin, float* tau, int B,
                      int K, int niter, void* stream) {
  return launch<float>(d, z2, rho, kprime, origin, tau, B, K, niter, stream);
}

}  // extern "C"
