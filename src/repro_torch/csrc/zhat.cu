// Gu-Eisenstat weight reconstruction of the two-pass conquer for Hopper
// (sm_90a), in log space (LAPACK DLAED3's stable weights).
//
// Replaces: src/repro/kernels/zhat.py::zhat_reconstruct_pallas (the Pallas
// TPU kernel _zhat_kernel; grid = pole blocks of one problem).
// Plain version beside it:
// repro_torch.core.secular.zhat_reconstruct_batched.
//
// For every active pole i of lane b, over the kprime active roots j:
//
//   log_num_i = sum_j       log max(|(d_org_j - d_i) + tau_j|, tiny)
//   log_den_i = sum_{j != i} log max(|d_j - d_i|, tiny)
//   zhat_i    = sign(z_i) sqrt(exp(log_num_i - log_den_i) / rho)
//
// and inactive poles pass z through.  The differences are formed in the
// input type T, their logs and sums in double (float's 24 bits would lose
// a few percent of zhat in a sum of thousands of logs; for T = double
// nothing changes).
//
// The TPU kernel holds a (POLE_BLOCK, ROOT_TILE) slab of differences in
// VMEM and reduces it on the VPU.  Here one thread owns one pole and
// carries its two sums in registers; the roots' d[origin], tau and the
// poles d of a lane are staged through shared memory in tiles of TILE
// (3 x 512 x 8 = 12 KiB in double) and read at one address by the whole
// block (a broadcast).  Each output has one writer: no atomics, and a
// lane's result does not depend on the batch it was launched in.
//
// What bounds it on this card: FP64 arithmetic -- two logs and three
// subtractions per (pole, root) pair, 2 K'^2 logs per lane, on O(K)
// bytes.  A double log is a polynomial of some twenty FP64 operations, so
// the count of logs, not memory, sets the time.  64-thread blocks: a
// single K = 8192 lane runs on 128 blocks, about one per SM.
#include "secular_common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int TILE = 512;

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
zhat_log_kernel(const T* __restrict__ d, const T* __restrict__ z,
                const int* __restrict__ origin, const T* __restrict__ tau,
                const T* __restrict__ rho, const int* __restrict__ kprime,
                T* __restrict__ zhat, int K) {
  __shared__ T s_dorg[TILE];
  __shared__ T s_tau[TILE];
  __shared__ T s_d[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const size_t off = (size_t)b * K;
  const int kp = kprime[b];
  const int is = i < K - 1 ? i : K - 1;
  const T d_i = d[off + is];
  double log_num = 0.0, log_den = 0.0;
  // Only the kp active roots enter the sums; every thread of the block
  // takes part in the tile loads.
  for (int start = 0; start < kp; start += TILE) {
    const int n = kp - start < TILE ? kp - start : TILE;
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const int jj = start + t;
      int o = origin[off + jj];
      o = o < K - 1 ? o : K - 1;
      s_dorg[t] = d[off + o];
      s_tau[t] = tau[off + jj];
      s_d[t] = d[off + jj];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      log_num += log((double)secular::floor_abs<T>((s_dorg[t] - d_i) +
                                                   s_tau[t]));
      if (start + t != is)
        log_den += log((double)secular::floor_abs<T>(s_d[t] - d_i));
    }
  }
  if (i >= K) return;
  const T z_i = z[off + i];
  T out = z_i;
  if (i < kp) {
    const double z2 = exp(log_num - log_den) / (double)rho[b];
    out = sign_of(z_i) * (T)sqrt(z2 < 0.0 ? 0.0 : z2);
  }
  zhat[off + i] = out;
}

template <typename T>
int launch(const T* d, const T* z, const int* origin, const T* tau,
           const T* rho, const int* kprime, T* zhat, int B, int K,
           void* stream) {
  dim3 grid((K + THREADS - 1) / THREADS, B);
  zhat_log_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      d, z, origin, tau, rho, kprime, zhat, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int zhat_f64(const double* d, const double* z, const int* origin,
             const double* tau, const double* rho, const int* kprime,
             double* zhat, int B, int K, void* stream) {
  return launch<double>(d, z, origin, tau, rho, kprime, zhat, B, K, stream);
}

int zhat_f32(const float* d, const float* z, const int* origin,
             const float* tau, const float* rho, const int* kprime,
             float* zhat, int B, int K, void* stream) {
  return launch<float>(d, z, origin, tau, rho, kprime, zhat, B, K, stream);
}

}  // extern "C"
