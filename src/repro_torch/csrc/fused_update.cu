// Fused conquer post-pass for Hopper (sm_90a): Gu-Eisenstat weights zhat
// and the r selected-row update of one merge level.
//
// Replaces: src/repro/kernels/fused_update.py::secular_postpass_pallas_batch
// (the Pallas TPU kernel _fused_kernel; grid = problems x pole blocks).
// Plain version beside it: repro_torch.core.secular.secular_postpass_batched.
//
// The TPU kernel depends on its grid running in order: the first pole
// block zeroes the column accumulators (pl.when(i == 0)), every block adds
// its poles' contribution to every root column, and the last block
// normalises.  A CUDA grid has no order, so the work splits into two
// passes launched back to back on one stream:
//
//   pass A (pole-major): one thread per pole i takes its weight
//     zhat_i = sign(z_i) sqrt(|prod_j (lam_j - d_i) / (d_j - d_i)
//              * (lam_i - d_i)| / rho)
//     over all active roots j != i (DLAED3's ratio-product form, sign(0)
//     = 0; factors and product as secular::weight_factor and
//     weight_z2) and writes it;
//   pass B (root-major): one thread per root column j sums over all
//     active poles i, y_ij = zhat_i / ((d_i - d_org_j) - tau_j), the r rows
//     sum_i R[:, i] y_ij and ||y_.j||^2, then normalises its own column.
//
// Each output element has exactly one writer, so there are no atomics and
// the result does not depend on the grid.
//
// What bounds it on this card: FP64 arithmetic, O(K^2) terms with one
// division each (pass A about five operations per term, pass B 5 + 2r) on
// O(r K) bytes.  The operand vectors of the other axis (roots for pass A,
// poles and their r rows for pass B) are staged through shared memory in
// tiles of TILE and read at one address by the whole block (broadcast).
// Sizes as in secular_roots.cu: 64-thread blocks keep a single K = 8192
// problem on 128 blocks.
#include "secular_common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int TILE = 256;
constexpr int MAX_R = 4;

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// Pass A: weights.  zhat[b, i] for every pole; deflated poles keep z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
zhat_kernel(const T* __restrict__ d, const T* __restrict__ z,
            const int* __restrict__ origin, const T* __restrict__ tau,
            const T* __restrict__ rho, const int* __restrict__ kprime,
            T* __restrict__ zhat, int K, int use_zhat) {
  __shared__ T s_dorg[TILE];
  __shared__ T s_tau[TILE];
  __shared__ T s_d[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const size_t off = (size_t)b * K;
  const int kp = kprime[b];
  const int is = i < K - 1 ? i : K - 1;
  const T d_i = d[off + is];
  double prod = 1.0;
  int floored = 0;
  // Only the kp active roots enter the product.
  for (int start = 0; start < kp; start += TILE) {
    const int n = kp - start < TILE ? kp - start : TILE;
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int jj = start + t;
      int o = origin[off + jj];
      o = o < K - 1 ? o : K - 1;
      s_dorg[t] = d[off + o];
      s_tau[t] = tau[off + jj];
      s_d[t] = d[off + jj];
    }
    __syncthreads();
    if (use_zhat) {
      for (int t = 0; t < n; ++t) {
        if (start + t == is) continue;
        prod *= secular::weight_factor<T>((s_dorg[t] - d_i) + s_tau[t],
                                          s_d[t] - d_i, floored);
      }
    }
  }
  if (i >= K) return;
  const T z_i = z[off + i];
  T out = z_i;
  if (use_zhat && i < kp) {
    int o = origin[off + i];
    o = o < K - 1 ? o : K - 1;
    // lam_i - d_i
    const double z2 = secular::weight_z2<T>(
        prod, (d[off + o] - d_i) + tau[off + i], (double)rho[b], floored);
    out = sign_of(z_i) * (T)sqrt(z2);
  }
  zhat[off + i] = out;
}

// Pass B: one root column per thread.  Deflated columns pass R through.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ R, const T* __restrict__ d,
            const int* __restrict__ origin, const T* __restrict__ tau,
            const int* __restrict__ kprime, const T* __restrict__ zhat,
            T* __restrict__ rows, int r, int K) {
  __shared__ T s_d[TILE];
  __shared__ T s_w[TILE];
  __shared__ T s_R[MAX_R][TILE];
  const int b = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  const int kp = kprime[b];
  const int js = j < K - 1 ? j : K - 1;
  int o = origin[off + js];
  o = o < K - 1 ? o : K - 1;
  const T d_org = d[off + o];
  const T tau_j = tau[off + js];
  T acc[MAX_R];
  for (int q = 0; q < MAX_R; ++q) acc[q] = T(0);
  T nrm2 = T(0);
  // Only the kp active poles carry weight.
  for (int start = 0; start < kp; start += TILE) {
    const int n = kp - start < TILE ? kp - start : TILE;
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int ii = start + t;
      s_d[t] = d[off + ii];
      s_w[t] = zhat[off + ii];
      for (int q = 0; q < r; ++q) s_R[q][t] = Rb[(size_t)q * K + ii];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const T delta = (s_d[t] - d_org) - tau_j;
      // An exact zero denominator divides by 1, as the plain version does.
      const T y = delta != T(0) ? s_w[t] / delta : s_w[t];
      for (int q = 0; q < r; ++q) acc[q] += s_R[q][t] * y;
      nrm2 += y * y;
    }
  }
  if (j >= K) return;
  T* rb = rows + (size_t)b * r * K;
  if (j < kp) {
    const T nrm = sqrt(nrm2);
    const T scale = nrm > T(0) ? nrm : T(1);
    for (int q = 0; q < r; ++q) rb[(size_t)q * K + j] = acc[q] / scale;
  } else {
    for (int q = 0; q < r; ++q) rb[(size_t)q * K + j] = Rb[(size_t)q * K + j];
  }
}

template <typename T>
int launch(const T* R, const T* d, const T* z, const int* origin,
           const T* tau, const int* kprime, const T* rho, T* zhat, T* rows,
           int B, int r, int K, int use_zhat, void* stream) {
  if (r < 1 || r > MAX_R) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((K + THREADS - 1) / THREADS, B);
  zhat_kernel<T><<<grid, THREADS, 0, s>>>(d, z, origin, tau, rho, kprime,
                                          zhat, K, use_zhat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_kernel<T><<<grid, THREADS, 0, s>>>(R, d, origin, tau, kprime, zhat,
                                          rows, r, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_update_f64(const double* R, const double* d, const double* z,
                     const int* origin, const double* tau, const int* kprime,
                     const double* rho, double* zhat, double* rows, int B,
                     int r, int K, int use_zhat, void* stream) {
  return launch<double>(R, d, z, origin, tau, kprime, rho, zhat, rows, B, r,
                        K, use_zhat, stream);
}

int fused_update_f32(const float* R, const float* d, const float* z,
                     const int* origin, const float* tau, const int* kprime,
                     const float* rho, float* zhat, float* rows, int B,
                     int r, int K, int use_zhat, void* stream) {
  return launch<float>(R, d, z, origin, tau, kprime, rho, zhat, rows, B, r,
                       K, use_zhat, stream);
}

}  // extern "C"
