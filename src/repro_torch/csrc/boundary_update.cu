// Selected-row update of the two-pass conquer for Hopper (sm_90a), any
// number of rows.
//
// Replaces: src/repro/kernels/boundary_update.py::boundary_rows_update_pallas
// (the Pallas TPU kernel _boundary_kernel; grid = root blocks of one
// problem).  Plain version beside it:
// repro_torch.core.secular.boundary_rows_update_batched.
//
// For every lane b and active root j (j < kprime):
//
//   y_ij  = w_i / ((d_i - d_org_j) - tau_j)   over the active poles i,
//   out[q, j] = sum_i R[q, i] y_ij / ||y_.j||
//
// with w the weights (zhat, or z); an active pole whose denominator is
// exactly zero contributes w_i (the JAX package's XLA path; its Pallas
// kernel drops the term).  Deflated columns (j >= kprime) pass R through.
// The K x K block Y is never stored in device memory.
//
// Two tilings, chosen by the number of rows r:
//
//   * r <= 4 (the boundary rows of the BR tree): one thread per root
//     column walks the active poles, staged with their r rows through
//     shared memory in tiles of TILE (a broadcast), and keeps r sums and
//     the squared norm in registers -- the column phase of
//     fused_update.cu.  Bound by FP64 operations: one division and
//     2 + 2r operations per (pole, root) pair.
//   * r > 4 (r = K for the full-vector and lazy-replay baselines): the
//     update is a K x K by K x K product whose right factor Y is made on
//     the fly.  A block of 256 threads owns a BM x BN = 64 x 64 output
//     tile (rows x roots).  Per step of BK = 16 poles it stages the R tile
//     (BM x BK) and builds the y tile (BK x BN, one division per entry)
//     in shared memory, once for all 64 rows of the tile, and each thread
//     accumulates a 4 x 4 register tile with FP64 FMAs.  The first BN
//     threads also sum y^2 for their column in pole order, the order of
//     the r <= 4 path, so every row tile of a column gets the same norm.
//     Bound by FP64 FMAs: r K'^2 per lane, (4/3) N^3 over the tree of an
//     n = N full-vector solve.  Tensor-core DMMA and TMA staging are
//     later work.
//
// Each output element has one writer: no atomics, and a lane's result
// does not depend on the batch it was launched in.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int COL_THREADS = 64;
constexpr int TILE = 256;
constexpr int MAX_R_COL = 4;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TILE_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

// y_ij with the plain version's zero-denominator rule.
template <typename T>
__device__ __forceinline__ T secular_y(T w_i, T d_i, T d_org, T tau_j) {
  const T delta = (d_i - d_org) - tau_j;
  return delta != T(0) ? w_i / delta : w_i;
}

template <typename T>
__global__ void __launch_bounds__(COL_THREADS)
rows_col_kernel(const T* __restrict__ R, const T* __restrict__ d,
                const T* __restrict__ w, const int* __restrict__ origin,
                const T* __restrict__ tau, const int* __restrict__ kprime,
                T* __restrict__ rows, int r, int K) {
  __shared__ T s_d[TILE];
  __shared__ T s_w[TILE];
  __shared__ T s_R[MAX_R_COL][TILE];
  const int b = blockIdx.y;
  const int j = blockIdx.x * COL_THREADS + threadIdx.x;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  const int kp = kprime[b];
  const int js = j < K - 1 ? j : K - 1;
  int o = origin[off + js];
  o = o < K - 1 ? o : K - 1;
  const T d_org = d[off + o];
  const T tau_j = tau[off + js];
  T acc[MAX_R_COL];
  for (int q = 0; q < MAX_R_COL; ++q) acc[q] = T(0);
  T nrm2 = T(0);
  for (int start = 0; start < kp; start += TILE) {
    const int n = kp - start < TILE ? kp - start : TILE;
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += COL_THREADS) {
      const int ii = start + t;
      s_d[t] = d[off + ii];
      s_w[t] = w[off + ii];
      for (int q = 0; q < r; ++q) s_R[q][t] = Rb[(size_t)q * K + ii];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const T y = secular_y(s_w[t], s_d[t], d_org, tau_j);
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
__global__ void __launch_bounds__(TILE_THREADS)
rows_tile_kernel(const T* __restrict__ R, const T* __restrict__ d,
                 const T* __restrict__ w, const int* __restrict__ origin,
                 const T* __restrict__ tau, const int* __restrict__ kprime,
                 T* __restrict__ rows, int r, int K) {
  __shared__ T s_R[BK][BM];        // R tile, pole-major
  __shared__ T s_y[BK][BN];        // y tile, pole-major
  __shared__ T s_dorg[BN];
  __shared__ T s_tau[BN];
  __shared__ T s_nrm[BN];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  // Thread (ty, tx) owns rows row0 + ty + 16 x and columns col0 + tx +
  // 16 y, x, y < 4: a warp reads 16 consecutive entries of a tile row,
  // free of bank conflicts.
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  T* outb = rows + (size_t)b * r * K;
  const int kp = kprime[b];

  if (col0 >= kp) {
    // Every column of the tile is deflated: pass R through.
    for (int e = tid; e < BM * BN; e += TILE_THREADS) {
      const int q = row0 + e / BN, j = col0 + e % BN;
      if (q < r && j < K) outb[(size_t)q * K + j] = Rb[(size_t)q * K + j];
    }
    return;
  }
  if (tid < BN) {
    const int j = col0 + tid;
    const int js = j < K - 1 ? j : K - 1;
    int o = origin[off + js];
    o = o < K - 1 ? o : K - 1;
    s_dorg[tid] = d[off + o];
    s_tau[tid] = tau[off + js];
  }
  T acc[4][4];
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c) acc[a][c] = T(0);
  T nrm2 = T(0);                    // column col0 + tid, for tid < BN
  __syncthreads();

  for (int k0 = 0; k0 < kp; k0 += BK) {
    // Stage the R tile and build the y tile (4 entries of each a thread).
    for (int e = tid; e < BK * BM; e += TILE_THREADS) {
      const int k = e % BK, m = e / BK;      // consecutive threads: poles
      const int i = k0 + k, q = row0 + m;
      s_R[k][m] = (i < kp && q < r) ? Rb[(size_t)q * K + i] : T(0);
    }
    for (int e = tid; e < BK * BN; e += TILE_THREADS) {
      const int k = e / BN, n = e % BN;      // a warp shares one pole
      const int i = k0 + k;
      s_y[k][n] = i < kp ? secular_y(w[off + i], d[off + i], s_dorg[n],
                                     s_tau[n])
                         : T(0);
    }
    __syncthreads();
    if (tid < BN) {
      const int kn = kp - k0 < BK ? kp - k0 : BK;
      for (int k = 0; k < kn; ++k) nrm2 += s_y[k][tid] * s_y[k][tid];
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T a[4], c[4];
      for (int x = 0; x < 4; ++x) a[x] = s_R[k][ty + 16 * x];
      for (int x = 0; x < 4; ++x) c[x] = s_y[k][tx + 16 * x];
      for (int x = 0; x < 4; ++x)
        for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * c[y];
    }
    __syncthreads();
  }
  if (tid < BN) {
    const T nrm = sqrt(nrm2);
    s_nrm[tid] = nrm > T(0) ? nrm : T(1);
  }
  __syncthreads();
  for (int x = 0; x < 4; ++x) {
    const int q = row0 + ty + 16 * x;
    if (q >= r) continue;
    for (int y = 0; y < 4; ++y) {
      const int n = tx + 16 * y, j = col0 + n;
      if (j >= K) continue;
      outb[(size_t)q * K + j] =
          j < kp ? acc[x][y] / s_nrm[n] : Rb[(size_t)q * K + j];
    }
  }
}

template <typename T>
int launch(const T* R, const T* d, const T* w, const int* origin,
           const T* tau, const int* kprime, T* rows, int B, int r, int K,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (r < 1) return (int)cudaErrorInvalidValue;
  if (r <= MAX_R_COL) {
    dim3 grid((K + COL_THREADS - 1) / COL_THREADS, B);
    rows_col_kernel<T><<<grid, COL_THREADS, 0, s>>>(R, d, w, origin, tau,
                                                    kprime, rows, r, K);
  } else {
    dim3 grid((K + BN - 1) / BN, (r + BM - 1) / BM, B);
    rows_tile_kernel<T><<<grid, TILE_THREADS, 0, s>>>(R, d, w, origin, tau,
                                                      kprime, rows, r, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int boundary_update_f64(const double* R, const double* d, const double* w,
                        const int* origin, const double* tau,
                        const int* kprime, double* rows, int B, int r, int K,
                        void* stream) {
  return launch<double>(R, d, w, origin, tau, kprime, rows, B, r, K, stream);
}

int boundary_update_f32(const float* R, const float* d, const float* w,
                        const int* origin, const float* tau,
                        const int* kprime, float* rows, int B, int r, int K,
                        void* stream) {
  return launch<float>(R, d, w, origin, tau, kprime, rows, B, r, K, stream);
}

}  // extern "C"
