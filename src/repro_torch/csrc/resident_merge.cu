// Single-launch resident merge for Hopper (sm_90a): the whole small-K
// merge of one lane -- secular root solve, Gu-Eisenstat weights and the
// r selected-row update -- in one block, with every O(K) vector kept in
// shared memory between the phases.
//
// Replaces: src/repro/kernels/resident_merge.py::resident_merge_pallas_batch
// (the Pallas TPU kernel _resident_kernel; grid = problems).
// Plain version beside it:
// repro_torch.core.secular.secular_merge_resident_batched.
//
// The TPU kernel holds a dense (K, K) delta tile in VMEM, about 2 MiB at
// K = 512 in f64.  That does not fit a Hopper block's 227 KB of shared
// memory, so this kernel keeps only the O(K) vectors there -- d, z,
// d[origin], tau, the weights and the r rows, (5 + r) K itemsize bytes --
// and recomputes each delta in registers when it needs it.  One block per
// merge lane runs three phases separated by __syncthreads():
//
//   1. root solve, one thread per root (the iteration of
//      secular_common.cuh, sweeping the poles in shared memory);
//   2. weights, one thread per pole (ratio product over the roots);
//   3. columns, one thread per root (sum over the poles, normalise).
//
// Each output element has one writer: no atomics, and a lane's result
// does not depend on the batch it was launched in.
//
// What bounds it on this card: FP64 arithmetic -- O(niter K^2) divisions
// for the solve and O(K^2) for the post-pass, on O(r K) bytes.  The
// largest K it takes follows from the shared-memory budget: in double
// precision with r = 3 rows it needs 64 K bytes, so K <= 3632 fits the
// 232,448-byte limit and K = 2048 is the largest merge size of the tree
// (repro_torch.core.tune.RESIDENT_THRESHOLD_CUDA).  THREADS = 256: every
// thread owns K / 256 roots, and 256 threads leave each up to 255
// registers for the iteration's state.
#include "secular_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
struct SmemPoles {
  const T* d;
  const T* z;
  int K;

  template <class F>
  __device__ void sweep(F f) {
    for (int i = 0; i < K; ++i) {
      const T zi = z[i];
      f(i, d[i], zi * zi);
    }
  }
};

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
resident_merge_kernel(const T* __restrict__ d, const T* __restrict__ z,
                      const T* __restrict__ R, const T* __restrict__ rho,
                      const int* __restrict__ kprime,
                      int* __restrict__ origin, T* __restrict__ tau,
                      T* __restrict__ zhat, T* __restrict__ rows,
                      int r, int K, int niter, int use_zhat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_d = reinterpret_cast<T*>(smem_raw);
  T* s_z = s_d + K;
  T* s_dorg = s_z + K;
  T* s_tau = s_dorg + K;
  T* s_w = s_tau + K;
  T* s_R = s_w + K;                      // r x K

  const int b = blockIdx.x;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  const int kp = kprime[b];
  const T rh = rho[b];

  for (int i = threadIdx.x; i < K; i += THREADS) {
    s_d[i] = d[off + i];
    s_z[i] = z[off + i];
  }
  for (int i = threadIdx.x; i < r * K; i += THREADS) s_R[i] = Rb[i];
  __syncthreads();

  // ---- phase 1: root solve, one thread per root ----------------------
  SmemPoles<T> src{s_d, s_z, K};
  for (int j = threadIdx.x; j < K; j += THREADS) {
    int o;
    T t;
    secular::solve_root<T>(
        j, K, kp, rh, niter, src, [&](int i) { return s_d[i]; },
        [&](int i) { return s_z[i] * s_z[i]; }, &o, &t);
    origin[off + j] = o;
    tau[off + j] = t;
    s_dorg[j] = s_d[o];
    s_tau[j] = t;
  }
  __syncthreads();

  // ---- phase 2: weights, one thread per pole --------------------------
  for (int i = threadIdx.x; i < K; i += THREADS) {
    const T z_i = s_z[i];
    T out = z_i;
    if (use_zhat && i < kp) {
      // Factors by magnitude, the product in double, magnitudes below
      // the smallest normal number counted: see secular::weight_factor.
      const T d_i = s_d[i];
      double prod = 1.0;
      int floored = 0;
      for (int jj = 0; jj < kp; ++jj) {
        if (jj == i) continue;
        prod *= secular::weight_factor<T>((s_dorg[jj] - d_i) + s_tau[jj],
                                          s_d[jj] - d_i, floored);
      }
      // lam_i - d_i
      const double z2 = secular::weight_z2<T>(
          prod, (s_dorg[i] - d_i) + s_tau[i], (double)rh, floored);
      out = sign_of(z_i) * (T)sqrt(z2);
    }
    zhat[off + i] = out;
    s_w[i] = out;
  }
  __syncthreads();

  // ---- phase 3: columns, one thread per root --------------------------
  T* rb = rows + (size_t)b * r * K;
  for (int j = threadIdx.x; j < K; j += THREADS) {
    if (j >= kp) {
      for (int q = 0; q < r; ++q) rb[(size_t)q * K + j] = s_R[q * K + j];
      continue;
    }
    const T d_org = s_dorg[j];
    const T tau_j = s_tau[j];
    T acc[4] = {T(0), T(0), T(0), T(0)};
    T nrm2 = T(0);
    for (int i = 0; i < kp; ++i) {
      const T delta = (s_d[i] - d_org) - tau_j;
      // An exact zero denominator divides by 1, as the plain version does.
      const T y = delta != T(0) ? s_w[i] / delta : s_w[i];
      for (int q = 0; q < r; ++q) acc[q] += s_R[q * K + i] * y;
      nrm2 += y * y;
    }
    const T nrm = sqrt(nrm2);
    const T scale = nrm > T(0) ? nrm : T(1);
    for (int q = 0; q < r; ++q) rb[(size_t)q * K + j] = acc[q] / scale;
  }
}

template <typename T>
int launch(const T* d, const T* z, const T* R, const T* rho,
           const int* kprime, int* origin, T* tau, T* zhat, T* rows, int B,
           int r, int K, int niter, int use_zhat, void* stream) {
  if (r < 1 || r > 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 + r) * K * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      resident_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  resident_merge_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      d, z, R, rho, kprime, origin, tau, zhat, rows, r, K, niter, use_zhat);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int resident_merge_f64(const double* d, const double* z, const double* R,
                       const double* rho, const int* kprime, int* origin,
                       double* tau, double* zhat, double* rows, int B, int r,
                       int K, int niter, int use_zhat, void* stream) {
  return launch<double>(d, z, R, rho, kprime, origin, tau, zhat, rows, B, r,
                        K, niter, use_zhat, stream);
}

int resident_merge_f32(const float* d, const float* z, const float* R,
                       const float* rho, const int* kprime, int* origin,
                       float* tau, float* zhat, float* rows, int B, int r,
                       int K, int niter, int use_zhat, void* stream) {
  return launch<float>(d, z, R, rho, kprime, origin, tau, zhat, rows, B, r,
                       K, niter, use_zhat, stream);
}

}  // extern "C"
