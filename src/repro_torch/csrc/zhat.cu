// Gu-Eisenstat weight reconstruction of the two-pass conquer for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/zhat.py::zhat_reconstruct_pallas (the Pallas
// TPU kernel _zhat_kernel; grid = pole blocks of one problem).
// Plain version beside it:
// repro_torch.core.secular.zhat_reconstruct_batched.
//
// For every active pole i of lane b, over the kprime active roots j:
//
//   zhat_i^2 = prod_j |lam_j - d_i| / (rho prod_{j != i} |d_j - d_i|),
//   lam_j - d_i = (d_org_j - d_i) + tau_j,
//
// with zhat_i of z_i's sign; inactive poles pass z through.  The TPU
// kernel and the plain version take it in log space (two logs per pair,
// summed in float64).  This kernel takes DLAED3's ratio product instead,
// one reciprocal per pair and no log, as the fused post-pass and the
// resident merge do, so the two-pass and the fused paths compute the same
// weights: weights.cuh, which fused_update.cu's pass A launches too, holds
// the kernel and its design (one team of secular::TEAM lanes per pole,
// the roots staged through double-buffered shared-memory tiles).  The
// plain log-space version stays the oracle, at the tolerances the kernel
// was held to before.
//
// What bounds it on this card: FP64 arithmetic, kprime^2 pairs a lane
// with one reciprocal each, on O(K) bytes (see weights.cuh).
#include "weights.cuh"

namespace {

template <typename T>
int launch(const T* d, const T* z, const int* origin, const T* tau,
           const T* rho, const int* kprime, T* zhat, int B, int K,
           void* stream) {
  return (int)secular::launch_weights<T>(d, z, origin, tau, rho, kprime,
                                         zhat, B, K, 1,
                                         (cudaStream_t)stream);
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
