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
//   pass A (pole-major, weights.cuh): one team per pole i takes its weight
//     zhat_i = sign(z_i) sqrt(|prod_j (lam_j - d_i) / (d_j - d_i)
//              * (lam_i - d_i)| / rho)
//     over all active roots j != i (DLAED3's ratio-product form, sign(0)
//     = 0; secular::team_weight, the loop the resident merge's phase 2
//     runs too) and writes it; with use_zhat = 0 it writes z;
//   pass B (root-major, below): one team per root column j sums over all
//     active poles i, y_ij = zhat_i / ((d_i - d_org_j) - tau_j), the r rows
//     sum_i R[:, i] y_ij and ||y_.j||^2, then normalises its own column
//     (secular::team_column, the resident merge's phase 3).
//
// Each output element has exactly one writer (lane 0 of the team that
// owns it), so there are no atomics, and every sum and product runs in an
// order set by TEAM and the item's index alone: the result does not
// depend on the grid or the batch (batched == looped bit for bit).
//
// What bounds it on this card: its instructions, O(kprime^2) pairs a lane
// on O(r K) bytes -- pass A a reciprocal and a few operations a pair
// (weights.cuh), pass B a reciprocal, two subtractions and r + 1 FMAs:
// some 34 instructions a pair in the SASS, 14 of them on the FP64 pipe
// (r <= 4 predicated), so the issue slots bind ahead of the FP64 pipe.
// One thread per output would run the main path's levels (W = 4 x
// K = 4096, W = 2 x K = 8192) on about 4 warps an SM, too few to hide
// the FP64 latency.
//
// What the design does about it: teams of secular::TEAM = 8 lanes, each
// lane a TEAM-th of the other axis, eight times the warps.  Pass B's
// blocks of ROWS_THREADS = 256 threads hold 32 columns of one lane and
// stage the poles' d, zhat and r rows through two shared-memory tiles of
// ROWS_TILE = 256 poles (2 x 6 x 256 x 8 = 24 KiB in double at r = 4)
// through the ring of the weight kernel (weights.cuh's tile_ring): the
// next tile's loads in flight in registers while the block works on the
// current one, one barrier a tile.  Blocks whose columns are all deflated
// only copy R.  r <= MAX_R = 4; larger r takes the two-pass row update.
#include "weights.cuh"

namespace {

using secular::TEAM;
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_TILE = 256;
constexpr int MAX_R = 4;
static_assert(ROWS_TILE % ROWS_THREADS == 0 && ROWS_TILE % TEAM == 0,
              "a tile is whole loads of the block and whole rounds of a "
              "team");

// The lane's active poles (d, zhat and the r rows of R) in two
// shared-memory tiles (secular::tile_ring), for secular::team_column.
template <typename T>
struct TiledPoles {
  static constexpr int PER = ROWS_TILE / ROWS_THREADS;
  T (*s_d)[ROWS_TILE];
  T (*s_w)[ROWS_TILE];
  T (*s_R)[MAX_R][ROWS_TILE];
  const T* d;         // this lane's rows
  const T* w;
  const T* R;         // r x K
  int K, kp, r, lane;
  T rd[PER], rw[PER], rR[PER][MAX_R];

  __device__ void fetch(int start) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int ii = start + (int)threadIdx.x + k * ROWS_THREADS;
      if (ii < kp) {
        rd[k] = d[ii];
        rw[k] = w[ii];
#pragma unroll
        for (int q = 0; q < MAX_R; ++q)
          if (q < r) rR[k][q] = R[(size_t)q * K + ii];
      }
    }
  }
  __device__ void stash(int buf) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int t = (int)threadIdx.x + k * ROWS_THREADS;
      s_d[buf][t] = rd[k];
      s_w[buf][t] = rw[k];
#pragma unroll
      for (int q = 0; q < MAX_R; ++q) s_R[buf][q][t] = rR[k][q];
    }
  }

  template <class F>
  __device__ void sweep(F f) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      rd[k] = rw[k] = T(0);
#pragma unroll
      for (int q = 0; q < MAX_R; ++q) rR[k][q] = T(0);
    }
    secular::tile_ring<ROWS_TILE>(*this, kp, lane,
                                  [&](int buf, int t, int start) {
      f(start + t, s_d[buf][t], s_w[buf][t], &s_R[buf][0][t], ROWS_TILE);
    });
  }
};

// Pass B: one team per root column.  Deflated columns pass R through.
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const T* __restrict__ R, const T* __restrict__ d,
            const int* __restrict__ origin, const T* __restrict__ tau,
            const int* __restrict__ kprime, const T* __restrict__ zhat,
            T* __restrict__ rows, int r, int K) {
  constexpr int COLS = ROWS_THREADS / TEAM;
  __shared__ T s_d[2][ROWS_TILE];
  __shared__ T s_w[2][ROWS_TILE];
  __shared__ T s_R[2][MAX_R][ROWS_TILE];
  const int b = blockIdx.y;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  T* rb = rows + (size_t)b * r * K;
  const int kp = kprime[b];
  const int first = blockIdx.x * COLS;
  if (first >= kp) {
    // No active column in this block: R passes through.
    for (int m = (int)threadIdx.x; m < r * COLS; m += ROWS_THREADS) {
      const int q = m / COLS, j = first + m % COLS;
      if (j < K) rb[(size_t)q * K + j] = Rb[(size_t)q * K + j];
    }
    return;
  }
  const secular::Team team;
  const int j = first + (int)threadIdx.x / TEAM;
  // Teams past kprime take part in the tile loads and barriers and
  // discard what they compute.
  const int js = j < kp ? j : kp - 1;
  int o = origin[off + js];
  o = o < K - 1 ? o : K - 1;
  TiledPoles<T> poles{s_d, s_w, s_R, d + off, zhat + off, Rb, K, kp, r,
                      team.lane};
  T acc[MAX_R];
  const T scale = secular::team_column<T, MAX_R>(team, d[off + o],
                                                 tau[off + js], r, poles,
                                                 acc);
  if (team.lane != 0 || j >= K) return;
#pragma unroll
  for (int q = 0; q < MAX_R; ++q)
    if (q < r)
      rb[(size_t)q * K + j] = j < kp ? acc[q] / scale
                                     : Rb[(size_t)q * K + j];
}

template <typename T>
int launch(const T* R, const T* d, const T* z, const int* origin,
           const T* tau, const int* kprime, const T* rho, T* zhat, T* rows,
           int B, int r, int K, int use_zhat, void* stream) {
  if (r < 1 || r > MAX_R) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = secular::launch_weights<T>(d, z, origin, tau, rho,
                                               kprime, zhat, B, K, use_zhat,
                                               s);
  if (err != cudaSuccess) return (int)err;
  constexpr int COLS = ROWS_THREADS / TEAM;
  dim3 grid((K + COLS - 1) / COLS, B);
  rows_kernel<T><<<grid, ROWS_THREADS, 0, s>>>(R, d, origin, tau, kprime,
                                               zhat, rows, r, K);
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
