// Gu-Eisenstat weights out of device memory, one team per pole: the
// kernel of csrc/zhat.cu (the two-pass conquer's weights) and pass A of
// csrc/fused_update.cu (the fused post-pass), for any K.
//
// For every active pole i of lane b it computes, with the kprime active
// roots j of the lane, lam_j - d_i = (d_org_j - d_i) + tau_j and
//
//   zhat_i = sign(z_i) sqrt(|prod_{j != i} (lam_j - d_i) / (d_j - d_i)|
//                           * |lam_i - d_i| / rho)
//
// (secular::team_weight: DLAED3's ratio product, one reciprocal per
// pair, floored magnitudes counted); inactive poles, and every pole when
// use_zhat is 0, pass z through.
//
// What bounds it on this card: its instructions, kprime^2 pairs a lane on
// O(K) bytes.  A pair is a reciprocal (estimate and Newton sequence),
// three subtractions, two floor tests, a product and three shared-memory
// loads: some 37 instructions in the SASS, 14 of them on the FP64 pipe,
// so an SM's four issue slots a cycle bind ahead of its two FP64 warp
// instructions.  One thread per pole would put 14336 threads, about 3.4
// warps an SM, on the table's B = 2, K = 8192 shape: too few to hide the
// latency of each thread's chain of products.
//
// What the design does about it: a team of TEAM = 8 lanes takes each pole
// (secular_common.cuh), eight times the warps, each lane a TEAM-th of the
// roots.  A block of WEIGHT_THREADS = 256 threads holds 32 poles of one
// lane (grid = pole blocks x lanes); blocks whose poles are all deflated
// only copy z.  The roots' d[origin], tau and d are staged through two
// shared-memory tiles of WEIGHT_TILE = 512 roots (2 x 3 x 512 x 8 = 24 KiB
// in double): while the block works on one tile, each thread's loads of
// the next tile are in flight in registers (and the origins of the tile
// after it, so the gather d[origin] never waits on its index), stored to
// the other tile after the work, one barrier a tile.  A tile's element is
// read by one lane of every team at one address (a broadcast).
//
// Lane l visits the roots j = l (mod TEAM) in ascending order (the tile
// is a multiple of TEAM, so that holds across tiles) and the butterfly's
// order is fixed, so a pole's weight depends on K, kprime, TEAM and the
// data only: batched and looped launches agree bit for bit, and each
// output has one writer (lane 0 of its team).  The resident merge's
// phase 2 runs the same team_weight over its shared-memory copy.
#pragma once

#include "secular_common.cuh"

namespace secular {

constexpr int WEIGHT_THREADS = 256;
constexpr int WEIGHT_TILE = 512;
static_assert(WEIGHT_TILE % WEIGHT_THREADS == 0 && WEIGHT_TILE % TEAM == 0,
              "a tile is whole loads of the block and whole rounds of a "
              "team");

// The ring both tiled sources stage through (TiledRoots here, the post-
// pass's TiledPoles in fused_update.cu): a block walks the kp active items
// in tiles of TILE; each thread's loads of the next tile (stage.fetch) are
// in flight in registers while the block visits the current one, and land
// in the other shared-memory buffer (stage.stash) after it, one barrier a
// tile.  visit(buf, t, start) runs for the calling thread's items t = lane
// (mod TEAM) of the tile, in ascending order.  Every thread of the block
// calls it once (it synchronises the block).
template <int TILE, class Stage, class Visit>
__device__ __forceinline__ void tile_ring(Stage& stage, int kp, int lane,
                                          Visit visit) {
  if (kp <= 0) return;
  stage.fetch(0);
  stage.stash(0);
  __syncthreads();
  int buf = 0;
  for (int start = 0; start < kp; start += TILE, buf ^= 1) {
    const int next = start + TILE;
    if (next < kp) stage.fetch(next);
    const int n = kp - start < TILE ? kp - start : TILE;
    for (int t = lane; t < n; t += TEAM) visit(buf, t, start);
    if (next < kp) stage.stash(buf ^ 1);
    __syncthreads();
  }
}

// The lane's active roots in two shared-memory tiles, for team_weight.
// A fetch also loads the origins of the tile after the one it fetches, so
// the gather d[origin] never waits on its index.
template <typename T>
struct TiledRoots {
  static constexpr int PER = WEIGHT_TILE / WEIGHT_THREADS;
  T (*s_dorg)[WEIGHT_TILE];
  T (*s_tau)[WEIGHT_TILE];
  T (*s_d)[WEIGHT_TILE];
  const T* d;         // this lane's rows
  const int* origin;
  const T* tau;
  int K, kp, lane;
  int ro[PER];
  T rdorg[PER], rtau[PER], rd[PER];

  __device__ void origins(int start) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int jj = start + (int)threadIdx.x + k * WEIGHT_THREADS;
      const int o = jj < kp ? origin[jj] : 0;
      ro[k] = o < K - 1 ? o : K - 1;
    }
  }
  __device__ void fetch(int start) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int jj = start + (int)threadIdx.x + k * WEIGHT_THREADS;
      if (jj < kp) {
        rdorg[k] = d[ro[k]];
        rtau[k] = tau[jj];
        rd[k] = d[jj];
      }
    }
    origins(start + WEIGHT_TILE);
  }
  __device__ void stash(int buf) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int t = (int)threadIdx.x + k * WEIGHT_THREADS;
      s_dorg[buf][t] = rdorg[k];
      s_tau[buf][t] = rtau[k];
      s_d[buf][t] = rd[k];
    }
  }

  template <class F>
  __device__ void sweep(F f) {
#pragma unroll
    for (int k = 0; k < PER; ++k) rdorg[k] = rtau[k] = rd[k] = T(0);
    origins(0);
    tile_ring<WEIGHT_TILE>(*this, kp, lane, [&](int buf, int t, int start) {
      f(start + t, s_dorg[buf][t], s_tau[buf][t], s_d[buf][t]);
    });
  }
};

template <typename T>
__global__ void __launch_bounds__(WEIGHT_THREADS)
weights_kernel(const T* __restrict__ d, const T* __restrict__ z,
               const int* __restrict__ origin, const T* __restrict__ tau,
               const T* __restrict__ rho, const int* __restrict__ kprime,
               T* __restrict__ zhat, int K, int use_zhat) {
  constexpr int POLES = WEIGHT_THREADS / TEAM;
  __shared__ T s_dorg[2][WEIGHT_TILE];
  __shared__ T s_tau[2][WEIGHT_TILE];
  __shared__ T s_d[2][WEIGHT_TILE];
  const int b = blockIdx.y;
  const size_t off = (size_t)b * K;
  const int kp = kprime[b];
  const int first = blockIdx.x * POLES;
  if (!use_zhat || first >= kp) {
    // No active pole in this block: z passes through.
    for (int i = first + (int)threadIdx.x; i < first + POLES && i < K;
         i += WEIGHT_THREADS)
      zhat[off + i] = z[off + i];
    return;
  }
  const Team team;
  const int i = first + (int)threadIdx.x / TEAM;
  // Teams past kprime take part in the tile loads and barriers and
  // discard what they compute.
  const int is = i < kp ? i : kp - 1;
  const T d_i = d[off + is];
  const T z_i = z[off + is];
  int o = origin[off + is];
  o = o < K - 1 ? o : K - 1;
  TiledRoots<T> roots{s_dorg, s_tau, s_d, d + off, origin + off, tau + off,
                      K, kp, team.lane};
  // lam_i - d_i
  const T w = team_weight<T>(team, is, d_i, z_i,
                             (d[off + o] - d_i) + tau[off + is],
                             (double)rho[b],
                             gap_scale<T>(d[off], d[off + kp - 1]), roots);
  if (team.lane == 0 && i < K) zhat[off + i] = i < kp ? w : z[off + i];
}

// Launches weights_kernel on B lanes of K poles.
template <typename T>
cudaError_t launch_weights(const T* d, const T* z, const int* origin,
                           const T* tau, const T* rho, const int* kprime,
                           T* zhat, int B, int K, int use_zhat,
                           cudaStream_t stream) {
  constexpr int POLES = WEIGHT_THREADS / TEAM;
  dim3 grid((K + POLES - 1) / POLES, B);
  weights_kernel<T><<<grid, WEIGHT_THREADS, 0, stream>>>(
      d, z, origin, tau, rho, kprime, zhat, K, use_zhat);
  return cudaGetLastError();
}

}  // namespace secular
