// Batched secular root solve for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/secular_roots.py::secular_solve_pallas_batch
// (the Pallas TPU kernel _secular_kernel; grid = problems x root blocks).
// Plain version beside it: repro_torch.core.secular.secular_solve_batched.
//
// Each launch solves a root window, roots [start, start + nroots) of every
// problem (plain version secular_solve_window_batched): the full launch is
// the window (0, K), and a shard of the distributed conquer's cooperative
// levels launches its own window only.  A root's arithmetic depends only
// on its index and the whole pole state, so a window equals the same
// columns of the full launch bit for bit, at any start, a multiple of the
// block's roots or not.
//
// What bounds it on this card: FP64 arithmetic.  Each root sweeps the
// kprime active poles niter + 5 times, about six operations per (root,
// pole) pair per sweep (one of them a reciprocal), so a merge does
// O(niter K^2) work on O(K) bytes: far above the H100's operations-per-
// byte balance.  The work is a long chain per root (each sweep's sum
// feeds the next step), so what the card loses on it is latency: an FP64
// reciprocal sequence and a running sum per term, with nothing to hide
// them unless many roots are in flight on every SM.  The main path's top
// merge is one problem (B = 1) of K = 16384 roots.
//
// What the design does about it: every root is solved by a team of TEAM
// = 8 lanes of one warp (secular_common.cuh), so a block of THREADS = 256
// threads solves 32 roots and the K = 16384 merge runs 131,072 threads
// (4,096 warps, 31 for each of the 132 SMs; the old one-thread-per-root
// kernel had 4), and every warp carries four independent sums.  Each
// lane forms one reciprocal per term where the old kernel divided twice.
// The block's poles and squared weights stream through a ring of STAGES
// shared-memory tiles of TILE poles loaded with cp.async
// (__pipeline_memcpy_async): the load of tile t + STAGES - 1 is issued as
// tile t's sweep starts, so it overlaps the arithmetic, and one barrier
// per tile both publishes tile t and frees the slot that the load reuses.
// The 4 teams of a warp read the same addresses (a broadcast), and the
// TEAM lanes of a team read TEAM consecutive elements (no bank conflict).
// A sweep runs over the kprime active poles only, and a block whose roots
// are all deflated writes them and leaves.
//
// Sizes (derived for Hopper, no TPU constant carried over): TEAM = 8 keeps
// the butterfly to three exchanges and the scalar part of the iteration,
// which every lane of a team repeats, to 8 copies per root, while the
// smallest root launch of the main path (K = 4096, 4 problems) still puts
// 31 warps of work on each SM; blocks of 256 threads leave up to 128
// registers a thread at two blocks per SM (__launch_bounds__(256, 2);
// the float64 kernel takes 96, so 16 warps are resident on an SM and the
// rest queue).
// TILE = 512 poles gives each lane 64 terms between barriers; STAGES = 3
// keeps two tiles in flight: 3 x 512 x (8 + 8) bytes = 24 KiB of static
// shared memory per block in float64.  32 roots per block share each tile,
// so the K = 16384 merge moves 0.13 GB per sweep from L2 into shared
// memory, against ~1.6e9 operations of arithmetic per sweep.
//
// What still bounds it: a g/g' term compiles to 12 FP64-pipe instructions
// and one reciprocal estimate, one dependent chain, and 16 resident warps
// keep the FP64 pipe about half busy (PERF.md, with the timings).
#include <cuda_pipeline.h>

#include "secular_common.cuh"

namespace {

using secular::TEAM;
constexpr int THREADS = 256;
constexpr int ROOTS_PER_BLOCK = THREADS / TEAM;
constexpr int TILE = 512;
constexpr int STAGES = 3;

template <typename T>
struct RingPoles {
  const T* d;
  const T* z2;
  int n;      // active poles (kprime)
  int lane;   // this thread's lane in its team
  T* sd;      // STAGES x TILE
  T* sz;

  __device__ void load(int tile) {
    const int start = tile * TILE;
    const int cnt = n - start < TILE ? n - start : TILE;
    T* td = sd + (tile % STAGES) * TILE;
    T* tz = sz + (tile % STAGES) * TILE;
    for (int t = threadIdx.x; t < cnt; t += THREADS) {
      __pipeline_memcpy_async(td + t, d + start + t, sizeof(T));
      __pipeline_memcpy_async(tz + t, z2 + start + t, sizeof(T));
    }
  }

  template <class F>
  __device__ void sweep(F f) {
    const int ntiles = (n + TILE - 1) / TILE;
    // Every thread is done with the previous sweep's slots.
    __syncthreads();
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ntiles) load(s);
      __pipeline_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      __pipeline_wait_prior(STAGES - 2);
      // Tile t has landed for every thread, and every thread has finished
      // tile t - 1, whose slot the next load reuses.
      __syncthreads();
      if (t + STAGES - 1 < ntiles) load(t + STAGES - 1);
      __pipeline_commit();
      const int start = t * TILE;
      const int cnt = n - start < TILE ? n - start : TILE;
      const T* td = sd + (t % STAGES) * TILE;
      const T* tz = sz + (t % STAGES) * TILE;
#pragma unroll 4
      for (int k = lane; k < cnt; k += TEAM) f(start + k, td[k], tz[k]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
secular_roots_kernel(const T* __restrict__ d, const T* __restrict__ z2,
                     const T* __restrict__ rho, const int* __restrict__ kprime,
                     int* __restrict__ origin, T* __restrict__ tau,
                     int K, int start, int nroots, int niter) {
  __shared__ T sd[STAGES * TILE];
  __shared__ T sz[STAGES * TILE];
  const int b = blockIdx.y;
  const secular::Team team;
  // Root j of the window [start, start + nroots) lands in column j - start
  // of a row nroots wide; the full launch is the window (0, K).
  const int first = start + blockIdx.x * ROOTS_PER_BLOCK;
  const int j = first + (int)threadIdx.x / TEAM;
  const int end = start + nroots;
  const size_t in = (size_t)b * K;
  const size_t out = (size_t)b * nroots + (size_t)(j - start);
  const int kp = kprime[b];
  // A block of deflated roots only: (j, 0).  The branch is the same for
  // the whole block, so no barrier is left waiting.
  if (first >= kp) {
    if (team.lane == 0 && j < end) {
      origin[out] = j;
      tau[out] = T(0);
    }
    return;
  }
  const T* db = d + in;
  const T* zb = z2 + in;
  RingPoles<T> src{db, zb, kp, team.lane, sd, sz};
  int o;
  T t;
  // Teams past the window's end or past kprime still run the sweeps: the
  // tile loads synchronise the whole block.  solve_root writes their
  // deflated value; a team past the window's end writes nothing.
  secular::solve_root<T>(
      team, j, K, kp, rho[b], niter, src, [&](int i) { return db[i]; },
      [&](int i) { return zb[i]; }, &o, &t);
  if (team.lane == 0 && j < end) {
    origin[out] = o;
    tau[out] = t;
  }
}

template <typename T>
int launch(const T* d, const T* z2, const T* rho, const int* kprime,
           int* origin, T* tau, int B, int K, int start, int nroots,
           int niter, void* stream) {
  dim3 grid((nroots + ROOTS_PER_BLOCK - 1) / ROOTS_PER_BLOCK, B);
  secular_roots_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      d, z2, rho, kprime, origin, tau, K, start, nroots, niter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Roots [start, start + nroots) of every problem, written to (B, nroots)
// outputs; the full launch is the window (0, K).  A shard of a
// cooperative merge level solves only its own window
// (core/merge.py::merge_level_coop).
int secular_roots_f64(const double* d, const double* z2, const double* rho,
                      const int* kprime, int* origin, double* tau, int B,
                      int K, int start, int nroots, int niter,
                      void* stream) {
  return launch<double>(d, z2, rho, kprime, origin, tau, B, K, start, nroots,
                        niter, stream);
}

int secular_roots_f32(const float* d, const float* z2, const float* rho,
                      const int* kprime, int* origin, float* tau, int B,
                      int K, int start, int nroots, int niter,
                      void* stream) {
  return launch<float>(d, z2, rho, kprime, origin, tau, B, K, start, nroots,
                       niter, stream);
}

}  // extern "C"
