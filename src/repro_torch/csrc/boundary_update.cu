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
// The K x K block Y is never stored in device memory.  Each y entry takes
// one reciprocal (secular_common.cuh's rcp, the zero-denominator rule
// selecting its operand), where the plain version divides.
//
// Three paths; the wrapper picks one and its launch shape
// (kernels.boundary_update.launch_shape) and this source refuses a shape
// that is not its own:
//
//   * "team", r <= 4 (the boundary rows of the BR tree, fused=False): a
//     team of TEAM lanes per root column (secular_common.cuh's Team), lane
//     l summing the poles i = l (mod TEAM) in order, an xor butterfly for
//     the r sums and the squared norm, so every lane holds the same bits
//     and a column's result depends on K, kprime, TEAM and the data only.
//     The poles, their weights and their r rows stream through a ring of
//     COL_STAGES shared-memory tiles of COL_TILE poles (cp.async), as in
//     secular_roots.cu.  Bound by FP64 operations: one reciprocal and
//     about 4 + 2r operations per (pole, root) pair.  The one-thread-per-
//     column kernel it replaces left about 4 warps per SM at B = 2,
//     K = 8192 and divided in full for every term.
//   * "mma", r > 4 in float64 (r = K in the full-vector and lazy-replay
//     baselines): the update is a K x K by K x K product whose right
//     factor Y is made on the fly, run on the FP64 tensor cores
//     (mma.sync.aligned.m16n8k8 f64, DMMA; wgmma has no f64 form, and the
//     m8n8k4 shape runs at half the rate on Hopper).  A block of 16 warps
//     owns an MMA_BM x MMA_BN = 128 x 128 output tile (rows x roots), each
//     warp 32 x 32 (2 x 4 MMA tiles, 32 accumulators).  Per step of
//     MMA_BK = 32 poles the R tile and the poles' d and w arrive through a
//     cp.async ring of MMA_STAGES stages (d and w one step ahead of R), and
//     the y tile is built in shared memory, one reciprocal per entry, once
//     for all 128 rows (r / 128 times in all, where the SIMT tiles built
//     it r / 64 times), into a double buffer: each step's y is built after
//     the step's MMAs, so one barrier per step suffices.  Rows of both
//     tiles are padded to MMA_LDK = 36 doubles, which makes every fragment
//     load free of bank conflicts.  The column norms come first, from the
//     team kernel with no rows (one launch more), so each is summed once,
//     in one fixed order, and every row tile of a column divides by the
//     same bits.  Bound by the DMMA rate: 2 r K'^2 operations per lane,
//     (4/3) N^3 over the tree of an n = N solve.  The shape was chosen on
//     the card among variants (PERF.md): 16 warps hide more of each step's
//     fragment-load latency and barrier than 8 warps of 64 x 32 tiles,
//     two blocks of 4 warps per SM, or warps specialised as y builders,
//     which could not build y as fast as the others consumed it.
//   * "simt", r > 4 in float32: no DMMA for f32 (and no TF32 here), so
//     64 x 64 output tiles of SIMT FMAs as before, each thread a 4 x 4
//     register tile, the first BN threads summing each column's norm in
//     pole order.
//
// Each output element has one writer: no atomics, and a lane's result
// does not depend on the batch it was launched in.
#include <cuda_pipeline.h>

#include "secular_common.cuh"

namespace {

using secular::TEAM;
using secular::inv_or_one;

// "team" path.
constexpr int COL_THREADS = 256;
constexpr int COLS_PER_BLOCK = COL_THREADS / TEAM;
constexpr int COL_TILE = 256;
constexpr int COL_STAGES = 3;
constexpr int MAX_R_COL = 4;

// "mma" path.
constexpr int MMA_BM = 128;
constexpr int MMA_BN = 128;
constexpr int MMA_BK = 32;
constexpr int MMA_LDK = MMA_BK + 4;
constexpr int MMA_STAGES = 3;
constexpr int MMA_THREADS = 512;   // 16 warps: 4 (rows) x 4 (roots)
constexpr int WARP_M = 32;
constexpr int WARP_N = 32;
constexpr int COPY_DEPTH = 8;      // loads in flight a thread, pass-through

// "simt" path.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TILE_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

enum Path { kTeam = 0, kMma = 1, kSimt = 2 };

template <typename T>
constexpr int team_smem(int r) {
  return COL_STAGES * COL_TILE * (2 + r) * (int)sizeof(T);
}
constexpr int mma_smem() {
  return (MMA_STAGES * MMA_BM * MMA_LDK + 2 * MMA_BN * MMA_LDK
          + MMA_STAGES * 2 * MMA_BK + 3 * MMA_BN) * (int)sizeof(double);
}

// y_ij with the plain version's zero-denominator rule, one reciprocal.
template <typename T>
__device__ __forceinline__ T secular_y(T w_i, T d_i, T d_org, T tau_j) {
  return w_i * inv_or_one((d_i - d_org) - tau_j);
}

// Deflated columns: rows[q, j] = R[q, j].
template <typename T>
__device__ __forceinline__ void pass_through(const T* Rb, T* outb, int q,
                                             int j, int K) {
  outb[(size_t)q * K + j] = Rb[(size_t)q * K + j];
}

// ---- "team" path (and the column norms of the "mma" path, NR = 0) ------
//
// Block = COLS_PER_BLOCK root columns of one lane, one team each.  With
// NR == 0 it writes each active column's divisor (||y_.j||, or 1 where
// that is 0) to scale[b, j] and no rows.
template <typename T, int NR>
__global__ void __launch_bounds__(COL_THREADS)
rows_team_kernel(const T* __restrict__ R, const T* __restrict__ d,
                 const T* __restrict__ w, const int* __restrict__ origin,
                 const T* __restrict__ tau, const int* __restrict__ kprime,
                 T* __restrict__ rows, T* __restrict__ scale, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // stage: d, w, NR rows
  const secular::Team team;
  const int b = blockIdx.y;
  const int j = blockIdx.x * COLS_PER_BLOCK + (int)threadIdx.x / TEAM;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * NR * K;
  T* outb = rows + (size_t)b * NR * K;
  const int kp = kprime[b];
  if (blockIdx.x * COLS_PER_BLOCK >= kp) {
    // Every column of the block is deflated (uniform over the block).
    if (j < K)
      for (int q = team.lane; q < NR; q += TEAM)
        pass_through(Rb, outb, q, j, K);
    return;
  }
  const int js = j < K - 1 ? j : K - 1;
  int o = origin[off + js];
  o = o < K - 1 ? o : K - 1;
  const T d_org = d[off + o];
  const T tau_j = tau[off + js];
  T acc[NR > 0 ? NR : 1];
#pragma unroll
  for (int q = 0; q < NR; ++q) acc[q] = T(0);
  T nrm2 = T(0);

  const int ntiles = (kp + COL_TILE - 1) / COL_TILE;
  auto load = [&](int t) {
    const int start = t * COL_TILE;
    const int cnt = kp - start < COL_TILE ? kp - start : COL_TILE;
    T* st = ring + (t % COL_STAGES) * (2 + NR) * COL_TILE;
    for (int u = threadIdx.x; u < cnt; u += COL_THREADS) {
      __pipeline_memcpy_async(st + u, d + off + start + u, sizeof(T));
      __pipeline_memcpy_async(st + COL_TILE + u, w + off + start + u,
                              sizeof(T));
#pragma unroll
      for (int q = 0; q < NR; ++q)
        __pipeline_memcpy_async(st + (2 + q) * COL_TILE + u,
                                Rb + (size_t)q * K + start + u, sizeof(T));
    }
  };
  for (int s = 0; s < COL_STAGES - 1; ++s) {
    if (s < ntiles) load(s);
    __pipeline_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    __pipeline_wait_prior(COL_STAGES - 2);
    // Tile t has landed for every thread, and every thread has finished
    // tile t - 1, whose slot the next load reuses.
    __syncthreads();
    if (t + COL_STAGES - 1 < ntiles) load(t + COL_STAGES - 1);
    __pipeline_commit();
    const int cnt = kp - t * COL_TILE < COL_TILE ? kp - t * COL_TILE
                                                 : COL_TILE;
    const T* st = ring + (t % COL_STAGES) * (2 + NR) * COL_TILE;
#pragma unroll 4
    for (int k = team.lane; k < cnt; k += TEAM) {
      const T y = secular_y(st[COL_TILE + k], st[k], d_org, tau_j);
#pragma unroll
      for (int q = 0; q < NR; ++q) acc[q] += st[(2 + q) * COL_TILE + k] * y;
      nrm2 += y * y;
    }
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) acc[q] = team.sum(acc[q]);
  nrm2 = team.sum(nrm2);
  if (j >= K) return;
  const T nrm = sqrt(nrm2);
  const T sc = nrm > T(0) ? nrm : T(1);
  if (NR == 0) {
    if (team.lane == 0 && j < kp) scale[off + j] = sc;
    return;
  }
  // Every lane holds the same sums: lane q writes row q.
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (q != team.lane) continue;
    if (j < kp)
      outb[(size_t)q * K + j] = acc[q] / sc;
    else
      pass_through(Rb, outb, q, j, K);
  }
}

// ---- "mma" path ---------------------------------------------------------

// D = A B + D on the FP64 tensor cores, one 16 x 8 x 8 tile per warp
// (m16n8k8; Hopper issues it at the full DMMA rate, where m8n8k4 reaches
// half).  Lane (g, t) = (lane / 4, lane % 4) holds A rows g, g + 8 at
// columns t, t + 4 (a0..a3: (g, t), (g+8, t), (g, t+4), (g+8, t+4)),
// B rows t, t + 4 at column g, and D rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__global__ void __launch_bounds__(MMA_THREADS, 1)
rows_mma_kernel(const double* __restrict__ R, const double* __restrict__ d,
                const double* __restrict__ w, const int* __restrict__ origin,
                const double* __restrict__ tau,
                const int* __restrict__ kprime,
                const double* __restrict__ scale,
                double* __restrict__ rows, int r, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // R tiles (pole-minor rows of the output tile), y tiles (pole-minor
  // root columns), the poles' d and w, and each column's d_org, tau and
  // divisor.
  double* sR = reinterpret_cast<double*>(smem_raw);
  double* sY = sR + MMA_STAGES * MMA_BM * MMA_LDK;
  double* sDW = sY + 2 * MMA_BN * MMA_LDK;
  double* sOrg = sDW + MMA_STAGES * 2 * MMA_BK;
  double* sTau = sOrg + MMA_BN;
  double* sScale = sTau + MMA_BN;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * MMA_BM;
  const int col0 = blockIdx.x * MMA_BN;
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * K;
  const double* Rb = R + (size_t)b * r * K;
  double* outb = rows + (size_t)b * r * K;
  const int kp = kprime[b];

  if (col0 >= kp) {
    // Every column of the tile is deflated: pass R through.  One such
    // block fits on an SM, so each thread keeps COPY_DEPTH loads in flight
    // (the top levels of a deflating r = K solve are this copy: GBs).
    for (int e0 = tid; e0 < MMA_BM * MMA_BN;
         e0 += COPY_DEPTH * MMA_THREADS) {
      double v[COPY_DEPTH];
#pragma unroll
      for (int u = 0; u < COPY_DEPTH; ++u) {
        const int e = e0 + u * MMA_THREADS;
        const int q = row0 + e / MMA_BN, j = col0 + e % MMA_BN;
        v[u] = (e < MMA_BM * MMA_BN && q < r && j < K)
                   ? Rb[(size_t)q * K + j] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < COPY_DEPTH; ++u) {
        const int e = e0 + u * MMA_THREADS;
        const int q = row0 + e / MMA_BN, j = col0 + e % MMA_BN;
        if (e < MMA_BM * MMA_BN && q < r && j < K)
          outb[(size_t)q * K + j] = v[u];
      }
    }
    return;
  }
  if (tid < MMA_BN) {
    const int j = col0 + tid;
    const int js = j < K - 1 ? j : K - 1;
    int o = origin[off + js];
    o = o < K - 1 ? o : K - 1;
    sOrg[tid] = d[off + o];
    sTau[tid] = tau[off + js];
    sScale[tid] = j < kp ? scale[off + j] : 1.0;
  }

  const int ntiles = (kp + MMA_BK - 1) / MMA_BK;
  // R tile t into stage t % STAGES; rows past r and poles past kprime are
  // zero-filled (nothing is read for them).
  auto load_r = [&](int t) {
    double* st = sR + (t % MMA_STAGES) * MMA_BM * MMA_LDK;
    const int k0 = t * MMA_BK;
    for (int e = tid; e < MMA_BM * MMA_BK; e += MMA_THREADS) {
      const int m = e / MMA_BK, k = e % MMA_BK;
      const int q = row0 + m, i = k0 + k;
      const bool ok = q < r && i < kp;
      __pipeline_memcpy_async(st + m * MMA_LDK + k,
                              ok ? Rb + (size_t)q * K + i : Rb,
                              sizeof(double), ok ? 0 : sizeof(double));
    }
  };
  // d and w of tile t into stage t % STAGES.
  auto load_dw = [&](int t) {
    if (tid < 2 * MMA_BK) {
      const int k = tid % MMA_BK, i = t * MMA_BK + k;
      const bool ok = i < kp;
      const double* src = (tid < MMA_BK ? d : w) + off + (ok ? i : 0);
      __pipeline_memcpy_async(sDW + (t % MMA_STAGES) * 2 * MMA_BK + tid,
                              src, sizeof(double), ok ? 0 : sizeof(double));
    }
  };
  // y tile t into buffer t % 2: thread (k, c) builds pole k of the
  // columns c, c + 16, ..., c + 112 (a warp writes one column's 32 poles:
  // no bank conflict).
  const int yk = tid % MMA_BK;
  const int yc = tid / MMA_BK;
  auto build_y = [&](int t) {
    const double* dw = sDW + (t % MMA_STAGES) * 2 * MMA_BK;
    const double di = dw[yk], wi = dw[MMA_BK + yk];
    const bool pole = t * MMA_BK + yk < kp;
    double* yt = sY + (t % 2) * MMA_BN * MMA_LDK;
    // Unrolled by two, not fully: registers are capped at 128 a thread.
#pragma unroll 2
    for (int x = 0; x < MMA_BN / (MMA_THREADS / MMA_BK); ++x) {
      const int n = yc + x * (MMA_THREADS / MMA_BK);
      yt[n * MMA_LDK + yk] = (pole && col0 + n < kp)
                                 ? secular_y(wi, di, sOrg[n], sTau[n])
                                 : 0.0;
    }
  };

  // Group s holds R(s) and d, w of tile s + 1 (group 0 also tile 0's), so
  // once group t has landed, step t can build the y tile of t + 1.
  load_dw(0);
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ntiles) load_r(s);
    if (s + 1 < ntiles) load_dw(s + 1);
    __pipeline_commit();
  }
  __pipeline_wait_prior(MMA_STAGES - 2);
  __syncthreads();
  build_y(0);

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (MMA_BN / WARP_N)) * WARP_M;
  const int wn = (warp % (MMA_BN / WARP_N)) * WARP_N;
  const int g = lane >> 2, tq = lane & 3;
  constexpr int MI = WARP_M / 16, NI = WARP_N / 8;
  double acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.0;

  for (int t = 0; t < ntiles; ++t) {
    __pipeline_wait_prior(MMA_STAGES - 2);
    // Group t has landed for every thread, y tile t is built, and every
    // warp has finished step t - 1, whose stages the loads below reuse.
    __syncthreads();
    if (t + MMA_STAGES - 1 < ntiles) load_r(t + MMA_STAGES - 1);
    if (t + MMA_STAGES < ntiles) load_dw(t + MMA_STAGES);
    __pipeline_commit();
    const double* As = sR + (t % MMA_STAGES) * MMA_BM * MMA_LDK;
    const double* Bs = sY + (t % 2) * MMA_BN * MMA_LDK;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 8) {
      double bb[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bb[ni][h] = Bs[(wn + ni * 8 + g) * MMA_LDK + kk + tq + 4 * h];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        double a[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          a[h] = As[(wm + mi * 16 + g + 8 * (h & 1)) * MMA_LDK + kk + tq +
                    4 * (h >> 1)];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) dmma(acc[mi][ni], a, bb[ni]);
      }
    }
    if (t + 1 < ntiles) build_y(t + 1);
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int q = row0 + wm + mi * 16 + g + 8 * (h >> 1);
      if (q >= r) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn + ni * 8 + 2 * tq + (h & 1), j = col0 + n;
        if (j >= K) continue;
        if (j < kp)
          outb[(size_t)q * K + j] = acc[mi][ni][h] / sScale[n];
        else
          pass_through(Rb, outb, q, j, K);
      }
    }
  }
}

// ---- "simt" path (float32, r > 4) ----------------------------------------

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
      if (q < r && j < K) pass_through(Rb, outb, q, j, K);
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
      if (j < kp)
        outb[(size_t)q * K + j] = acc[x][y] / s_nrm[n];
      else
        pass_through(Rb, outb, q, j, K);
    }
  }
}

// ---- launch -------------------------------------------------------------

template <typename T, int NR>
cudaError_t launch_team(const T* R, const T* d, const T* w,
                        const int* origin, const T* tau, const int* kprime,
                        T* rows, T* scale, int B, int K, cudaStream_t s) {
  constexpr int smem = team_smem<T>(NR);
  static_assert(smem <= 48 * 1024, "the team ring fits in static limits");
  dim3 grid((K + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK, B);
  rows_team_kernel<T, NR><<<grid, COL_THREADS, smem, s>>>(
      R, d, w, origin, tau, kprime, rows, scale, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_team_r(int r, const T* R, const T* d, const T* w,
                          const int* origin, const T* tau, const int* kprime,
                          T* rows, T* scale, int B, int K, cudaStream_t s) {
  switch (r) {
    case 0: return launch_team<T, 0>(R, d, w, origin, tau, kprime, rows,
                                     scale, B, K, s);
    case 1: return launch_team<T, 1>(R, d, w, origin, tau, kprime, rows,
                                     scale, B, K, s);
    case 2: return launch_team<T, 2>(R, d, w, origin, tau, kprime, rows,
                                     scale, B, K, s);
    case 3: return launch_team<T, 3>(R, d, w, origin, tau, kprime, rows,
                                     scale, B, K, s);
    case 4: return launch_team<T, 4>(R, d, w, origin, tau, kprime, rows,
                                     scale, B, K, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma(const double* R, const double* d, const double* w,
                       const int* origin, const double* tau,
                       const int* kprime, double* rows, double* scale, int B,
                       int r, int K, dim3 grid, cudaStream_t s) {
  // The column divisors first (team kernel, no rows), then the product.
  cudaError_t err = launch_team_r<double>(0, R, d, w, origin, tau, kprime,
                                          rows, scale, B, K, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mma_smem());
  if (err != cudaSuccess) return err;
  rows_mma_kernel<<<grid, MMA_THREADS, mma_smem(), s>>>(
      R, d, w, origin, tau, kprime, scale, rows, r, K);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* R, const T* d, const T* w, const int* origin,
           const T* tau, const int* kprime, T* rows, T* scale, int B, int r,
           int K, int path, int gx, int gy, int gz, int threads, int smem,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // The wrapper's launch shape must be this source's.
  if (r < 1) return (int)cudaErrorInvalidValue;
  if (path == kTeam) {
    if (r > MAX_R_COL || threads != COL_THREADS || smem != team_smem<T>(r) ||
        gx != (K + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK || gy != B ||
        gz != 1)
      return (int)cudaErrorInvalidValue;
    return (int)launch_team_r<T>(r, R, d, w, origin, tau, kprime, rows,
                                 scale, B, K, s);
  }
  if (path == kMma) {
    if (sizeof(T) != sizeof(double) || r <= MAX_R_COL ||
        threads != MMA_THREADS || smem != mma_smem() ||
        (long long)gx * MMA_BN < K || (long long)gy * MMA_BM < r || gz != B)
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma(reinterpret_cast<const double*>(R),
                           reinterpret_cast<const double*>(d),
                           reinterpret_cast<const double*>(w), origin,
                           reinterpret_cast<const double*>(tau), kprime,
                           reinterpret_cast<double*>(rows),
                           reinterpret_cast<double*>(scale), B, r, K,
                           dim3(gx, gy, gz), s);
  }
  if (path == kSimt) {
    if (r <= MAX_R_COL || threads != TILE_THREADS || smem != 0 ||
        (long long)gx * BN < K || (long long)gy * BM < r || gz != B)
      return (int)cudaErrorInvalidValue;
    rows_tile_kernel<T><<<dim3(gx, gy, gz), TILE_THREADS, 0, s>>>(
        R, d, w, origin, tau, kprime, rows, r, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int boundary_update_f64(const double* R, const double* d, const double* w,
                        const int* origin, const double* tau,
                        const int* kprime, double* rows, double* scale,
                        int B, int r, int K, int path, int gx, int gy, int gz,
                        int threads, int smem, void* stream) {
  return launch<double>(R, d, w, origin, tau, kprime, rows, scale, B, r, K,
                        path, gx, gy, gz, threads, smem, stream);
}

int boundary_update_f32(const float* R, const float* d, const float* w,
                        const int* origin, const float* tau,
                        const int* kprime, float* rows, float* scale, int B,
                        int r, int K, int path, int gx, int gy, int gz,
                        int threads, int smem, void* stream) {
  return launch<float>(R, d, w, origin, tau, kprime, rows, scale, B, r, K,
                       path, gx, gy, gz, threads, smem, stream);
}

}  // extern "C"
