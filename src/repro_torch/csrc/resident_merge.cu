// Single-launch resident merge for Hopper (sm_90a): the whole small-K
// merge of one lane -- secular root solve, Gu-Eisenstat weights and the
// r selected-row update -- in one launch, with every O(K) vector kept in
// shared memory between the phases and none written to device memory.
//
// Replaces: src/repro/kernels/resident_merge.py::resident_merge_pallas_batch
// (the Pallas TPU kernel _resident_kernel; grid = problems).
// Plain version beside it:
// repro_torch.core.secular.secular_merge_resident_batched.
//
// The TPU kernel holds a dense (K, K) delta tile in VMEM, about 2 MiB at
// K = 512 in f64.  That does not fit a Hopper block's 227 KB of shared
// memory, so this kernel keeps only the O(K) vectors there -- d, z (whose
// slots take the weights once the roots are solved), d[origin], tau and
// the r rows, (4 + r) K itemsize bytes -- and recomputes each delta in
// registers when it needs it.
//
// What bounds it on this card: FP64 arithmetic -- O(niter K^2) terms for
// the solve and O(K^2) for the columns (one reciprocal each) and for the
// weights (one reciprocal each, secular::weight_factor), on O(r K) bytes --
// and, as for the root solve (secular_roots.cu), the latency of each
// root's chain of sums.  The levels it serves have few lanes where K is
// large: the n = 16384 solve merges 8 lanes at K = 2048, 16 at 1024, 32
// at 512.  One block per lane (the old design) kept 8-32 of the 132 SMs
// busy there, and at K = 64 left 192 of its 256 one-root threads idle.
//
// What the design does about it: each lane is merged by a thread-block
// cluster of C CTAs (C a power of two <= 16, chosen by the wrapper's
// launch_shape), each CTA of up to MAX_THREADS threads in teams of TEAM
// lanes (secular_common.cuh), so every thread has a root.  Every CTA
// loads the lane's d, z and R into its own shared memory and works on its
// share of the active items (and of the deflated ones): the kprime active
// roots are cut into C contiguous shares, so deflation does not leave a
// CTA idle.  Three phases, separated by cluster barriers:
//
//   1. roots: one team per root (the iteration of secular_common.cuh over
//      the poles in shared memory); origin and tau to device memory,
//      d[origin] and tau into this CTA's shared arrays;
//   2. weights: one team per pole, the ratio product over the active
//      roots split over the team's lanes (each lane's factors in root
//      order, combined by a butterfly of products and of the floored
//      counts, added as integers: secular::team_weight, which zhat and
//      the fused post-pass run too); a pole's weight replaces its z in
//      shared memory (z_i is read only by the team that owns pole i);
//   3. columns: one team per root column, the sums over the active poles
//      split over the lanes and combined as in phase 1, then normalised
//      (secular::team_column, the fused post-pass's pass B).
//
// Phases 2 and 3 need every root's d[origin] and tau, and every pole's
// weight.  After each cluster barrier a CTA copies the other CTAs' shares
// of those vectors out of their shared memory (distributed shared memory,
// cluster.map_shared_rank) into its own, so the merge stays one launch and
// no O(K) intermediate goes to device memory.  A last cluster barrier
// keeps every CTA's shared memory alive until the others have read it.
//
// Each output element has one writer (lane 0 of the team that owns it):
// no atomics.  Every sum and product runs in an order set by TEAM and the
// item's index alone, so a lane's result does not depend on C, the CTA
// size, or the batch it was launched in (batched == looped bit for bit).
//
// Sizes: TEAM = 8 (secular_common.cuh).  MAX_THREADS = 256 with two CTAs
// per SM (__launch_bounds__(256, 2): up to 128 registers a thread), 16
// warps an SM: the largest level's CTA (K = 2048, r = 3, float64) holds
// 7 x 16 KiB = 112 KiB, and two of them (plus the 1 KiB the hardware
// reserves for each) fit the SM's 228 KiB.  Smaller CTAs where a lane's
// share has fewer roots than MAX_THREADS / TEAM.  A cluster of 16 such
// CTAs needs the non-portable cluster size; how many clusters fit at once
// depends on how the card's SMs fall into GPCs (cudaOccupancyMaxActiveClusters,
// which the wrapper checks and the smoke test prints), so launch_shape
// splits a level's lanes as finely as K allows rather than sizing one
// wave: many small CTAs spread over the GPCs better than a few that
// nearly fill them.  The largest K follows from the shared-memory budget:
// (4 + r) K itemsize <= 232,448 bytes, so K <= 4150 at r = 3 in double
// precision, and K = 2048 is the largest merge size of the tree
// (repro_torch.core.tune.RESIDENT_THRESHOLD_CUDA).
#include <cooperative_groups.h>

#include "secular_common.cuh"

namespace cg = cooperative_groups;

namespace {

using secular::TEAM;
constexpr int MAX_THREADS = 256;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_R = 4;

template <typename T>
struct SmemPoles {
  const T* d;
  const T* z;
  int n;      // active poles (kprime)
  int lane;   // this thread's lane in its team

  template <class F>
  __device__ void sweep(F f) {
#pragma unroll 4
    for (int i = lane; i < n; i += TEAM) {
      const T zi = z[i];
      f(i, d[i], zi * zi);
    }
  }
};

// The active roots (phase 2) and poles (phase 3) of the lane in shared
// memory, visited for secular::team_weight and secular::team_column.
template <typename T>
struct SmemRoots {
  const T* dorg;
  const T* tau;
  const T* d;
  int n;      // active roots (kprime)
  int lane;

  template <class F>
  __device__ void sweep(F f) {
    for (int j = lane; j < n; j += TEAM) f(j, dorg[j], tau[j], d[j]);
  }
};

template <typename T>
struct SmemColumnPoles {
  const T* d;
  const T* w;
  const T* R;  // r x K
  int n;       // active poles (kprime)
  int K;
  int lane;

  template <class F>
  __device__ void sweep(F f) {
    for (int i = lane; i < n; i += TEAM) f(i, d[i], w[i], R + i, K);
  }
};

// This CTA's share of the items [0, K): the active items [0, kp) and the
// deflated ones [kp, K) are each cut into C contiguous pieces.
struct Share {
  int kp, K, act, def;  // act, def: piece lengths

  __device__ Share(int kp_, int K_, int C)
      : kp(kp_), K(K_), act((kp_ + C - 1) / C), def((K_ - kp_ + C - 1) / C) {}
  __device__ int owner(int idx) const {
    return idx < kp ? idx / act : (idx - kp) / def;
  }
  // Calls f(idx) for the items of CTA c, item number m = first, first +
  // step, ... (active items first).
  template <class F>
  __device__ void for_each(int c, int first, int step, F f) const {
    const int a0 = c * act, a1 = min(kp, a0 + act);
    const int d0 = kp + c * def, d1 = min(K, d0 + def);
    const int na = a1 > a0 ? a1 - a0 : 0;
    const int nd = d1 > d0 ? d1 - d0 : 0;
    for (int m = first; m < na + nd; m += step)
      f(m < na ? a0 + m : d0 + (m - na));
  }
};

// Copy the items of [0, K) that other CTAs own from their shared memory
// into this CTA's array of the same name.
template <typename T>
__device__ void gather(cg::cluster_group& cluster, const Share& sh,
                       unsigned rank, T* s) {
  for (int idx = threadIdx.x; idx < sh.K; idx += blockDim.x) {
    const unsigned owner = (unsigned)sh.owner(idx);
    if (owner != rank) s[idx] = cluster.map_shared_rank(s, owner)[idx];
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
resident_merge_kernel(const T* __restrict__ d, const T* __restrict__ z,
                      const T* __restrict__ R, const T* __restrict__ rho,
                      const int* __restrict__ kprime,
                      int* __restrict__ origin, T* __restrict__ tau,
                      T* __restrict__ zhat, T* __restrict__ rows,
                      int r, int K, int niter, int use_zhat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_d = reinterpret_cast<T*>(smem_raw);
  T* s_z = s_d + K;                      // z; the weights from phase 2 on
  T* s_w = s_z;
  T* s_dorg = s_z + K;
  T* s_tau = s_dorg + K;
  T* s_R = s_tau + K;                    // r x K

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int b = (int)blockIdx.x / C;
  const size_t off = (size_t)b * K;
  const T* Rb = R + (size_t)b * r * K;
  const int kp = kprime[b];
  const T rh = rho[b];
  const secular::Team team;
  const int first = (int)threadIdx.x / TEAM;
  const int nteams = (int)blockDim.x / TEAM;
  const Share sh(kp, K, C);

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s_d[i] = d[off + i];
    s_z[i] = z[off + i];
  }
  for (int i = threadIdx.x; i < r * K; i += blockDim.x) s_R[i] = Rb[i];
  __syncthreads();

  // ---- phase 1: root solve, one team per root --------------------------
  SmemPoles<T> src{s_d, s_z, kp, team.lane};
  sh.for_each(rank, first, nteams, [&](int j) {
    int o = j;
    T t = T(0);
    if (j < kp)
      secular::solve_root<T>(
          team, j, K, kp, rh, niter, src, [&](int i) { return s_d[i]; },
          [&](int i) { return s_z[i] * s_z[i]; }, &o, &t);
    if (team.lane == 0) {
      origin[off + j] = o;
      tau[off + j] = t;
      s_dorg[j] = s_d[o];
      s_tau[j] = t;
    }
  });
  cluster.sync();
  gather(cluster, sh, rank, s_dorg);
  gather(cluster, sh, rank, s_tau);
  __syncthreads();

  // ---- phase 2: weights, one team per pole -----------------------------
  SmemRoots<T> roots{s_dorg, s_tau, s_d, kp, team.lane};
  const T gaps = kp > 0 ? secular::gap_scale<T>(s_d[0], s_d[kp - 1]) : T(1);
  sh.for_each(rank, first, nteams, [&](int i) {
    const T z_i = s_z[i];
    T out = z_i;
    if (use_zhat && i < kp) {
      const T d_i = s_d[i];
      // lam_i - d_i
      out = secular::team_weight<T>(team, i, d_i, z_i,
                                    (s_dorg[i] - d_i) + s_tau[i], (double)rh,
                                    gaps, roots);
    }
    if (team.lane == 0) {
      zhat[off + i] = out;
      s_w[i] = out;
    }
  });
  cluster.sync();
  gather(cluster, sh, rank, s_w);
  // No CTA leaves (and frees its shared memory) while another reads it.
  cluster.sync();

  // ---- phase 3: columns, one team per root -----------------------------
  T* rb = rows + (size_t)b * r * K;
  SmemColumnPoles<T> cols{s_d, s_w, s_R, kp, K, team.lane};
  sh.for_each(rank, first, nteams, [&](int j) {
    if (j >= kp) {
      if (team.lane == 0)
        for (int q = 0; q < r; ++q) rb[(size_t)q * K + j] = s_R[q * K + j];
      return;
    }
    T acc[MAX_R];
    const T scale = secular::team_column<T, MAX_R>(team, s_dorg[j], s_tau[j],
                                                   r, cols, acc);
    if (team.lane == 0) {
#pragma unroll
      for (int q = 0; q < MAX_R; ++q)
        if (q < r) rb[(size_t)q * K + j] = acc[q] / scale;
    }
  });
}

template <typename T>
cudaError_t prepare(size_t smem, int C) {
  cudaError_t err = cudaFuncSetAttribute(
      resident_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess || C <= 8) return err;
  return cudaFuncSetAttribute(resident_merge_kernel<T>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B,
               int C, int threads, size_t smem, cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

bool bad_shape(int r, int C, int threads, int team) {
  return r < 1 || r > MAX_R || C < 1 || C > MAX_CLUSTER || (C & (C - 1)) ||
         threads < 32 || threads > MAX_THREADS || threads % 32 ||
         team != TEAM;
}

template <typename T>
int max_clusters(int r, int K, int C, int threads, int team, int* out) {
  if (bad_shape(r, C, threads, team)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 + r) * K * sizeof(T);
  cudaError_t err = prepare<T>(smem, C);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, 1, C, threads, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, resident_merge_kernel<T>,
                                             &cfg);
}

template <typename T>
int launch(const T* d, const T* z, const T* R, const T* rho,
           const int* kprime, int* origin, T* tau, T* zhat, T* rows, int B,
           int r, int K, int niter, int use_zhat, int C, int threads,
           int team, void* stream) {
  if (bad_shape(r, C, threads, team)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 + r) * K * sizeof(T);
  cudaError_t err = prepare<T>(smem, C);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, B, C, threads, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, resident_merge_kernel<T>, d, z, R, rho,
                           kprime, origin, tau, zhat, rows, r, K, niter,
                           use_zhat);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How many clusters of C CTAs of this shape the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 means the cluster cannot be
// scheduled.
int resident_merge_max_clusters_f64(int r, int K, int C, int threads,
                                    int team, int* out) {
  return max_clusters<double>(r, K, C, threads, team, out);
}

int resident_merge_max_clusters_f32(int r, int K, int C, int threads,
                                    int team, int* out) {
  return max_clusters<float>(r, K, C, threads, team, out);
}

int resident_merge_f64(const double* d, const double* z, const double* R,
                       const double* rho, const int* kprime, int* origin,
                       double* tau, double* zhat, double* rows, int B, int r,
                       int K, int niter, int use_zhat, int C, int threads,
                       int team, void* stream) {
  return launch<double>(d, z, R, rho, kprime, origin, tau, zhat, rows, B, r,
                        K, niter, use_zhat, C, threads, team, stream);
}

int resident_merge_f32(const float* d, const float* z, const float* R,
                       const float* rho, const int* kprime, int* origin,
                       float* tau, float* zhat, float* rows, int B, int r,
                       int K, int niter, int use_zhat, int C, int threads,
                       int team, void* stream) {
  return launch<float>(d, z, R, rho, kprime, origin, tau, zhat, rows, B, r,
                       K, niter, use_zhat, C, threads, team, stream);
}

}  // extern "C"
