// Batched Sturm-sequence eigenvalue counts for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sturm_count.py::sturm_count_pallas_batch
// (the Pallas TPU kernel _sturm_kernel; grid = problems x shift blocks).
// Plain versions beside it: repro_torch.core.bisect.sturm_count_plain,
// repro_torch.core.bisect._count_and_newton and
// repro_torch.core.bisect.bisect_tree_plain.
//
// Three entry points share one recurrence (LAPACK DSTEBZ's negcount with
// the pivmin floor): for every (problem b, shift x)
//
//   q_0 = d_0 - x;            q_i = (d_i - x) - e2_{i-1} / q_{i-1}
//   q <- -pivmin where |q| < pivmin;   count = #{i : q_i <= 0}
//
//   * sturm_count        -- the count alone (the Pallas kernel's function);
//   * sturm_count_newton -- the count plus s = sum_i q_i' / q_i, the
//     derivative of log|det(T - xI)| that the Newton polish and the
//     mixed-precision refine loop step on.  The JAX package runs that
//     sweep as an XLA scan (repro.core.bisect._count_and_newton), not in
//     Pallas; it gets a kernel here because eager PyTorch would run it as
//     a Python loop over the n rows, about ten launches per row.
//   * sturm_bisect_tree  -- m halvings of every bisection bracket in one
//     launch: the complete bisection tree of depth m is counted, one node
//     a thread, and one thread per bracket walks it with the host loop's
//     rule (core/bisect.py::_slice_targets).  Each node is the explicitly
//     rounded 0.5 * (a + b) of its parent's interval, exactly the
//     midpoint the host loop forms on that branch, so s steps of the walk
//     give s trips of the loop bit for bit, whatever m.
//
// Exactness: counts, derivative sums and walked brackets must equal the
// plain versions' bit for bit, in float64 and float32.  Every operation
// is an explicitly rounded intrinsic (rounded.cuh): division stays IEEE
// whatever the flags, and the derivative's dq = -1 + u * r is never
// contracted into an FMA -- eager PyTorch on the CPU rounds the product
// and the sum separately, and so does this kernel.
//
// What bounds it on this card.  Each shift's sweep is a chain of n
// dependent IEEE divisions (the recurrence's irreducible dependence,
// about 79 ns a row in float64: the chain probe below).  A bisection trip
// of a range solve (B = 1, k = 64 brackets) has 64 such chains, a few
// warps on a card of 132 SMs: it can never beat one chain, however the
// rows are staged, and the only way to a faster range solve is fewer
// trips.  So the tree kernel spends the idle card on speculation: at
// depth m it runs k (2^m - 1) chains in the time of one, and does m trips'
// work.  The certify sweep (B = 64, S = 2n = 8192 shifts) fills the card
// many times over; there the instructions a row bound it (the division's
// Newton sequence on the FP64 pipe, the loads and the loop around them).
//
// What the design does about it:
//   * Rows are staged as interleaved (d_i, e2_{i-1}) pairs, one 16-byte
//     (float64) or 8-byte (float32) shared-memory broadcast a row, in
//     tiles of TILE_ROWS rows, double-buffered: the next tile is copied
//     with cp.async while the current one is walked, one barrier a tile.
//   * One chain a thread everywhere.  The tree (bound by its chains'
//     latency) loads UNROLL rows of the tile into registers while the
//     UNROLL rows before them are computed, so no load sits on a chain.
//     The count sweeps read each row as they go: other warps hide the
//     load, and the registers the prefetch would take buy warps (on an
//     H100 at the certify shape: 3.4 ms with the prefetch, 2.7 without).
//   * Not several shifts a thread: with the one-shift loop above, two
//     shifts sharing each row's load ran no faster on an H100 (count 2.75
//     against 2.71 ms, Newton 5.07 against 5.07 at the certify shape;
//     slower below it), as each division's slow-path branch keeps the
//     compiler from interleaving a thread's chains.
//   * The Newton sweep has two chains a shift (q and r = q'/q).  Where few
//     shifts leave the card idle (a range solve's polish, small refine
//     sweeps) each shift gets two threads (newton_split_kernel), so the
//     two chains run side by side; from NEWTON_SPLIT_BELOW shifts an SM
//     (kernels/sturm_count.py::launch_shape) one thread walks both, as
//     the split's extra threads and barriers then cost more than they
//     hide.
//   * The tree kernel runs whole brackets in a block: floor(256 / nodes)
//     brackets of 2^m - 1 node chains (one bracket at m = 8); the node
//     counts meet in shared memory and one thread per bracket walks them.
//   * The count stays a compare (q <= 0) and not the pivot's sign bit:
//     a NaN pivot (a NaN shift, or an e * e that overflows, both reach
//     the public sturm_count) is never counted by the plain version but
//     would be by its sign bit, which the card does not fix.
//   * Every output has exactly one writer and no reduction crosses
//     threads, so batched and looped launches give identical results.
//   * The grid is flattened to one dimension so B * blocks may exceed
//     65535.
//
// Sizes (derived for Hopper, not taken from the TPU kernel's 128-lane
// shift block): at most MAX_THREADS = 256 threads a block.  A tile of
// TILE_ROWS = 1024 pairs is 16 KiB in float64, two of them 32 KiB, so
// shared memory allows 7 blocks an SM and registers bound the rest; a
// barrier every 1024 rows costs under one row's chain latency per tile.
// UNROLL = 8 rows of registers in flight (the chain probe's depth).
#include <cuda_pipeline.h>

#include "rounded.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int TILE_ROWS = 1024;
constexpr int UNROLL = 8;
constexpr int MAX_DEPTH = 8;

template <typename T>
struct PairOf;
template <>
struct PairOf<double> {
  using type = double2;
};
template <>
struct PairOf<float> {
  using type = float2;
};

template <typename T>
__device__ __forceinline__ T floor_pivot(T q, T pivmin) {
  return Rn<T>::abs(q) < pivmin ? -pivmin : q;
}

// One shift's chain: its shift x, pivot q, count and, with NEWTON,
// r = q'/q and its running sum.
template <typename T, bool NEWTON>
struct Chain {
  T x, q, r, acc;
  int cnt;

  // Row 0: q_0 = d_0 - x, q_0' = -1.
  __device__ __forceinline__ void start(T d0, T piv) {
    using R = Rn<T>;
    q = floor_pivot(R::sub(d0, x), piv);
    cnt = q <= T(0);
    if (NEWTON) {
      r = R::div(T(-1), q);
      acc = r;
    }
  }

  // Row i >= 1 from its pair (d_i, e2_{i-1}).
  __device__ __forceinline__ void row(T di, T ei, T piv) {
    using R = Rn<T>;
    const T u = R::div(ei, q);                       // e2_{i-1} / q_{i-1}
    const T qn = floor_pivot(R::sub(R::sub(di, x), u), piv);
    cnt += qn <= T(0);
    if (NEWTON) {
      const T dq = R::add(T(-1), R::mul(u, r));      // q_i' via r_{i-1}
      r = R::div(dq, qn);
      acc = R::add(acc, r);
    }
    q = qn;
  }
};

// Copy rows [1 + first, 1 + first + m) of one problem into a tile of
// pairs: tile[t] = (d[1 + first + t], e2[first + t]).
template <typename T>
__device__ __forceinline__ void fill_tile(typename PairOf<T>::type* tile,
                                          const T* __restrict__ d,
                                          const T* __restrict__ e2,
                                          int first, int m) {
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    __pipeline_memcpy_async(&tile[t].x, d + 1 + first + t, sizeof(T));
    __pipeline_memcpy_async(&tile[t].y, e2 + first + t, sizeof(T));
  }
  __pipeline_commit();
}

// Walk m rows of a tile through the chain.  With PREFETCH (the tree:
// bound by its chains' latency) each thread holds UNROLL rows in
// registers while the UNROLL rows before them are computed, so no load
// sits on the chain.  Without (the count sweeps) each row is read from
// shared memory as it goes: other warps hide the load, and the registers
// the prefetch would take buy more warps.
template <typename T, bool NEWTON, bool PREFETCH>
__device__ __forceinline__ void walk_tile(
    Chain<T, NEWTON>& ch, const typename PairOf<T>::type* tile, int m,
    T piv) {
  using P = typename PairOf<T>::type;
  constexpr int U = UNROLL;
  int t = 0;
  if constexpr (!PREFETCH) {
#pragma unroll 4
    for (; t < m; ++t) {
      const P p = tile[t];
      ch.row(p.x, p.y, piv);
    }
    return;
  }
  if (m >= U) {
    P cur[U], nxt[U] = {};
#pragma unroll
    for (int j = 0; j < U; ++j) cur[j] = tile[j];
    for (; t + U <= m; t += U) {
      if (t + 2 * U <= m) {
#pragma unroll
        for (int j = 0; j < U; ++j) nxt[j] = tile[t + U + j];
      }
#pragma unroll
      for (int j = 0; j < U; ++j) ch.row(cur[j].x, cur[j].y, piv);
#pragma unroll
      for (int j = 0; j < U; ++j) cur[j] = nxt[j];
    }
  }
  for (; t < m; ++t) {
    const P p = tile[t];
    ch.row(p.x, p.y, piv);
  }
}

// Sweep rows 1 .. n-1 of problem (d, e2) through the chain.  Every
// thread of the block takes part in the copies and barriers; only
// threads with ``active`` walk.
template <typename T, bool NEWTON, bool PREFETCH>
__device__ __forceinline__ void sweep(Chain<T, NEWTON>& ch,
                                      const T* __restrict__ d,
                                      const T* __restrict__ e2, int n,
                                      T piv, bool active) {
  using P = typename PairOf<T>::type;
  __shared__ P tiles[2][TILE_ROWS];
  const int rows = n - 1;
  const int ntiles = (rows + TILE_ROWS - 1) / TILE_ROWS;
  if (ntiles > 0) fill_tile<T>(tiles[0], d, e2, 0, min(rows, TILE_ROWS));
  for (int i = 0; i < ntiles; ++i) {
    __pipeline_wait_prior(0);            // this thread's copies of tile i
    __syncthreads();                     // everyone's; tile i-1 walked
    if (i + 1 < ntiles) {
      const int first = (i + 1) * TILE_ROWS;
      fill_tile<T>(tiles[(i + 1) & 1], d, e2, first,
                   min(rows - first, TILE_ROWS));
    }
    if (active)
      walk_tile<T, NEWTON, PREFETCH>(
          ch, tiles[i & 1], min(rows - i * TILE_ROWS, TILE_ROWS), piv);
  }
}

// Counts (and derivative sums) of S shifts per problem, one a thread:
// thread t of block j of problem b takes shift j * threads + t.
template <typename T, bool NEWTON>
__global__ void __launch_bounds__(MAX_THREADS)
count_kernel(const T* __restrict__ d, const T* __restrict__ e2,
             const T* __restrict__ shifts, const T* __restrict__ pivmin,
             int* __restrict__ count, T* __restrict__ deriv, int n, int S,
             int blocks_per_problem) {
  const int b = blockIdx.x / blocks_per_problem;
  const int s = (blockIdx.x % blocks_per_problem) * blockDim.x + threadIdx.x;
  const T* db = d + (size_t)b * n;
  const T piv = pivmin[b];
  Chain<T, NEWTON> ch;
  // Shifts past S repeat the last one; their results are not written.
  ch.x = shifts[(size_t)b * S + (s < S ? s : S - 1)];
  ch.start(db[0], piv);
  sweep<T, NEWTON, false>(ch, db, e2 + (size_t)b * (n - 1), n, piv, s < S);
  if (s < S) {
    count[(size_t)b * S + s] = ch.cnt;
    if (NEWTON) deriv[(size_t)b * S + s] = ch.acc;
  }
}

// The Newton sweep in the latency regime (few shifts: the polish of a
// range solve, small refine sweeps).  The pivot chain q and the
// derivative chain r = q'/q each take a dependent IEEE division a row;
// one thread walking both issues them in series -- each division's
// slow-path branch keeps the scheduler from overlapping the two -- at
// about twice one chain.  So each shift gets two threads in different
// warps: a q walker (the pivots and the count, its rows in registers one
// stage ahead, as the chain probe holds them) hands each row's (u, q) to
// an r walker through shared memory, and the r walker follows one stage
// of SPLIT_ROWS rows behind; one barrier a stage.  Same operations in the
// same order as the one-thread sweep, so the same bits.
constexpr int SPLIT_SHIFTS = 64;
constexpr int SPLIT_ROWS = 16;

template <typename T>
__global__ void __launch_bounds__(2 * SPLIT_SHIFTS)
newton_split_kernel(const T* __restrict__ d, const T* __restrict__ e2,
                    const T* __restrict__ shifts,
                    const T* __restrict__ pivmin, int* __restrict__ count,
                    T* __restrict__ deriv, int n, int S,
                    int blocks_per_problem) {
  using R = Rn<T>;
  using P = typename PairOf<T>::type;
  constexpr int SR = SPLIT_ROWS;
  __shared__ P hand[2][SR][SPLIT_SHIFTS];
  const int b = blockIdx.x / blocks_per_problem;
  const bool walks_q = threadIdx.x < SPLIT_SHIFTS;
  const int lane = walks_q ? threadIdx.x : threadIdx.x - SPLIT_SHIFTS;
  const int s = (blockIdx.x % blocks_per_problem) * SPLIT_SHIFTS + lane;
  const T x = shifts[(size_t)b * S + (s < S ? s : S - 1)];
  const T* db = d + (size_t)b * n;
  const T* eb = e2 + (size_t)b * (n - 1);
  const T piv = pivmin[b];
  const int rows = n - 1;                  // rows 1 .. n-1 in stages
  const int stages = (rows + SR - 1) / SR;

  // Row 0 (both walkers form q_0): q_0 = d_0 - x, q_0' = -1.
  T q = floor_pivot(R::sub(db[0], x), piv);
  int cnt = q <= T(0);
  T r = R::div(T(-1), q);
  T acc = r;
  T cd[SR], ce[SR], nd[SR] = {}, ne[SR] = {};
  if (walks_q) {
#pragma unroll
    for (int t = 0; t < SR; ++t) {
      cd[t] = t < rows ? db[1 + t] : T(0);
      ce[t] = t < rows ? eb[t] : T(0);
    }
  }
  for (int j = 0; j <= stages; ++j) {
    if (walks_q && j < stages) {
      const int first = j * SR;
      if (j + 1 < stages) {
#pragma unroll
        for (int t = 0; t < SR; ++t) {
          const int k = first + SR + t;
          nd[t] = k < rows ? db[1 + k] : T(0);
          ne[t] = k < rows ? eb[k] : T(0);
        }
      }
      auto row = [&](int t) {
        const T u = R::div(ce[t], q);             // e2_{i-1} / q_{i-1}
        q = floor_pivot(R::sub(R::sub(cd[t], x), u), piv);
        cnt += q <= T(0);
        hand[j & 1][t][lane] = P{u, q};
      };
      // A full stage runs unguarded; only the last may be ragged.
      const int m = min(rows - first, SR);
      if (m == SR) {
#pragma unroll
        for (int t = 0; t < SR; ++t) row(t);
      } else {
#pragma unroll
        for (int t = 0; t < SR; ++t)
          if (t < m) row(t);
      }
#pragma unroll
      for (int t = 0; t < SR; ++t) {
        cd[t] = nd[t];
        ce[t] = ne[t];
      }
    }
    if (!walks_q && j > 0) {
      // The stage's (u, q) pairs come in first, so no shared load waits
      // on the r chain.
      const int m = min(rows - (j - 1) * SR, SR);
      P h[SR];
#pragma unroll
      for (int t = 0; t < SR; ++t) h[t] = hand[(j - 1) & 1][t][lane];
      auto row = [&](int t) {
        const T dq = R::add(T(-1), R::mul(h[t].x, r));  // q_i' via r_{i-1}
        r = R::div(dq, h[t].y);
        acc = R::add(acc, r);
      };
      if (m == SR) {
#pragma unroll
        for (int t = 0; t < SR; ++t) row(t);
      } else {
#pragma unroll
        for (int t = 0; t < SR; ++t)
          if (t < m) row(t);
      }
    }
    __syncthreads();
  }
  if (s < S) {
    if (walks_q)
      count[(size_t)b * S + s] = cnt;
    else
      deriv[(size_t)b * S + s] = acc;
  }
}

// ``steps`` halvings of k brackets per problem.  Block j of problem b
// holds brackets j * per_block ... (per_block of them, floor(256 /
// nodes)); thread t counts node t % nodes (heap order: node i's children
// are 2i + 1 and 2i + 2) of bracket t / nodes.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
tree_kernel(const T* __restrict__ d, const T* __restrict__ e2,
            const T* __restrict__ pivmin, const T* __restrict__ tol,
            const int* __restrict__ targets, const T* __restrict__ lo,
            const T* __restrict__ hi, T* __restrict__ lo_out,
            T* __restrict__ hi_out, int* __restrict__ counts, int n, int k,
            int depth, int steps, int per_block, int blocks_per_problem) {
  using R = Rn<T>;
  __shared__ int node_count[MAX_THREADS];
  const int nodes = (1 << depth) - 1;
  const int b = blockIdx.x / blocks_per_problem;
  const int local = threadIdx.x / nodes;
  const int node = threadIdx.x - local * nodes;
  const int j = (blockIdx.x % blocks_per_problem) * per_block + local;
  const bool active = local < per_block && j < k;
  const size_t at = (size_t)b * k + (active ? j : 0);
  const T* db = d + (size_t)b * n;
  const T piv = pivmin[b];

  // The node's shift: descend from the root along the bits of node + 1
  // below its leading one (0: left, 1: right), halving as the loop does.
  Chain<T, false> ch;
  {
    T a = lo[at], c = hi[at];
    const int path = node + 1;
    for (int l = 30 - __clz(path); l >= 0; --l) {
      const T mid = R::mul(T(0.5), R::add(a, c));
      if ((path >> l) & 1)
        a = mid;
      else
        c = mid;
    }
    ch.x = R::mul(T(0.5), R::add(a, c));
  }
  ch.start(db[0], piv);
  sweep<T, false, true>(ch, db, e2 + (size_t)b * (n - 1), n, piv, active);
  node_count[threadIdx.x] = ch.cnt;
  if (active) counts[at * nodes + node] = ch.cnt;
  __syncthreads();

  // The host loop's rule, one writer per bracket: live = (hi - lo) > tol;
  // above = count(mid) > target; hi = mid where above, lo = mid where not.
  // A bracket that is not live never changes again, so the walk stops.
  if (active && node == 0) {
    T a = lo[at], c = hi[at];
    const T tl = tol[b];
    const int target = targets[at];
    const int* cnt = node_count + local * nodes;
    int i = 0;
    for (int s = 0; s < steps && R::sub(c, a) > tl; ++s) {
      const T mid = R::mul(T(0.5), R::add(a, c));
      if (cnt[i] > target) {
        c = mid;
        i = 2 * i + 1;
      } else {
        a = mid;
        i = 2 * i + 2;
      }
    }
    lo_out[at] = a;
    hi_out[at] = c;
  }
}

// One thread walking one shift's chain over the problem's rows: the same
// recurrence as the sweeps, with each group of CHAIN_UNROLL rows loaded
// into registers while the group before it is computed, so the loads stay
// off the dependent chain.  What it times (clock64 around the sweep, and
// the launch between CUDA events) is n times the latency of one row's
// dependent operations (the division, two subtractions, the pivmin
// floor): the least time any kernel walking the chain row by row takes
// for one trip.  A measurement, not a step of any solve.
constexpr int CHAIN_UNROLL = 8;

template <typename T>
__global__ void chain_probe_kernel(const T* __restrict__ d,
                                   const T* __restrict__ e2, T x, T piv,
                                   int n, int* __restrict__ count,
                                   long long* __restrict__ cycles) {
  using R = Rn<T>;
  constexpr int U = CHAIN_UNROLL;
  const long long t0 = clock64();
  T q = floor_pivot(R::sub(d[0], x), piv);
  int cnt = q <= T(0);
  T cd[U], ce[U], nd[U] = {}, ne[U] = {};
  int start = 1;
  if (start + U <= n) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      cd[j] = d[start + j];
      ce[j] = e2[start + j - 1];
    }
  }
  for (; start + U <= n; start += U) {
    const int next = start + U;
    if (next + U <= n) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        nd[j] = d[next + j];
        ne[j] = e2[next + j - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      q = floor_pivot(R::sub(R::sub(cd[j], x), R::div(ce[j], q)), piv);
      cnt += q <= T(0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      cd[j] = nd[j];
      ce[j] = ne[j];
    }
  }
  for (; start < n; ++start) {
    q = floor_pivot(R::sub(R::sub(d[start], x), R::div(e2[start - 1], q)),
                    piv);
    cnt += q <= T(0);
  }
  const long long t1 = clock64();
  *count = cnt;
  *cycles = t1 - t0;
}

// ``split`` (the wrapper's pick: kernels/sturm_count.py::launch_shape)
// gives each shift two threads (newton_split_kernel, the Newton sweep
// only); else each shift one thread of ``threads`` a block (a multiple
// of 32, at most MAX_THREADS).
template <typename T, bool NEWTON>
int launch(const T* d, const T* e2, const T* shifts, const T* pivmin,
           int* count, T* deriv, int B, int n, int S, int split,
           int threads, void* stream) {
  if (split) {
    if (!NEWTON) return (int)cudaErrorInvalidValue;
    const int per = (S + SPLIT_SHIFTS - 1) / SPLIT_SHIFTS;
    newton_split_kernel<T><<<B * per, 2 * SPLIT_SHIFTS, 0,
                             (cudaStream_t)stream>>>(
        d, e2, shifts, pivmin, count, deriv, n, S, per);
    return (int)cudaGetLastError();
  }
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int per = (S + threads - 1) / threads;
  count_kernel<T, NEWTON><<<B * per, threads, 0, (cudaStream_t)stream>>>(
      d, e2, shifts, pivmin, count, deriv, n, S, per);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tree(const T* d, const T* e2, const T* pivmin, const T* tol,
                const int* targets, const T* lo, const T* hi, T* lo_out,
                T* hi_out, int* counts, int B, int n, int k, int depth,
                int steps, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH || steps < 0 || steps > depth)
    return (int)cudaErrorInvalidValue;
  const int nodes = (1 << depth) - 1;
  const int per_block = MAX_THREADS / nodes;
  const int per = (k + per_block - 1) / per_block;
  const int threads = (per_block * nodes + 31) / 32 * 32;
  tree_kernel<T><<<B * per, threads, 0, (cudaStream_t)stream>>>(
      d, e2, pivmin, tol, targets, lo, hi, lo_out, hi_out, counts, n, k,
      depth, steps, per_block, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sturm_count_f64(const double* d, const double* e2, const double* shifts,
                    const double* pivmin, int* count, int B, int n, int S,
                    int split, int threads, void* stream) {
  return launch<double, false>(d, e2, shifts, pivmin, count, nullptr, B, n,
                               S, split, threads, stream);
}

int sturm_count_f32(const float* d, const float* e2, const float* shifts,
                    const float* pivmin, int* count, int B, int n, int S,
                    int split, int threads, void* stream) {
  return launch<float, false>(d, e2, shifts, pivmin, count, nullptr, B, n,
                              S, split, threads, stream);
}

int sturm_count_newton_f64(const double* d, const double* e2,
                           const double* shifts, const double* pivmin,
                           int* count, double* deriv, int B, int n, int S,
                           int split, int threads, void* stream) {
  return launch<double, true>(d, e2, shifts, pivmin, count, deriv, B, n, S,
                              split, threads, stream);
}

int sturm_count_newton_f32(const float* d, const float* e2,
                           const float* shifts, const float* pivmin,
                           int* count, float* deriv, int B, int n, int S,
                           int split, int threads, void* stream) {
  return launch<float, true>(d, e2, shifts, pivmin, count, deriv, B, n, S,
                             split, threads, stream);
}

int sturm_bisect_tree_f64(const double* d, const double* e2,
                          const double* pivmin, const double* tol,
                          const int* targets, const double* lo,
                          const double* hi, double* lo_out, double* hi_out,
                          int* counts, int B, int n, int k, int depth,
                          int steps, void* stream) {
  return launch_tree<double>(d, e2, pivmin, tol, targets, lo, hi, lo_out,
                             hi_out, counts, B, n, k, depth, steps, stream);
}

int sturm_bisect_tree_f32(const float* d, const float* e2,
                          const float* pivmin, const float* tol,
                          const int* targets, const float* lo,
                          const float* hi, float* lo_out, float* hi_out,
                          int* counts, int B, int n, int k, int depth,
                          int steps, void* stream) {
  return launch_tree<float>(d, e2, pivmin, tol, targets, lo, hi, lo_out,
                            hi_out, counts, B, n, k, depth, steps, stream);
}

int sturm_chain_probe_f64(const double* d, const double* e2, double x,
                          double pivmin, int* count, long long* cycles,
                          int n, void* stream) {
  chain_probe_kernel<double><<<1, 1, 0, (cudaStream_t)stream>>>(
      d, e2, x, pivmin, n, count, cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
