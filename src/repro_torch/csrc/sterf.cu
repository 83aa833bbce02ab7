// Eigenvalue-only implicit-shift QL iteration (LAPACK xSTERF analogue) for
// Hopper (sm_90a): the paper's lowest-memory baseline.
//
// Replaces: src/repro/core/sterf.py::_sterf_jit, an XLA while_loop over a
// masked lax.scan -- not a Pallas kernel.  In eager PyTorch every QL step
// would be some fifteen launches, about 10^9 at n = 4096, so the loop is a
// kernel here, as the Sturm count's derivative sweep became one.
// Plain version beside it: repro_torch.core.sterf.sterf_plain.
//
// The iteration is the JAX package's, operation for operation:
//
//   * find m, the first index >= l with |e_m| <= eps (|d_m| + |d_m+1|)
//     (or m = n - 1); if m == l, d_l has converged and l advances;
//   * otherwise one QL sweep over [l, m]: the shift from the top 2 x 2 of
//     the block, then the rotation chain from i = m - 1 down to l, which
//     stops early (premature deflation) when a rotation's radius is zero;
//   * at most 30 n outer steps in all, each a converged index or a sweep.
//
// The JAX scan masks every sweep to the full length n; this kernel walks
// only [l, m - 1], with the same result.  The eigenvalues come back
// unsorted; the wrapper sorts them.
//
// What bounds it on this card: latency.  QL is one dependent chain per
// problem -- each rotation needs the previous one's (s, c, p, g) -- about
// 1.1 n^2 rotations for a uniform matrix, whatever the FP64 rate.  The
// first port ran one thread per problem at 317 ns per rotation (n = 4096,
// PERF.md) with three costs in series: a serial split search (one
// dependent load and compare per row, about as many steps as rotations),
// (d, e) in device memory read back through L1/L2 by every sweep and
// search, and a rotation chain of a hypot and two correctly rounded
// divisions.  The design here takes each on:
//
//   * One warp per problem.  The split search is a ballot: each lane tests
//     one row of a 32-row window and __ballot_sync + __ffs find the first
//     hit, 32 rows per step.  Lane 0 runs the sweep; a __syncwarp() orders
//     its writes before the next search.
//   * (d, e) in shared memory: the block holds up to 14528 rows of both in
//     float64 (29056 in float32; kernels.sterf.launch_shape).  A larger
//     problem starts in device memory and moves its active rows [l, n)
//     into shared memory once they fit: QL converges from the top, rows
//     below l are final, so at n = 16384 about four fifths of the
//     rotations already run from shared memory.  In both places the sweep
//     loads its rows PREFETCH rotations ahead (it walks down one row per
//     rotation, so its next rows are known long before the chain needs
//     them, and they are never rows it has written), which keeps the loads
//     off the chain.
//   * A shorter rotation: r and 1 / r from one reciprocal square root of
//     f^2 + g^2 -- the hardware estimate (rsqrt.approx.ftz) and one Newton
//     step, as secular_common.cuh's rcp does for the reciprocal -- and
//     s = f (1/r), c = g (1/r) as products.  Where f^2 + g^2 leaves
//     [RSQRT_LO, RSQRT_HI] (a square may overflow, underflow or lose bits
//     to subnormals) the rotation takes hypot and the two divisions, a
//     branch the data of a normal matrix never reaches; it is also the one
//     path that can see r = 0.  So that the common case has no branch at
//     all, a sweep runs its rotations in groups of PREFETCH without the
//     test and checks the range once per group; a group that left it runs
//     again from its start with the test (the same bits where it held).
//
// Every other operation is an explicitly rounded intrinsic (rounded.cuh)
// and the Newton steps are explicit FMAs, so nvcc contracts nothing: a
// result depends on the problem only, never on the batch or the launch's
// regime (shared or device memory), and batched and looped launches agree
// bit for bit.  Against the plain loop, which takes 1 / math.sqrt where
// this takes the estimate, the trajectories part by rounding only.
//
// sterf_chain_probe_f64 (below) runs the same rotation on one thread, on
// rows held in registers: the chain's latency without loads, stores or
// search, the bound that PERF.md sets beside the kernel's time.
#include <cfloat>
#include <cmath>

#include "rounded.cuh"

namespace {

constexpr int WARP = 32;
// Rows a sweep loads ahead of its rotation chain.
constexpr int PREFETCH = 4;
// Rows of the chain probe's register block.
constexpr int PROBE_ROWS = 16;

template <typename T> struct Ql;
template <> struct Ql<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  // f^2 + g^2 in [RSQRT_LO, RSQRT_HI] takes the reciprocal square root
  // (core/sterf.py RSQRT_RANGE).
  __device__ static double lo() { return 0x1p-960; }   // RSQRT_LO = 2^-960
  __device__ static double hi() { return 0x1p960; }    // RSQRT_HI = 2^960
  __device__ static double hyp(double a, double b) { return hypot(a, b); }
  // 1 / sqrt(x) for x in [lo, hi]: the hardware estimate (MUFU.RSQ64H,
  // from the upper word of x: relative error about 2^-21) and one cubic
  // Newton step, y (1 + e/2 + 3e^2/8) with e = 1 - x y^2, whose error
  // (about 2.5 (2^-21)^3) is below the step's own rounding.
  __device__ static double rsqrt(double x) {
    double y;
    asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
    const double e = __fma_rn(-x, __dmul_rn(y, y), 1.0);
    return __fma_rn(__dmul_rn(y, e), __fma_rn(0.375, e, 0.5), y);
  }
};
template <> struct Ql<float> {
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float lo() { return 0x1p-120f; }   // RSQRT_LO = 2^-120
  __device__ static float hi() { return 0x1p120f; }    // RSQRT_HI = 2^120
  __device__ static float hyp(float a, float b) { return hypotf(a, b); }
  __device__ static float rsqrt(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    const float e = __fmaf_rn(-__fmul_rn(x, y), y, 1.0f);
    return __fmaf_rn(__fmul_rn(0.5f, y), e, y);
  }
};

// (d, e) rows [off, n) of a problem held from p[0] on: the shared-memory
// window of a problem too large to fit whole (indexed as the full rows).
template <typename T>
struct Window {
  T* p;
  int off;
  __device__ __forceinline__ T& operator[](int i) const { return p[i - off]; }
};

// The rotation state a sweep carries from row to row.
template <typename T>
struct Chain {
  T s, c, p, g;
};

// The shift of a sweep over [l, m] (d_l, d_l+1, e_l, d_m of the block):
// the chain's starting state.
template <typename T>
__device__ __forceinline__ Chain<T> sweep_start(T d_l, T d_l1, T e_l,
                                                T d_m) {
  using R = Rn<T>;
  const T g0 = R::div(R::sub(d_l1, d_l),
                      R::mul(T(2), e_l == T(0) ? T(1) : e_l));
  const T r0 = Ql<T>::hyp(g0, T(1));
  const T denom = R::add(g0, g0 >= T(0) ? r0 : -r0);
  return {T(1), T(1), T(0),
          R::add(R::sub(d_m, d_l), R::div(e_l, denom == T(0) ? T(1)
                                                             : denom))};
}

// The rotation's tail, once s and c are known: updates the chain and sets
// the new d_{i+1}.
template <typename T>
__device__ __forceinline__ void rotate_tail(Chain<T>& ch, T s, T c, T b,
                                            T d_i, T d_i1, T& d_out) {
  using R = Rn<T>;
  const T gn = R::sub(d_i1, ch.p);
  const T r2 = R::add(R::mul(R::sub(d_i, gn), s),
                      R::mul(R::mul(T(2), c), b));
  ch.s = s;
  ch.c = c;
  ch.p = R::mul(s, r2);
  d_out = R::add(gn, ch.p);
  ch.g = R::sub(R::mul(c, r2), b);
}

template <typename T>
__device__ __forceinline__ bool in_range(T ss) {
  return ss >= Ql<T>::lo() && ss <= Ql<T>::hi();
}

// One rotation at row i (e_i, d_i; d_i1 is the old d_{i+1}) without the
// guard: r and 1 / r from the reciprocal square root of f^2 + g^2.  Sets
// the new e_{i+1} (r) and d_{i+1} and clears ``ok`` when f^2 + g^2 is out
// of range (the results are then to be discarded).  No branch.
template <typename T>
__device__ __forceinline__ void rotate_fast(Chain<T>& ch, T e_i, T d_i,
                                            T d_i1, T& e_out, T& d_out,
                                            bool& ok) {
  using R = Rn<T>;
  const T f = R::mul(ch.s, e_i);
  const T b = R::mul(ch.c, e_i);
  const T ss = R::add(R::mul(f, f), R::mul(ch.g, ch.g));
  const T ir = Ql<T>::rsqrt(ss);
  ok = ok && in_range(ss);
  e_out = R::mul(ss, ir);
  rotate_tail(ch, R::mul(f, ir), R::mul(ch.g, ir), b, d_i, d_i1, d_out);
}

// The same rotation with the guard: outside the range r = hypot(f, g) and
// s, c by division.  Returns false on premature deflation (r == 0), where
// d_{i+1} gets d_i1 - p and the chain is left as it was.  Inside the range
// it computes what rotate_fast does, bit for bit.
template <typename T>
__device__ __forceinline__ bool rotate(Chain<T>& ch, T e_i, T d_i, T d_i1,
                                       T& e_out, T& d_out) {
  using R = Rn<T>;
  const T f = R::mul(ch.s, e_i);
  const T b = R::mul(ch.c, e_i);
  const T ss = R::add(R::mul(f, f), R::mul(ch.g, ch.g));
  T s, c;
  if (in_range(ss)) {
    const T ir = Ql<T>::rsqrt(ss);
    e_out = R::mul(ss, ir);
    s = R::mul(f, ir);
    c = R::mul(ch.g, ir);
  } else {
    const T r = Ql<T>::hyp(f, ch.g);
    e_out = r;
    if (r == T(0)) {
      d_out = R::sub(d_i1, ch.p);
      return false;
    }
    s = R::div(f, r);
    c = R::div(ch.g, r);
  }
  rotate_tail(ch, s, c, b, d_i, d_i1, d_out);
  return true;
}

// One QL sweep on the block [l, m] of (d, e), run by one thread; returns
// the rotations run.  Rotation i reads e[i], d[i] and the old d[i+1] (read
// by rotation i + 1) and writes e[i+1] and d[i+1], so the rows below i are
// untouched until their turn: they are loaded PREFETCH rows ahead, a group
// at a time, with no hazard.  Each whole group runs rotate_fast, straight-
// line code; a group in which some f^2 + g^2 left the range runs again from
// its start with the guard (the same bits wherever the range held).  The
// last rows, fewer than a group, take the guard directly.
template <typename T, class V>
__device__ __forceinline__ long long ql_sweep(V d, V e, int l, int m, int n) {
  using R = Rn<T>;
  constexpr int P = PREFETCH;
  Chain<T> ch = sweep_start<T>(d[l], d[l + 1 < n - 1 ? l + 1 : n - 1], e[l],
                               d[m]);
  T d_i1 = d[m];
  T cd[P], ce[P], nd[P], ne[P], eo[P], dn[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int ii = m - 1 - k;
    cd[k] = ii >= l ? d[ii] : T(0);
    ce[k] = ii >= l ? e[ii] : T(0);
  }
  int i = m - 1;
  for (; i - (P - 1) >= l; i -= P) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int ii = i - P - k;
      nd[k] = ii >= l ? d[ii] : T(0);
      ne[k] = ii >= l ? e[ii] : T(0);
    }
    const Chain<T> ch0 = ch;
    const T d0 = d_i1;
    bool ok = true;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      rotate_fast<T>(ch, ce[k], cd[k], d_i1, eo[k], dn[k], ok);
      d_i1 = cd[k];
    }
    if (!ok) {
      ch = ch0;
      d_i1 = d0;
      for (int k = 0; k < P; ++k) {
        const bool go = rotate<T>(ch, ce[k], cd[k], d_i1, eo[k], dn[k]);
        if (!go) {
          for (int q = 0; q <= k; ++q) {
            e[i - q + 1] = eo[q];
            d[i - q + 1] = dn[q];
          }
          e[m] = T(0);
          return m - (i - k);
        }
        d_i1 = cd[k];
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      e[i - k + 1] = eo[k];
      d[i - k + 1] = dn[k];
      cd[k] = nd[k];
      ce[k] = ne[k];
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int ii = i - k;
    if (ii < l) break;
    const bool go = rotate<T>(ch, ce[k], cd[k], d_i1, e[ii + 1], d[ii + 1]);
    if (!go) {
      e[m] = T(0);
      return m - ii;
    }
    d_i1 = cd[k];
  }
  d[l] = R::sub(d[l], ch.p);
  e[l] = ch.g;
  e[m] = T(0);
  return m - l;
}

// The first m >= l with |e_m| <= eps (|d_m| + |d_m+1|), or n - 1: every
// lane of the warp tests one row of a 32-row window.  Returns the same m
// on every lane.
template <typename T, class V>
__device__ __forceinline__ int split_at(V d, V e, int l, int n, int lane) {
  using R = Rn<T>;
  const T eps = Ql<T>::eps();
  for (int base = l;; base += WARP) {
    const int k = base + lane;
    bool hit = true;
    if (k < n - 1)
      hit = R::abs(e[k]) <= R::mul(eps, R::add(R::abs(d[k]),
                                                R::abs(d[k + 1])));
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) return base + __ffs(ballot) - 1;
  }
}

// The iteration on (d, e) (e[n-1] == 0) by one warp, from row l and
// outer step it, until it converges, reaches cap steps, or the active rows
// [l, n) are no more than ``fit``.  Returns the rotations run.
template <typename T, class V>
__device__ __forceinline__ long long ql_iterate(V d, V e, int n,
                                                long long cap, int lane,
                                                int& l, long long& it,
                                                int fit) {
  long long steps = 0;
  while (l < n && it < cap && n - l > fit) {
    const int m = split_at<T>(d, e, l, n, lane);
    if (m == l) {
      ++l;
    } else {
      if (lane == 0) steps += ql_sweep<T>(d, e, l, m, n);
      __syncwarp();
    }
    ++it;
  }
  return steps;
}

// One warp per problem.  (d, e) work in d_out and e_work while the
// active rows [l, n) exceed the ``rows`` that the block's shared memory
// holds, then in shared memory (rows == n: from the start); rows already
// converged are never touched again.
template <typename T>
__global__ void __launch_bounds__(WARP)
sterf_kernel(const T* __restrict__ d_in, const T* __restrict__ e_in,
             T* __restrict__ d_out, T* __restrict__ e_work,
             long long* __restrict__ steps_out, int n, long long cap,
             int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const T* di = d_in + (size_t)b * n;
  const T* ei = e_in + (size_t)b * (n - 1);
  T* dg = d_out + (size_t)b * n;
  T* eg = e_work + (size_t)b * n;
  long long steps = 0, it = 0;
  int l = 0;
  if (rows < n) {
    for (int i = lane; i < n; i += WARP) {
      dg[i] = di[i];
      eg[i] = i + 1 < n ? ei[i] : T(0);     // e[n-1]: zero sentinel
    }
    __syncwarp();
    steps = ql_iterate<T>(dg, eg, n, cap, lane, l, it, rows);
  }
  if (rows > 0 && l < n && it < cap) {
    const int l0 = l;
    const Window<T> sd{reinterpret_cast<T*>(smem_raw), l0};
    const Window<T> se{sd.p + rows, l0};
    for (int i = l0 + lane; i < n; i += WARP) {
      sd[i] = rows < n ? dg[i] : di[i];
      se[i] = rows < n ? eg[i] : (i + 1 < n ? ei[i] : T(0));
    }
    __syncwarp();
    steps += ql_iterate<T>(sd, se, n, cap, lane, l, it, 0);
    __syncwarp();
    for (int i = l0 + lane; i < n; i += WARP) {
      dg[i] = sd[i];
      eg[i] = se[i];
    }
  }
  if (lane == 0) steps_out[b] = steps;
}

template <typename T>
int launch(const T* d, const T* e, T* d_out, T* e_work, long long* steps,
           int B, int n, long long cap, int threads, int rows, int smem,
           void* stream) {
  // The wrapper's launch shape must be this source's: one warp, and the
  // shared memory of ``rows`` rows of (d, e).
  if (threads != WARP || rows < 0 || rows > n ||
      (long long)smem != 2LL * rows * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sterf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  sterf_kernel<T><<<B, WARP, smem, (cudaStream_t)stream>>>(
      d, e, d_out, e_work, steps, n, cap, rows);
  return (int)cudaGetLastError();
}

// The chain probe: one thread runs the sweep's rotation (rotate_fast) on
// PROBE_ROWS + 1 rows held in registers -- no loads, stores or search on
// the chain.  It starts as the first sweep of the block [0, PROBE_ROWS]
// starts (the shift), then runs reps * PROBE_ROWS rotations, cycling
// through the rows with the chain carried on; the rows' new values are
// kept for the last pass only (the others are off the chain and the
// compiler drops them).  With reps == 1 it is the kernel's first sweep of
// that block, and writes the block's rows as that sweep leaves them.
// in_range is 0 if some f^2 + g^2 left the reciprocal square root's range
// (the results and the timing then do not stand for the kernel's).
__global__ void chain_probe_kernel(const double* __restrict__ d,
                                   const double* __restrict__ e, int reps,
                                   double* __restrict__ d_out,
                                   double* __restrict__ e_out,
                                   long long* __restrict__ rotations,
                                   long long* __restrict__ cycles,
                                   int* __restrict__ in_range_out) {
  using R = Rn<double>;
  constexpr int U = PROBE_ROWS;
  double rd[U + 1], re[U], od[U + 1], oe[U + 1];
#pragma unroll
  for (int k = 0; k <= U; ++k) rd[k] = d[k];
#pragma unroll
  for (int k = 0; k < U; ++k) re[k] = e[k];
  const long long t0 = clock64();
  Chain<double> ch = sweep_start<double>(rd[0], rd[1], re[0], rd[U]);
  bool ok = true;
  for (int rep = 0; rep < reps; ++rep) {
    double d_i1 = rd[U];
#pragma unroll
    for (int k = U - 1; k >= 0; --k) {
      rotate_fast<double>(ch, re[k], rd[k], d_i1, oe[k + 1], od[k + 1], ok);
      d_i1 = rd[k];
    }
  }
  const long long t1 = clock64();
  od[0] = R::sub(rd[0], ch.p);
  oe[0] = ch.g;
  oe[U] = 0.0;
#pragma unroll
  for (int k = 0; k <= U; ++k) {
    d_out[k] = od[k];
    e_out[k] = oe[k];
  }
  *rotations = (long long)reps * U;
  *cycles = t1 - t0;
  *in_range_out = ok;
}

}  // namespace

extern "C" {

int sterf_f64(const double* d, const double* e, double* d_out,
              double* e_work, long long* steps, int B, int n, long long cap,
              int threads, int rows, int smem, void* stream) {
  return launch<double>(d, e, d_out, e_work, steps, B, n, cap, threads, rows,
                        smem, stream);
}

int sterf_f32(const float* d, const float* e, float* d_out, float* e_work,
              long long* steps, int B, int n, long long cap, int threads,
              int rows, int smem, void* stream) {
  return launch<float>(d, e, d_out, e_work, steps, B, n, cap, threads, rows,
                       smem, stream);
}

int sterf_chain_probe_f64(const double* d, const double* e, int reps,
                          double* d_out, double* e_out, long long* rotations,
                          long long* cycles, int* in_range, void* stream) {
  chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      d, e, reps, d_out, e_out, rotations, cycles, in_range);
  return (int)cudaGetLastError();
}

}  // extern "C"
