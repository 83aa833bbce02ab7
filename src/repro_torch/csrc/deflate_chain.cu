// The DLAED2 close-pole deflation chain of one merge level, for Hopper
// (sm_90a): one warp per merge lane decides the rotations, and R's rows
// take them either on that warp (the fused route, few rows) or in a
// second launch across the card (the split route, many rows).
//
// Replaces: src/repro/core/merge.py::_close_pole_scan and ::_deflate_apply
// (XLA scans under a lax.switch over budget tiers and a lax.cond fallback,
// not Pallas), which the port ran as Python loops of some twenty torch
// launches a step plus two host syncs a level.
// Plain version beside it: repro_torch.core.merge._close_pole_scan.
//
// What it computes, per lane: walk the sorted poles carrying the last kept
// (not z-small) pole p; at each kept pole i with a predecessor, form
//
//   tau = hypot(z_p, z_i), c = z_i / tau, s = -z_p / tau, t = d_i - d_p
//
// and when |(t c) s| <= tol (and tau > 0) rotate: d_p, d_i become the
// weighted averages, z_p = 0, z_i = tau, R's columns p and i rotate by
// (c, s), p is marked deflated, and i becomes the carried pole.
//
// The decision -- a window scan, the sequential chain.  A pole's
// predecessor is fixed by the z-small mask alone (rotation-deflated poles
// are never a predecessor again: the carry moves to the partner), and a
// pole i >= start is untouched until its own step.  So the warp tests the
// 32 poles [start, start + 32) at once, each against its predecessor -- in
// the window (a shuffle of the original value) or before it (the carry) --
// and every test up to the first one that fires used the values the
// sequential chain would have seen.  The warp takes that one rotation and
// restarts at the pole after it.  Dependent steps per lane: one per window
// plus one per rotation, not K.  The decision reads no R.
//
// The application -- R's rows.  Rows are independent: a row's result
// depends on its own entries and the rotation list alone.  The list splits
// into cascades, runs where rotation j + 1's p is rotation j's f; once the
// carry passes a pole without a rotation, that pole is never touched
// again, so different cascades touch disjoint columns, and a cascade reads
// each of its columns from the input before it writes any.  So every
// column sees the plain chain's operations in the plain chain's order
// however rows and cascades are spread over threads:
//
//   fused (r < SPLIT_MIN_R): the deciding warp rotates R's two columns at
//     each rotation, its lanes splitting the rows (a lane reads only what
//     it wrote), on the wrapper's copy of R;
//   split: the deciding warp writes the lane's list -- (p, f), (c, s), the
//     index of each cascade's first rotation, and the counts -- while the
//     launch's other blocks copy R to the output (the chain keeps one
//     warp a lane busy, the copy the rest of the card); a second launch
//     gives every (lane, row, segment) a thread, a segment being a share
//     of the lane's cascades, and each thread walks its segment's
//     rotations forward on its row, carrying the cascade's running column
//     in a register: one load of each touched input entry, one store of
//     each touched output entry, the list broadcast to the warp.
//
// Bits: every operation is the plain chain's, in its order, explicitly
// rounded (rounded.cuh, so nvcc contracts nothing into an FMA), and
// hypot / hypotf is the CUDA math library's, the function torch.hypot runs
// on a CUDA tensor: both routes equal the plain chain run on the card bit
// for bit.  There is no budget, post-check or fallback: the window scan is
// the chain.
//
// What bounds it on this card: the longest lane's dependent steps (window
// tests and rotations), each a load of the window, two ballots, a hypot
// and two divisions in series (the chain probe below times one).  The
// fused route adds a round trip to R's columns to every rotation, at a
// stride of K between a warp's rows: cheap for a few rows, the whole cost
// at r = K.  The split route moves R in two passes: the copy (16-byte
// words) beside the chain, then the touched entries, where a warp's 32
// rows are 32 sectors a column.
#include <cstdint>

#include "rounded.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // merge lanes (warps) per block
constexpr int APPLY_THREADS = 128;  // rows per block of the application
constexpr int APPLY_UNROLL = 4;     // rotations a thread loads ahead
constexpr int MAX_SEGMENTS = 64;    // cascade segments per row, at most

template <typename T>
__device__ __forceinline__ T hyp(T a, T b);
template <>
__device__ __forceinline__ double hyp<double>(double a, double b) {
  return hypot(a, b);
}
template <>
__device__ __forceinline__ float hyp<float>(float a, float b) {
  return hypotf(a, b);
}

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// The last kept pole before the window: its current (d, z) and index
// (idx < 0: no kept pole yet).
template <typename T>
struct Carry {
  T d, z;
  int idx;
};

// The split route's rotation list of every lane (W, K) and its counts.
template <typename T>
struct RotList {
  int2* pf;                      // (p, f) of each rotation, chain order
  typename Pair<T>::type* cs;    // (c, s)
  int* starts;                   // index of each cascade's first rotation
  int* counts;                   // (W, 2): rotations, cascades
};

// One window's tests: every lane's pole against its predecessor.
template <typename T>
struct Test {
  unsigned kept;      // ballot: which of the window's poles are kept
  unsigned fire;      // ballot: which close-pair tests fired
  int p;              // this lane's predecessor (-1: none)
  T c, s, tau, dp, di;
};

template <typename T>
__device__ __forceinline__ Test<T> window_test(T d_i, T z_i, bool kept_i,
                                               int start, int lane,
                                               const Carry<T>& cy, T tol) {
  using R = Rn<T>;
  Test<T> t;
  t.kept = __ballot_sync(FULL, kept_i);
  const unsigned below = t.kept & ((1u << lane) - 1u);
  const int src = below ? 31 - __clz(below) : lane;
  const T dw = __shfl_sync(FULL, d_i, src);
  const T zw = __shfl_sync(FULL, z_i, src);
  const T pd = below ? dw : cy.d;
  const T pz = below ? zw : cy.z;
  t.p = below ? start + src : cy.idx;
  // merge._rotation, operation by operation.
  const T tau = hyp<T>(pz, z_i);
  const T tau_safe = tau > T(0) ? tau : T(1);
  const T c = R::div(z_i, tau_safe);
  const T s = R::div(-pz, tau_safe);
  const T dt = R::sub(d_i, pd);
  const bool close = t.p >= 0 && kept_i &&
                     R::abs(R::mul(R::mul(dt, c), s)) <= tol && tau > T(0);
  t.fire = __ballot_sync(FULL, close);
  t.c = c;
  t.s = s;
  t.tau = tau;
  t.dp = R::add(R::mul(R::mul(pd, c), c), R::mul(R::mul(d_i, s), s));
  t.di = R::add(R::mul(R::mul(pd, s), s), R::mul(R::mul(d_i, c), c));
  return t;
}

// R (n entries) to its output, by the blocks of the split route's chain
// launch that run no lane: 16-byte words when both ends allow them.
template <typename T>
__device__ void copy_entries(const T* __restrict__ src, T* __restrict__ dst,
                             size_t n, int block, int blocks) {
  const size_t stride = (size_t)blocks * blockDim.x;
  const size_t first = (size_t)block * blockDim.x + threadIdx.x;
  size_t k = first;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const size_t n4 = n * sizeof(T) / 16;
    for (; k + 3 * stride < n4; k += 4 * stride) {
      const uint4 a = s4[k], b = s4[k + stride], c = s4[k + 2 * stride],
                  e = s4[k + 3 * stride];
      d4[k] = a;
      d4[k + stride] = b;
      d4[k + 2 * stride] = c;
      d4[k + 3 * stride] = e;
    }
    for (; k < n4; k += stride) d4[k] = s4[k];
    k = n4 * 16 / sizeof(T) + first;
  }
  for (; k < n; k += stride) dst[k] = src[k];
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(WARPS * 32)
deflate_chain_kernel(const T* __restrict__ d, const T* __restrict__ z,
                     const uint8_t* __restrict__ small,
                     const T* __restrict__ tol, T* __restrict__ d_out,
                     T* __restrict__ z_out, uint8_t* __restrict__ defl,
                     T* __restrict__ R, const T* __restrict__ R_in,
                     RotList<T> list, int W, int r, int K) {
  using Rd = Rn<T>;
  const int chain_blocks = (W + WARPS - 1) / WARPS;
  if (kSplit && (int)blockIdx.x >= chain_blocks) {
    copy_entries<T>(R_in, R, (size_t)W * r * K, blockIdx.x - chain_blocks,
                    gridDim.x - chain_blocks);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= W) return;                       // the whole warp leaves
  const size_t off = (size_t)w * K;
  T* Rw = R + (size_t)w * r * K;
  const T tl = tol[w];
  Carry<T> cy{T(0), T(0), -1};
  int start = 0, nrot = 0, ncas = 0, last_f = -1;
  while (start < K) {
    const int i = start + lane;
    T d_i = T(0), z_i = T(0);
    bool kept_i = false;
    if (i < K) {
      d_i = d[off + i];
      z_i = z[off + i];
      const uint8_t sm = small[off + i];
      kept_i = sm == 0;
      // Copy the pole out; a rotation below may overwrite it later.
      d_out[off + i] = d_i;
      z_out[off + i] = z_i;
      defl[off + i] = sm;
    }
    const Test<T> t = window_test<T>(d_i, z_i, kept_i, start, lane, cy, tl);
    if (t.fire == 0) {
      if (t.kept) {
        const int last = 31 - __clz(t.kept);
        cy.d = __shfl_sync(FULL, d_i, last);
        cy.z = __shfl_sync(FULL, z_i, last);
        cy.idx = start + last;
      }
      start += 32;
      continue;
    }
    // The first close pair: every test before it saw exact values.
    const int fl = __ffs(t.fire) - 1;
    const int f = start + fl;
    const int p = __shfl_sync(FULL, t.p, fl);
    const T c = __shfl_sync(FULL, t.c, fl);
    const T s = __shfl_sync(FULL, t.s, fl);
    const T tau = __shfl_sync(FULL, t.tau, fl);
    const T dp = __shfl_sync(FULL, t.dp, fl);
    const T di = __shfl_sync(FULL, t.di, fl);
    __syncwarp();            // the window's copies land before the rotation
    if (lane == 0) {
      d_out[off + p] = dp;
      d_out[off + f] = di;
      z_out[off + p] = T(0);
      z_out[off + f] = tau;
      defl[off + p] = 1;
    }
    if constexpr (kSplit) {
      if (lane == 0) {
        list.pf[off + nrot] = make_int2(p, f);
        list.cs[off + nrot] = typename Pair<T>::type{c, s};
        if (p != last_f) list.starts[off + ncas] = nrot;
      }
      ncas += p != last_f;
      ++nrot;
      last_f = f;
    } else {
      // col_p <- c col_p + s col_i ; col_i <- (-s) col_p + c col_i
      for (int k = lane; k < r; k += 32) {
        T* row = Rw + (size_t)k * K;
        const T a = row[p];
        const T b = row[f];
        row[p] = Rd::add(Rd::mul(c, a), Rd::mul(s, b));
        row[f] = Rd::add(Rd::mul(-s, a), Rd::mul(c, b));
      }
      __syncwarp();          // ...and before the next rotation's writes
    }
    cy = Carry<T>{di, tau, f};
    start = f + 1;
  }
  if constexpr (kSplit) {
    if (lane == 0) {
      list.counts[2 * (size_t)w] = nrot;
      list.counts[2 * (size_t)w + 1] = ncas;
    }
  }
}

// The split route's second launch: thread (lane w, row, segment) applies
// the rotations of its share of lane w's cascades to one row of R, reading
// the input and writing the output (the chain launch copied the rest).
// Segment s takes cascades [ncas s / S, ncas (s + 1) / S).
template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
apply_rotations_kernel(const T* __restrict__ R_in, T* __restrict__ R_out,
                       const int2* __restrict__ pf,
                       const typename Pair<T>::type* __restrict__ cs,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts, int r, int K, int S) {
  using Rd = Rn<T>;
  const int w = blockIdx.x;
  const int row = blockIdx.y * APPLY_THREADS + threadIdx.x;
  const int seg = blockIdx.z;
  if (row >= r) return;
  const int nrot = counts[2 * (size_t)w], ncas = counts[2 * (size_t)w + 1];
  const int c0 = (int)((long long)ncas * seg / S);
  const int c1 = (int)((long long)ncas * (seg + 1) / S);
  if (c0 >= c1) return;
  const size_t lk = (size_t)w * K;
  const int begin = starts[lk + c0];
  const int end = c1 < ncas ? starts[lk + c1] : nrot;
  const size_t ro = ((size_t)w * r + row) * K;
  const T* in = R_in + ro;
  T* out = R_out + ro;
  T carry = T(0);
  int cf = -1;                     // the running column (-1: none)
  for (int j0 = begin; j0 < end; j0 += APPLY_UNROLL) {
    int2 e[APPLY_UNROLL];
    typename Pair<T>::type g[APPLY_UNROLL];
    T a[APPLY_UNROLL], b[APPLY_UNROLL];
    // Loads first: every input entry a segment reads is untouched input.
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const int j = min(j0 + u, end - 1);
      e[u] = pf[lk + j];
      g[u] = cs[lk + j];
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      a[u] = in[e[u].x];
      b[u] = in[e[u].y];
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      if (j0 + u < end) {
        const bool chained = e[u].x == cf;
        if (!chained && cf >= 0) out[cf] = carry;   // a cascade ended
        const T av = chained ? carry : a[u];
        const T c = g[u].x, s = g[u].y;
        out[e[u].x] = Rd::add(Rd::mul(c, av), Rd::mul(s, b[u]));
        carry = Rd::add(Rd::mul(-s, av), Rd::mul(c, b[u]));
        cf = e[u].y;
      }
    }
  }
  out[cf] = carry;
}

// The chain's dependent step on one warp with its operands in registers:
// the first window of (d, z, small) is loaded once, then ``reps`` window
// tests run back to back, each on the carry the previous one left (as
// the kernel leaves it after a rotation or after a window with none).
// No memory traffic inside the loop: the cycles per step are the
// latency floor of one step of the kernel's chain.
__global__ void chain_probe_kernel(const double* __restrict__ d,
                                   const double* __restrict__ z,
                                   const uint8_t* __restrict__ small,
                                   double tol, int reps, int K,
                                   long long* __restrict__ cycles,
                                   int* __restrict__ fires,
                                   double* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < K;
  const double d_i = in ? d[lane] : 0.0;
  const double z_i = in ? z[lane] : 0.0;
  const bool kept_i = in && small[lane] == 0;
  Carry<double> cy{0.0, 0.0, -1};
  int nfire = 0;
  __syncwarp();
  const long long t0 = clock64();
  for (int k = 0; k < reps; ++k) {
    const Test<double> t =
        window_test<double>(d_i, z_i, kept_i, 0, lane, cy, tol);
    if (t.fire) {
      const int fl = __ffs(t.fire) - 1;
      cy.d = __shfl_sync(FULL, t.di, fl);
      cy.z = __shfl_sync(FULL, t.tau, fl);
      cy.idx = fl;
      ++nfire;
    } else if (t.kept) {
      const int last = 31 - __clz(t.kept);
      cy.d = __shfl_sync(FULL, d_i, last);
      cy.z = __shfl_sync(FULL, z_i, last);
      cy.idx = last;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    *cycles = t1 - t0;
    *fires = nfire;
    *sink = cy.d + cy.z;
  }
}

// The wrapper's launch shape (kernels.deflate_chain.launch_shape) must be
// this source's: route 0 fused, 1 split.
template <typename T>
int launch(const T* d, const T* z, const uint8_t* small, const T* tol,
           T* d_out, T* z_out, uint8_t* defl, const T* R_in, T* R_out,
           int2* pf, T* cs, int* starts, int* counts, int W, int r, int K,
           int route, int threads, int chain_blocks, int copy_blocks,
           int apply_threads, int gy, int segments, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W < 1 || r < 0 || K < 1 || threads != WARPS * 32 ||
      chain_blocks != (W + WARPS - 1) / WARPS)
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (copy_blocks != 0 || apply_threads != 0 || gy != 0 || segments != 0)
      return (int)cudaErrorInvalidValue;
    deflate_chain_kernel<T, false><<<chain_blocks, threads, 0, st>>>(
        d, z, small, tol, d_out, z_out, defl, R_out, nullptr, RotList<T>{},
        W, r, K);
    return (int)cudaGetLastError();
  }
  if (route != 1 || r < 1 || copy_blocks < 1 ||
      apply_threads != APPLY_THREADS ||
      gy != (r + APPLY_THREADS - 1) / APPLY_THREADS || segments < 1 ||
      segments > MAX_SEGMENTS)
    return (int)cudaErrorInvalidValue;
  using P = typename Pair<T>::type;
  RotList<T> list{pf, reinterpret_cast<P*>(cs), starts, counts};
  deflate_chain_kernel<T, true><<<chain_blocks + copy_blocks, threads, 0,
                                  st>>>(d, z, small, tol, d_out, z_out, defl,
                                        R_out, R_in, list, W, r, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_rotations_kernel<T><<<dim3(W, gy, segments), APPLY_THREADS, 0, st>>>(
      R_in, R_out, pf, list.cs, starts, counts, r, K, segments);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int deflate_chain_f64(const double* d, const double* z, const uint8_t* small,
                      const double* tol, double* d_out, double* z_out,
                      uint8_t* defl, const double* R_in, double* R_out,
                      int2* pf, double* cs, int* starts, int* counts, int W,
                      int r, int K, int route, int threads, int chain_blocks,
                      int copy_blocks, int apply_threads, int gy,
                      int segments, void* stream) {
  return launch<double>(d, z, small, tol, d_out, z_out, defl, R_in, R_out, pf,
                        cs, starts, counts, W, r, K, route, threads,
                        chain_blocks, copy_blocks, apply_threads, gy,
                        segments, stream);
}

int deflate_chain_f32(const float* d, const float* z, const uint8_t* small,
                      const float* tol, float* d_out, float* z_out,
                      uint8_t* defl, const float* R_in, float* R_out,
                      int2* pf, float* cs, int* starts, int* counts, int W,
                      int r, int K, int route, int threads, int chain_blocks,
                      int copy_blocks, int apply_threads, int gy,
                      int segments, void* stream) {
  return launch<float>(d, z, small, tol, d_out, z_out, defl, R_in, R_out, pf,
                       cs, starts, counts, W, r, K, route, threads,
                       chain_blocks, copy_blocks, apply_threads, gy,
                       segments, stream);
}

int deflate_chain_probe_f64(const double* d, const double* z,
                            const uint8_t* small, double tol, int reps, int K,
                            long long* cycles, int* fires, double* sink,
                            void* stream) {
  chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      d, z, small, tol, reps, K, cycles, fires, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
