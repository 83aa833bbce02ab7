// The DLAED2 close-pole deflation chain of one merge level, for Hopper
// (sm_90a): one warp per merge lane, one launch per level.
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
// Why a window scan is the sequential chain: a pole's predecessor is fixed
// by the z-small mask alone (rotation-deflated poles are never a
// predecessor again: the carry moves to the partner), and a pole i >= start
// is untouched until its own step.  So the warp tests the 32 poles
// [start, start + 32) at once, each against its predecessor -- in the
// window (a shuffle of the original value) or before it (the carry) -- and
// every test up to the first one that fires used the values the
// sequential chain would have seen.  The warp applies that one rotation
// and restarts at the pole after it.  Dependent steps per lane: one per
// window plus one per rotation, not K.
//
// Bits: every operation is the plain chain's, in its order, explicitly
// rounded (rounded.cuh, so nvcc contracts nothing into an FMA), and
// hypot / hypotf is the CUDA math library's, the function torch.hypot runs
// on a CUDA tensor: the kernel equals the plain chain run on the card bit
// for bit.  There is no budget, post-check or fallback: the window scan is
// the chain.
//
// What bounds it on this card: the longest lane's dependent steps (window
// tests and rotations), each a global load, two ballots, a hypot and two
// divisions in series; the bytes (d, z, R read and written once) are far
// below.  d and z are read from device memory (L1 after a restart); the
// carry and the window's predecessors come from registers and shuffles.
// R is rotated in place on the wrapper's copy: lanes split its r rows, so
// a lane only ever reads the R entries it wrote itself.
#include <cstdint>

#include "rounded.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // merge lanes (warps) per block

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

// The last kept pole before the window: its current (d, z) and index
// (idx < 0: no kept pole yet).
template <typename T>
struct Carry {
  T d, z;
  int idx;
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
deflate_chain_kernel(const T* __restrict__ d, const T* __restrict__ z,
                     const uint8_t* __restrict__ small,
                     const T* __restrict__ tol, T* __restrict__ d_out,
                     T* __restrict__ z_out, T* __restrict__ R,
                     uint8_t* __restrict__ defl, int W, int r, int K) {
  using Rd = Rn<T>;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= W) return;                       // the whole warp leaves
  const size_t off = (size_t)w * K;
  T* Rw = R + (size_t)w * r * K;
  const T tl = tol[w];
  Carry<T> cy{T(0), T(0), -1};
  int start = 0;
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
    // col_p <- c col_p + s col_i ; col_i <- (-s) col_p + c col_i
    for (int k = lane; k < r; k += 32) {
      T* row = Rw + (size_t)k * K;
      const T a = row[p];
      const T b = row[f];
      row[p] = Rd::add(Rd::mul(c, a), Rd::mul(s, b));
      row[f] = Rd::add(Rd::mul(-s, a), Rd::mul(c, b));
    }
    __syncwarp();            // ...and before the next rotation's writes
    cy = Carry<T>{di, tau, f};
    start = f + 1;
  }
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

template <typename T>
int launch(const T* d, const T* z, const uint8_t* small, const T* tol,
           T* d_out, T* z_out, T* R, uint8_t* defl, int W, int r, int K,
           void* stream) {
  const int blocks = (W + WARPS - 1) / WARPS;
  deflate_chain_kernel<T><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      d, z, small, tol, d_out, z_out, R, defl, W, r, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int deflate_chain_f64(const double* d, const double* z, const uint8_t* small,
                      const double* tol, double* d_out, double* z_out,
                      double* R, uint8_t* defl, int W, int r, int K,
                      void* stream) {
  return launch<double>(d, z, small, tol, d_out, z_out, R, defl, W, r, K,
                        stream);
}

int deflate_chain_f32(const float* d, const float* z, const uint8_t* small,
                      const float* tol, float* d_out, float* z_out, float* R,
                      uint8_t* defl, int W, int r, int K, void* stream) {
  return launch<float>(d, z, small, tol, d_out, z_out, R, defl, W, r, K,
                       stream);
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
