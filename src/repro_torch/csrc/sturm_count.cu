// Batched Sturm-sequence eigenvalue counts for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sturm_count.py::sturm_count_pallas_batch
// (the Pallas TPU kernel _sturm_kernel; grid = problems x shift blocks).
// Plain versions beside it: repro_torch.core.bisect.sturm_count_plain and
// repro_torch.core.bisect._count_and_newton.
//
// Two entry points share one recurrence (LAPACK DSTEBZ's negcount with
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
//     a Python loop over the n rows, about ten launches per row: ~160k
//     launches for one polish step at n = 16384, and the refine loop of
//     precision="mixed" runs up to 96 such sweeps per round.
//
// Exactness: the counts must equal the plain versions' bit for bit, in
// float64 and float32.  Every operation is written as an explicitly
// rounded intrinsic (__ddiv_rn, __dsub_rn, __dmul_rn, __dadd_rn and the
// float forms): division stays IEEE whatever the flags, and the
// derivative's dq = -1 + u * r is never contracted into an FMA -- eager
// PyTorch on the CPU rounds the product and the sum separately, and so
// does this kernel, which makes s bit-equal to the plain version too.
//
// What bounds it on this card: latency, not throughput.  Each shift's
// sweep is a chain of n dependent divisions (the recurrence's
// irreducible dependence), so a bisection trip of B = 1 problem at
// n = 16384 with k = 64 shifts is one block walking 16384 dependent
// FP64 divisions, whatever the FP64 rate.  The certify sweep (B = 64,
// S = 2n = 8192 shifts) has enough independent chains to fill the card,
// and there the FP64 divisions bound it.
//
// What the design does about it: one thread per (problem, shift), so
// every chain runs in its own registers with no cross-thread reduction
// (each output has exactly one writer: batched and looped launches give
// identical results).  One block per (problem, block of shifts); the
// grid is flattened to one dimension so B * blocks may exceed 65535.
// Every thread of a block walks the same rows, so the problem's d and e2
// are staged through shared memory in tiles of ROW_TILE rows and read at
// one address by the whole block (a broadcast, no bank conflicts):
// device memory is read once per block, not once per shift.
//
// Sizes (derived for Hopper, not taken from the TPU kernel's 128-lane
// shift block): SHIFTS_PER_BLOCK = 64 threads (two warps), so a range
// trip of k = 64 targets is exactly one block and the certify sweep at
// B = 64, n = 4096 is 8192 blocks, about 62 per SM.  A tile of
// ROW_TILE = 256 rows is 4 KiB of shared memory in float64 (d and e2),
// so the shared memory never limits the 32 resident blocks of an SM.
#include "rounded.cuh"

namespace {

constexpr int SHIFTS_PER_BLOCK = 64;
constexpr int ROW_TILE = 256;

template <typename T>
__device__ __forceinline__ T floor_pivot(T q, T pivmin) {
  return Rn<T>::abs(q) < pivmin ? -pivmin : q;
}

template <typename T, bool NEWTON>
__global__ void __launch_bounds__(SHIFTS_PER_BLOCK)
sturm_kernel(const T* __restrict__ d, const T* __restrict__ e2,
             const T* __restrict__ shifts, const T* __restrict__ pivmin,
             int* __restrict__ count, T* __restrict__ deriv, int n, int S,
             int blocks_per_problem) {
  using R = Rn<T>;
  __shared__ T sd[ROW_TILE];
  __shared__ T se[ROW_TILE];
  const int b = blockIdx.x / blocks_per_problem;
  const int s = (blockIdx.x % blocks_per_problem) * SHIFTS_PER_BLOCK +
                threadIdx.x;
  const T* db = d + (size_t)b * n;
  const T* eb = e2 + (size_t)b * (n - 1);
  // Threads past S repeat the last shift so that every thread takes part
  // in the tile loads; their results are not written.
  const T x = shifts[(size_t)b * S + (s < S ? s : S - 1)];
  const T piv = pivmin[b];

  T q = floor_pivot(R::sub(db[0], x), piv);
  int cnt = q <= T(0);
  T r = T(0), acc = T(0);
  if (NEWTON) {
    r = R::div(T(-1), q);                // q_0' = -1
    acc = r;
  }
  for (int start = 1; start < n; start += ROW_TILE) {
    const int m = n - start < ROW_TILE ? n - start : ROW_TILE;
    __syncthreads();
    for (int t = threadIdx.x; t < m; t += SHIFTS_PER_BLOCK) {
      sd[t] = db[start + t];
      se[t] = eb[start + t - 1];
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      const T u = R::div(se[t], q);      // e2_{i-1} / q_{i-1}
      const T qn = floor_pivot(R::sub(R::sub(sd[t], x), u), piv);
      cnt += qn <= T(0);
      if (NEWTON) {
        const T dq = R::add(T(-1), R::mul(u, r));   // q_i' via r_{i-1}
        r = R::div(dq, qn);
        acc = R::add(acc, r);
      }
      q = qn;
    }
  }
  if (s < S) {
    count[(size_t)b * S + s] = cnt;
    if (NEWTON) deriv[(size_t)b * S + s] = acc;
  }
}

// One thread walking one shift's chain over the problem's rows: the same
// recurrence as sturm_kernel, with each group of CHAIN_UNROLL rows loaded
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

template <typename T, bool NEWTON>
int launch(const T* d, const T* e2, const T* shifts, const T* pivmin,
           int* count, T* deriv, int B, int n, int S, void* stream) {
  const int per = (S + SHIFTS_PER_BLOCK - 1) / SHIFTS_PER_BLOCK;
  sturm_kernel<T, NEWTON><<<B * per, SHIFTS_PER_BLOCK, 0,
                            (cudaStream_t)stream>>>(
      d, e2, shifts, pivmin, count, deriv, n, S, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sturm_count_f64(const double* d, const double* e2, const double* shifts,
                    const double* pivmin, int* count, int B, int n, int S,
                    void* stream) {
  return launch<double, false>(d, e2, shifts, pivmin, count, nullptr, B, n,
                               S, stream);
}

int sturm_count_f32(const float* d, const float* e2, const float* shifts,
                    const float* pivmin, int* count, int B, int n, int S,
                    void* stream) {
  return launch<float, false>(d, e2, shifts, pivmin, count, nullptr, B, n,
                              S, stream);
}

int sturm_count_newton_f64(const double* d, const double* e2,
                           const double* shifts, const double* pivmin,
                           int* count, double* deriv, int B, int n, int S,
                           void* stream) {
  return launch<double, true>(d, e2, shifts, pivmin, count, deriv, B, n, S,
                              stream);
}

int sturm_count_newton_f32(const float* d, const float* e2,
                           const float* shifts, const float* pivmin,
                           int* count, float* deriv, int B, int n, int S,
                           void* stream) {
  return launch<float, true>(d, e2, shifts, pivmin, count, deriv, B, n, S,
                             stream);
}

int sturm_chain_probe_f64(const double* d, const double* e2, double x,
                          double pivmin, int* count, long long* cycles,
                          int n, void* stream) {
  chain_probe_kernel<double><<<1, 1, 0, (cudaStream_t)stream>>>(
      d, e2, x, pivmin, n, count, cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
