// Eigenvalue-only implicit-shift QL iteration (LAPACK xSTERF analogue) for
// Hopper (sm_90a): the paper's lowest-memory baseline.
//
// Replaces: src/repro/core/sterf.py::_sterf_jit, an XLA while_loop over a
// masked lax.scan -- not a Pallas kernel.  In eager PyTorch every QL step
// would be some fifteen launches, about 10^9 at n = 4096, so the loop is a
// kernel here, as the Sturm count's derivative sweep became one.
// Plain version beside it: repro_torch.core.sterf.sterf_plain.
//
// One thread per problem runs the whole iteration on its own (d, e),
// exactly as the JAX package does it, operation for operation:
//
//   * find m, the first index >= l with |e_m| <= eps (|d_m| + |d_m+1|)
//     (or m = n - 1); if m == l, d_l has converged and l advances;
//   * otherwise one QL sweep over [l, m]: the shift from the top 2 x 2 of
//     the block, then the rotation chain from i = m - 1 down to l, which
//     stops early (premature deflation) when a rotation's radius is zero;
//   * at most 30 n outer steps in all, each a converged index or a sweep.
//
// The JAX scan masks every sweep to the full length n; this kernel walks
// only [l, m - 1], with the same result.  Every operation except hypot is
// an explicitly rounded intrinsic (rounded.cuh), so nvcc contracts
// nothing: the kernel follows the plain version's rounding step by step,
// and only hypot, which differs between math libraries, keeps the two
// from being equal bit for bit.  The eigenvalues come back unsorted; the
// wrapper sorts them.
//
// What bounds it on this card: latency.  QL is one dependent chain per
// problem -- each rotation needs the previous one's (s, c, p, g), through
// a hypot and two divisions -- about 1.1 n^2 rotations for a uniform
// matrix, at a few hundred cycles each, whatever the FP64 rate.  A batch
// of problems runs one chain per thread.  (d, e) live in the output and
// scratch rows in device memory (at n = 16384 the pair is 256 KiB, more
// than a block's shared memory); a sweep loads each row one rotation
// ahead, so the loads do not wait on the chain.
#include <cfloat>
#include <cmath>

#include "rounded.cuh"

namespace {

constexpr int THREADS = 32;

template <typename T> struct Eps;
template <> struct Eps<double> {
  __device__ static double v() { return DBL_EPSILON; }
};
template <> struct Eps<float> {
  __device__ static float v() { return FLT_EPSILON; }
};

__device__ __forceinline__ double hyp(double a, double b) {
  return hypot(a, b);
}
__device__ __forceinline__ float hyp(float a, float b) {
  return hypotf(a, b);
}

// One QL sweep on the block [l, m] of (d, e); returns the rotations run.
template <typename T>
__device__ long long ql_sweep(T* d, T* e, int l, int m, int n) {
  using R = Rn<T>;
  const T d_l = d[l];
  const T d_l1 = d[l + 1 < n - 1 ? l + 1 : n - 1];
  const T e_l = e[l];
  const T g0 = R::div(R::sub(d_l1, d_l),
                      R::mul(T(2), e_l == T(0) ? T(1) : e_l));
  const T r0 = hyp(g0, T(1));
  const T denom = R::add(g0, g0 >= T(0) ? r0 : -r0);
  T g = R::add(R::sub(d[m], d_l), R::div(e_l, denom == T(0) ? T(1) : denom));
  T s = T(1), c = T(1), p = T(0);
  long long steps = 0;
  // Step i reads e[i], d[i] and d[i+1] and writes e[i+1] and d[i+1]; the
  // d[i+1] it reads is the d[i] that step i + 1 read (no step between
  // writes it).  So each step loads only e[i-1] and d[i-1], one step
  // ahead, and the loads stay off the rotation chain.
  T d_i1 = d[m], d_i = d[m - 1], e_i = e[m - 1];
  for (int i = m - 1; i >= l; --i) {
    ++steps;
    const T d_next = i > l ? d[i - 1] : T(0);
    const T e_next = i > l ? e[i - 1] : T(0);
    const T f = R::mul(s, e_i);
    const T b = R::mul(c, e_i);
    const T r = hyp(f, g);
    e[i + 1] = r;
    if (r == T(0)) {
      // Premature deflation: the sweep stops here.
      d[i + 1] = R::sub(d_i1, p);
      e[m] = T(0);
      return steps;
    }
    s = R::div(f, r);
    c = R::div(g, r);
    const T gn = R::sub(d_i1, p);
    const T r2 = R::add(R::mul(R::sub(d_i, gn), s),
                        R::mul(R::mul(T(2), c), b));
    p = R::mul(s, r2);
    d[i + 1] = R::add(gn, p);
    g = R::sub(R::mul(c, r2), b);
    d_i1 = d_i;
    d_i = d_next;
    e_i = e_next;
  }
  d[l] = R::sub(d[l], p);
  e[l] = g;
  e[m] = T(0);
  return steps;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sterf_kernel(const T* __restrict__ d_in, const T* __restrict__ e_in,
             T* __restrict__ d_out, T* __restrict__ e_work,
             long long* __restrict__ steps_out, int B, int n) {
  using R = Rn<T>;
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  T* d = d_out + (size_t)b * n;
  T* e = e_work + (size_t)b * n;
  for (int i = 0; i < n; ++i) d[i] = d_in[(size_t)b * n + i];
  for (int i = 0; i + 1 < n; ++i) e[i] = e_in[(size_t)b * (n - 1) + i];
  e[n - 1] = T(0);                  // permanent zero sentinel
  const T eps = Eps<T>::v();
  const long long cap = 30LL * n;
  long long it = 0, steps = 0;
  int l = 0;
  while (l < n && it < cap) {
    int m = l;
    while (m < n - 1 &&
           !(R::abs(e[m]) <= R::mul(eps, R::add(R::abs(d[m]),
                                                R::abs(d[m + 1])))))
      ++m;
    if (m == l)
      ++l;
    else
      steps += ql_sweep(d, e, l, m, n);
    ++it;
  }
  steps_out[b] = steps;
}

template <typename T>
int launch(const T* d, const T* e, T* d_out, T* e_work, long long* steps,
           int B, int n, void* stream) {
  sterf_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(d, e, d_out, e_work, steps, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sterf_f64(const double* d, const double* e, double* d_out,
              double* e_work, long long* steps, int B, int n, void* stream) {
  return launch<double>(d, e, d_out, e_work, steps, B, n, stream);
}

int sterf_f32(const float* d, const float* e, float* d_out, float* e_work,
              long long* steps, int B, int n, void* stream) {
  return launch<float>(d, e, d_out, e_work, steps, B, n, stream);
}

}  // extern "C"
