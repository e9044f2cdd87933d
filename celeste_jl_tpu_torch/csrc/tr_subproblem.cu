// Trust-region subproblem in the eigenbasis, a warp per lane.
//
// Replaces celeste_jl_tpu/ops/pallas_tr.py::_tr_kernel (the TPU kernel
// that runs the whole subproblem VMEM-resident per 128-lane block).
// Per lane: argmin gq.p + 0.5 p' diag(w) p subject to ||p|| <= delta, by
// the interior Newton-step check, `iters` bisections of the secular
// equation ||(w + lam)^-1 gq|| = delta, and the hard-case ridge along the
// bottom eigenvector (first index on ties, as argmin), then the predicted
// reduction. Same expressions as ops/tr.tr_subproblem_plain; the bracket's
// upper end takes a NaN as torch.maximum does, so a NaN in gq gives a NaN
// step and a NaN pred, as the twin does.
//
// What bounds it on the card: a serial chain of `iters` bisections, each
// CPT = ceil(D / 32) independent divisions, a sum over the warp's shuffles
// (5 steps) and a compare; the bytes (~3 D values in, D + 1 out per lane)
// are negligible. The design keeps each lane's gq and w in CPT registers of
// each of its 32 threads for the whole chain (CPT, 1 or 2, a template
// parameter, so the arrays stay in registers), with entries past D
// carrying g = 0 and w = 1. A bisection takes no square root: it compares
// the sum of squares with the largest value whose root is <= delta
// (root_threshold, exact), and its divisions overlap (ieee_fast.cuh's
// division, the bits of `/`). D <= 64.

#include <cuda_runtime.h>
#include <math.h>

#include "ieee_fast.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTpl = 32;  // threads a lane: a warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Butterfly sum over a lane's warp: every thread ends with the same bits,
// because each step adds the same two values in either order.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kTpl / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float next_up(float x) {
  return nextafterf(x, INFINITY);
}
__device__ __forceinline__ double next_up(double x) {
  return nextafter(x, (double)INFINITY);
}
__device__ __forceinline__ float next_down(float x) {
  return nextafterf(x, 0.0f);
}
__device__ __forceinline__ double next_down(double x) {
  return nextafter(x, 0.0);
}

// The largest thr with sqrt(thr) <= dl, so that for a sum of squares s,
// sqrt(s) > dl exactly when s > thr (sqrt is correctly rounded, hence
// monotone): the bisection compares sums and takes no square root. A
// negative dl gives -1 (every sum is too big), a NaN dl NaN (none is).
template <typename T>
__device__ __forceinline__ T root_threshold(T dl) {
  if (!(dl >= T(0))) return dl < T(0) ? T(-1) : dl;
  const T big = next_down(T(INFINITY));
  T t = dl * dl;
  if (t > big) t = isinf(dl) ? t : big;
  while (t > T(0) && sqrt_t(t) > dl) t = next_down(t);
  while (t < big && sqrt_t(next_up(t)) <= dl) t = next_up(t);
  return t;
}

// The squares of g[m] / (w[m] + mid), each quotient rounded as `/` rounds
// it, summed in index order. In f32 the quotients go through div_rn_fast
// (ieee_fast.cuh), so a thread's divisions overlap; one branch, rarely
// taken, sends the entries outside its range through `/`, or div_by_zero
// where w[m] + mid is 0, as in the hard case (g_ok[m]: g[m] is 0 or in
// range; a zero g gives a zero square either way).
template <int CPT>
__device__ __forceinline__ float sum_sq_quotients(const float* g,
                                                  const float* w, float mid,
                                                  const bool* g_ok) {
  float q[CPT];
  bool ok[CPT], all_ok = true;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const float b = w[m] + mid;
    q[m] = div_rn_fast(g[m], b);
    ok[m] = g_ok[m] & div_rn_fast_range(b);
    all_ok = all_ok & ok[m];
  }
  if (!all_ok) {
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const float b = w[m] + mid;
      if (!ok[m]) q[m] = b == 0.0f ? div_by_zero(g[m], b) : g[m] / b;
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < CPT; ++m) acc += q[m] * q[m];
  return acc;
}

template <int CPT>
__device__ __forceinline__ double sum_sq_quotients(const double* g,
                                                   const double* w,
                                                   double mid, const bool*) {
  double acc = 0.0;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const double q = g[m] / (w[m] + mid);
    acc += q * q;
  }
  return acc;
}

// a / b rounded as `/` rounds it: div_rn (ieee_fast.cuh) in f32
__device__ __forceinline__ float quotient(float a, float b) {
  return div_rn(a, b);
}
__device__ __forceinline__ double quotient(double a, double b) {
  return a / b;
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
    tr_kernel(const T* __restrict__ gq, const T* __restrict__ w,
              const T* __restrict__ delta, T* __restrict__ p,
              T* __restrict__ pred, int B, int D, int iters) {
  // a warp past the last lane leaves whole, so every thread of a working
  // warp takes part in its shuffles
  const int lane_id = (blockIdx.x * kThreads + threadIdx.x) / kTpl;
  if (lane_id >= B) return;
  const int t = threadIdx.x % kTpl;
  const T* g_row = gq + (size_t)lane_id * D;
  const T* w_row = w + (size_t)lane_id * D;
  T g[CPT], wv[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int i = t + m * kTpl;
    g[m] = i < D ? g_row[i] : T(0);
    wv[m] = i < D ? w_row[i] : T(1);
  }
  const T dl = delta[lane_id];
  const T eps = T(1e-12);

  // argmin with the first index on ties: a thread's entries in index order,
  // then the warp's butterfly
  T mv = T(INFINITY);
  int mi = D;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    if (t + m * kTpl < D && wv[m] < mv) {
      mv = wv[m];
      mi = t + m * kTpl;
    }
  }
#pragma unroll
  for (int off = kTpl / 2; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, mv, off);
    const int oi = __shfl_xor_sync(kFull, mi, off);
    if (ov < mv || (ov == mv && oi < mi)) {
      mv = ov;
      mi = oi;
    }
  }
  const T w_min = mv;
  const int bottom = mi;

  T pn[CPT];
  T nn = T(0), gg = T(0);
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    pn[m] = -quotient(g[m], wv[m] > eps ? wv[m] : T(1));
    nn += pn[m] * pn[m];
    gg += g[m] * g[m];
  }
  const T thr = root_threshold(dl);
  const bool interior = (w_min > eps) && (warp_sum(nn) <= thr);

  const T gnorm = sqrt_t(warp_sum(gg));
  const T shift = w_min < T(0) ? -w_min : T(0);
  T lo = shift + eps;
  const T hi0 = gnorm / (dl > eps ? dl : eps) + shift + T(1);
  T hi = lo * T(2) + T(1);
  hi = (hi0 > hi || hi0 != hi0) ? hi0 : hi;  // torch.maximum keeps a NaN
  bool g_ok[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m)
    g_ok[m] = g[m] == T(0) || div_rn_fast_range((float)g[m]);
  for (int it = 0; it < iters; ++it) {
    const T mid = T(0.5) * (lo + hi);
    const T acc = sum_sq_quotients<CPT>(g, wv, mid, g_ok);
    const bool too_big = warp_sum(acc) > thr;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const T lam = T(0.5) * (lo + hi);

  T pb[CPT];
  T bb = T(0);
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    pb[m] = -quotient(g[m], wv[m] + lam);
    bb += pb[m] * pb[m];
  }
  const T bnorm = sqrt_t(warp_sum(bb));
  const T gap = dl * dl - bnorm * bnorm;
  const T tau = sqrt_t(gap > T(0) ? gap : T(0));
  const bool hard = (bnorm < T(0.9) * dl) && (w_min < eps);

  T gp = T(0), pwp = T(0);
  T* p_row = p + (size_t)lane_id * D;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int i = t + m * kTpl;
    const T e0 = i == bottom ? T(1) : T(0);
    const T pm = interior ? pn[m] : (hard ? pb[m] + tau * e0 : pb[m]);
    if (i < D) {
      gp += g[m] * pm;
      pwp += pm * (wv[m] * pm);
      p_row[i] = pm;
    }
  }
  gp = warp_sum(gp);
  pwp = warp_sum(pwp);
  if (t == 0) {
    const T r = -(gp + T(0.5) * pwp);
    pred[lane_id] = r < T(0) ? T(0) : r;  // NaN passes through, as clamp
  }
}

template <typename T, int CPT>
int launch_tr(const void* gq, const void* w, const void* delta, void* p,
              void* pred, int B, int D, int iters, void* stream) {
  const int blocks = (B * kTpl + kThreads - 1) / kThreads;
  tr_kernel<T, CPT><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)gq, (const T*)w, (const T*)delta, (T*)p, (T*)pred, B, D,
      iters);
  return (int)cudaGetLastError();
}

// The instance for ceil(D / 32) entries a thread: 1 or 2.
template <typename T>
int dispatch_tr(const void* gq, const void* w, const void* delta, void* p,
                void* pred, int B, int D, int iters, void* stream) {
  if (D < 1 || D > 2 * kTpl) return (int)cudaErrorInvalidValue;
  if (D <= kTpl)
    return launch_tr<T, 1>(gq, w, delta, p, pred, B, D, iters, stream);
  return launch_tr<T, 2>(gq, w, delta, p, pred, B, D, iters, stream);
}

// Registers and local memory of the instance that takes D, and its
// resident blocks per SM.
template <typename T, int CPT>
int tr_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, tr_kernel<T, CPT>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tr_kernel<T, CPT>, kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return (int)err;
}

template <typename T>
int dispatch_attrs(int D, int* out) {
  if (D < 1 || D > 2 * kTpl) return (int)cudaErrorInvalidValue;
  return D <= kTpl ? tr_attrs<T, 1>(out) : tr_attrs<T, 2>(out);
}

}  // namespace

extern "C" int celeste_tr_subproblem_f32(const void* gq, const void* w,
                                         const void* delta, void* p,
                                         void* pred, int B, int D, int iters,
                                         void* stream) {
  return dispatch_tr<float>(gq, w, delta, p, pred, B, D, iters, stream);
}

extern "C" int celeste_tr_subproblem_f64(const void* gq, const void* w,
                                         const void* delta, void* p,
                                         void* pred, int B, int D, int iters,
                                         void* stream) {
  return dispatch_tr<double>(gq, w, delta, p, pred, B, D, iters, stream);
}

extern "C" int celeste_tr_subproblem_attrs_f32(int D, int* out) {
  return dispatch_attrs<float>(D, out);
}

extern "C" int celeste_tr_subproblem_attrs_f64(int D, int* out) {
  return dispatch_attrs<double>(D, out);
}
