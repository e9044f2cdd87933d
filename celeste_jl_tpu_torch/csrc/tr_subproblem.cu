// Trust-region subproblem in the eigenbasis, one warp per lane.
//
// Replaces celeste_jl_tpu/ops/pallas_tr.py::_tr_kernel (the TPU kernel
// that runs the whole subproblem VMEM-resident per 128-lane block).
// Per lane: argmin gq.p + 0.5 p' diag(w) p subject to ||p|| <= delta, by
// the interior Newton-step check, `iters` bisections of the secular
// equation ||(w + lam)^-1 gq|| = delta, and the hard-case ridge along the
// bottom eigenvector (first index on ties, as argmin), then the predicted
// reduction. Same expressions as ops/tr.tr_subproblem_plain.
//
// What bounds it on the card: a serial chain of `iters` dependent warp
// reductions (5 shuffles each) on 2 x 42 values per lane; the bytes
// (~3 D values in, D + 1 out per lane) are negligible. The design keeps
// each lane's gq and w in two registers per thread for the whole chain,
// so a bisection step costs one division, one fma and a butterfly
// reduction, and many warps per SM hide each other's latency. D <= 64.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Butterfly sum: every lane ends with the same bits, because each step
// adds the same two values in either order.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void tr_kernel(const T* __restrict__ gq, const T* __restrict__ w,
                          const T* __restrict__ delta, T* __restrict__ p,
                          T* __restrict__ pred, int B, int D, int iters) {
  const int lane_id = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (lane_id >= B) return;  // uniform across the warp
  const T* g_row = gq + (size_t)lane_id * D;
  const T* w_row = w + (size_t)lane_id * D;
  const int i0 = t, i1 = t + 32;
  const bool v0 = i0 < D, v1 = i1 < D;
  // Entries past D carry g = 0 (no contribution to any sum) and w = 1.
  const T g0 = v0 ? g_row[i0] : T(0), g1 = v1 ? g_row[i1] : T(0);
  const T w0 = v0 ? w_row[i0] : T(1), w1 = v1 ? w_row[i1] : T(1);
  const T dl = delta[lane_id];
  const T eps = T(1e-12);

  // argmin with the first index on ties
  T mv = T(INFINITY);
  int mi = D;
  if (v0) { mv = w0; mi = i0; }
  if (v1 && w1 < mv) { mv = w1; mi = i1; }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, mv, off);
    const int oi = __shfl_xor_sync(kFull, mi, off);
    if (ov < mv || (ov == mv && oi < mi)) { mv = ov; mi = oi; }
  }
  const T w_min = mv;
  const int bottom = mi;

  const T pn0 = -(g0 / (w0 > eps ? w0 : T(1)));
  const T pn1 = -(g1 / (w1 > eps ? w1 : T(1)));
  const T newton_norm = sqrt_t(warp_sum(pn0 * pn0 + pn1 * pn1));
  const bool interior = (w_min > eps) && (newton_norm <= dl);

  const T gnorm = sqrt_t(warp_sum(g0 * g0 + g1 * g1));
  const T shift = w_min < T(0) ? -w_min : T(0);
  T lo = shift + eps;
  const T hi0 = gnorm / (dl > eps ? dl : eps) + shift + T(1);
  T hi = lo * T(2) + T(1);
  hi = hi0 > hi ? hi0 : hi;
  for (int it = 0; it < iters; ++it) {
    const T mid = T(0.5) * (lo + hi);
    const T q0 = g0 / (w0 + mid), q1 = g1 / (w1 + mid);
    const bool too_big = sqrt_t(warp_sum(q0 * q0 + q1 * q1)) > dl;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const T lam = T(0.5) * (lo + hi);

  const T pb0 = -(g0 / (w0 + lam)), pb1 = -(g1 / (w1 + lam));
  const T bnorm = sqrt_t(warp_sum(pb0 * pb0 + pb1 * pb1));
  const T gap = dl * dl - bnorm * bnorm;
  const T tau = sqrt_t(gap > T(0) ? gap : T(0));
  const bool hard = (bnorm < T(0.9) * dl) && (w_min < eps);
  const T e00 = i0 == bottom ? T(1) : T(0), e01 = i1 == bottom ? T(1) : T(0);
  const T p0 = interior ? pn0 : (hard ? pb0 + tau * e00 : pb0);
  const T p1 = interior ? pn1 : (hard ? pb1 + tau * e01 : pb1);

  const T gp = warp_sum((v0 ? g0 * p0 : T(0)) + (v1 ? g1 * p1 : T(0)));
  const T pwp = warp_sum((v0 ? p0 * (w0 * p0) : T(0)) +
                         (v1 ? p1 * (w1 * p1) : T(0)));
  T* p_row = p + (size_t)lane_id * D;
  if (v0) p_row[i0] = p0;
  if (v1) p_row[i1] = p1;
  if (t == 0) {
    const T r = -(gp + T(0.5) * pwp);
    pred[lane_id] = r < T(0) ? T(0) : r;  // NaN passes through, as clamp
  }
}

template <typename T>
int launch_tr(const void* gq, const void* w, const void* delta, void* p,
              void* pred, int B, int D, int iters, void* stream) {
  const int lanes_per_block = kThreads / 32;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  tr_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)gq, (const T*)w, (const T*)delta, (T*)p, (T*)pred, B, D,
      iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int celeste_tr_subproblem_f32(const void* gq, const void* w,
                                         const void* delta, void* p,
                                         void* pred, int B, int D, int iters,
                                         void* stream) {
  return launch_tr<float>(gq, w, delta, p, pred, B, D, iters, stream);
}

extern "C" int celeste_tr_subproblem_f64(const void* gq, const void* w,
                                         const void* delta, void* p,
                                         void* pred, int B, int D, int iters,
                                         void* stream) {
  return launch_tr<double>(gq, w, delta, p, pred, B, D, iters, stream);
}
