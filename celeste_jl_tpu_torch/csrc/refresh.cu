// The analytic-Hessian refresh pixel pass, one thread block per
// (source, band) row.
//
// Replaces celeste_jl_tpu/ops/pallas_refresh.py::_refresh_kernel. Per row:
// render the C mixture components on the tile (the first ks are star
// components), form the Poisson-bound weight fields, and emit only
// pixel-contracted outputs: the W-weighted degree-<=4 moments of every
// component, m15 (C, 15), and 72 reductions (layout in ops/refresh.py:
// lik_core, Hcross 6x6, H_tC 6x4, H_CC 7, g_C 4). Same expressions as
// ops/refresh.pixel_terms_plain; every entry of the (C, 6, 6) chain
// coefficients is used (the structural zeros are not skipped).
//
// What bounds it on the card: arithmetic and exp, not bytes. A row reads
// 5 N + 42 C values and writes 15 C + 72, while each pixel costs 2 C
// exps and ~(60 C + 400) flops (C = 30, N = 1024 on the main path). The
// design keeps every per-pixel intermediate on chip:
//   pass 1 (a thread per pixel) renders the C components, forms fs0, fs1,
//     the jacobians J0, J1 and the weight fields, accumulates the 72
//     reductions in registers, and leaves W0, W1 in shared memory;
//   pass 2 (a warp per component) re-renders that component's g and
//     accumulates its 15 moments against W0 or W1.
// Pixels go in chunks of kChunk so W0/W1 fit in shared memory for any
// tile size; m15 accumulates in shared memory across chunks. The 72 sums
// are reduced by warp shuffles, then across warps in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;
constexpr int kComp = 42;   // mu(2), L(3), z, P(36) per component
constexpr int kRow = 6;     // cl0, cl1, cll0, cll1, off0, off1
constexpr int kRed = 72;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One component at one pixel: returns g and sets (l1, l2).
template <typename T>
__device__ __forceinline__ T component(const T* pc, T x1, T x2, T& l1,
                                       T& l2) {
  const T d1 = x1 - pc[0], d2 = x2 - pc[1];
  l1 = pc[2] * d1 + pc[3] * d2;
  l2 = pc[3] * d1 + pc[4] * d2;
  return pc[5] * exp_t(T(-0.5) * (d1 * l1 + d2 * l2));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
refresh_kernel(const T* __restrict__ comp, const T* __restrict__ rowp,
               const T* __restrict__ pxf, T* __restrict__ m15,
               T* __restrict__ red, int C, int ks, int N, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cp = reinterpret_cast<T*>(smem);     // C * kComp
  T* ms = cp + C * kComp;                  // C * 15
  T* w0s = ms + C * 15;                    // kChunk
  T* w1s = w0s + kChunk;                   // kChunk
  T* part = w1s + kChunk;                  // kWarps * kRed

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < C * kComp; e += kThreads)
    cp[e] = comp[(size_t)row * C * kComp + e];
  for (int e = tid; e < C * 15; e += kThreads) ms[e] = T(0);

  const T* rp = rowp + (size_t)row * kRow;
  const T cl0 = rp[0], cl1 = rp[1], cll0 = rp[2], cll1 = rp[3];
  const T off0 = rp[4], off1 = rp[5];
  const T* pix = pxf + (size_t)row * 5 * N;
  const T* msk = pix + N;
  const T* iota = pix + 2 * (size_t)N;
  const T* a0 = pix + 3 * (size_t)N;
  const T* b0 = pix + 4 * (size_t)N;

  T acc[kRed];
#pragma unroll
  for (int k = 0; k < kRed; ++k) acc[k] = T(0);
  __syncthreads();

  for (int start = 0; start < N; start += kChunk) {
    const int end = min(N, start + kChunk);

    // pass 1: a thread per pixel
    for (int n = start + tid; n < end; n += kThreads) {
      const T x1 = off0 + T(1 + n / cols), x2 = off1 + T(1 + n % cols);
      const T m = msk[n];
      const T x = m > T(0) ? pix[n] : T(0);
      const T iot = m > T(0) ? iota[n] : T(1);
      T fs0 = T(0), fs1 = T(0), J0[6], J1[6];
#pragma unroll
      for (int t = 0; t < 6; ++t) J0[t] = J1[t] = T(0);
      for (int c = 0; c < C; ++c) {
        const T* pc = cp + c * kComp;
        T l1, l2;
        const T g = component(pc, x1, x2, l1, l2);
        const T gb[6] = {g, g * l1, g * l2, g * (l1 * l1), g * (l1 * l2),
                         g * (l2 * l2)};
        T s[6];
#pragma unroll
        for (int t = 0; t < 6; ++t) {
          s[t] = T(0);
#pragma unroll
          for (int b = 0; b < 6; ++b) s[t] += pc[6 + t * 6 + b] * gb[b];
        }
        if (c < ks) {
          fs0 += g;
#pragma unroll
          for (int t = 0; t < 6; ++t) J0[t] += s[t];
        } else {
          fs1 += g;
#pragma unroll
          for (int t = 0; t < 6; ++t) J1[t] += s[t];
        }
      }

      // Poisson-bound weight fields (ops/refresh._poisson_weight_fields)
      const T s1 = cl0 * fs0 + cl1 * fs1;
      const T s2 = cll0 * fs0 * fs0 + cll1 * fs1 * fs1;
      const T E = m > T(0) ? a0[n] + s1 : T(1);
      const T V = m > T(0) ? b0[n] + s2 - s1 * s1 : T(0);
      const T rE = T(1) / E, rE2 = rE * rE, rE3 = rE2 * rE;
      const T phi_E = x * rE + x * V * rE3 - iot;
      const T phi_V = T(-0.5) * x * rE2;
      const T phi_EE = -x * rE2 - T(3) * x * V * rE2 * rE2;
      const T phi_EV = x * rE3;
      const T g1 = m * (phi_E - T(2) * s1 * phi_V);
      const T g2 = m * phi_V;
      const T h11 = m * (phi_EE - T(4) * s1 * phi_EV) - T(2) * g2;
      const T h12 = m * phi_EV;
      const T u0 = T(2) * cll0 * fs0, u1 = T(2) * cll1 * fs1;
      w0s[n - start] = g1 * cl0 + g2 * u0;
      w1s[n - start] = g1 * cl1 + g2 * u1;
      acc[0] += m * (x * (log_t(E) - T(0.5) * V * rE2) - iot * E);

      // cross fields (ops/refresh._cross_fields)
      const T f00 = h11 * cl0 * cl0 + T(2) * h12 * cl0 * u0 + T(2) * g2 * cll0;
      const T f01 = h11 * cl0 * cl1 + h12 * (cl0 * u1 + u0 * cl1);
      const T f11 = h11 * cl1 * cl1 + T(2) * h12 * cl1 * u1 + T(2) * g2 * cll1;
      const T t0 = h11 * fs0, t1 = h11 * fs1;
      const T r0 = h12 * fs0, r1 = h12 * fs1;
      const T q0 = r0 * fs0, q1 = r1 * fs1;
      const T A0[4] = {t0 * cl0 + r0 * u0 + g1, t1 * cl0 + r1 * u0,
                       q0 * cl0 + T(2) * g2 * fs0, q1 * cl0};
      const T A1[4] = {t0 * cl1 + r0 * u1, t1 * cl1 + r1 * u1 + g1,
                       q0 * cl1, q1 * cl1 + T(2) * g2 * fs1};
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const T U0 = f00 * J0[j] + f01 * J1[j];
        const T U1 = f01 * J0[j] + f11 * J1[j];
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[1 + i * 6 + j] += J0[i] * U0 + J1[i] * U1;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[37 + i * 4 + j] += J0[i] * A0[j] + J1[i] * A1[j];
      }
      acc[61] += h11 * fs0 * fs0;
      acc[62] += h11 * fs0 * fs1;
      acc[63] += h11 * fs1 * fs1;
      acc[64] += h12 * fs0 * (fs0 * fs0);
      acc[65] += h12 * fs0 * (fs1 * fs1);
      acc[66] += h12 * fs1 * (fs0 * fs0);
      acc[67] += h12 * fs1 * (fs1 * fs1);
      acc[68] += g1 * fs0;
      acc[69] += g1 * fs1;
      acc[70] += g2 * (fs0 * fs0);
      acc[71] += g2 * (fs1 * fs1);
    }
    __syncthreads();

    // pass 2: a warp per component, 15 W-weighted moments each
    for (int c = warp; c < C; c += kWarps) {
      const T* pc = cp + c * kComp;
      const T* ws = c < ks ? w0s : w1s;
      T mm[15];
#pragma unroll
      for (int k = 0; k < 15; ++k) mm[k] = T(0);
      for (int n = start + lane; n < end; n += 32) {
        const T x1 = off0 + T(1 + n / cols), x2 = off1 + T(1 + n % cols);
        T l1, l2;
        const T wg = ws[n - start] * component(pc, x1, x2, l1, l2);
        const T p20 = l1 * l1, p11 = l1 * l2, p02 = l2 * l2;
        const T poly[15] = {T(1), l1, l2, p20, p11, p02,
                            p20 * l1, p20 * l2, l1 * p02, p02 * l2,
                            p20 * p20, p20 * p11, p20 * p02, p11 * p02,
                            p02 * p02};
#pragma unroll
        for (int k = 0; k < 15; ++k) mm[k] += wg * poly[k];
      }
#pragma unroll
      for (int k = 0; k < 15; ++k) {
        const T v = warp_sum(mm[k]);
        if (lane == 0) ms[c * 15 + k] += v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRed; ++k) {
    const T v = warp_sum(acc[k]);
    if (lane == 0) part[warp * kRed + k] = v;
  }
  __syncthreads();
  if (tid < kRed) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += part[w * kRed + tid];
    red[(size_t)row * kRed + tid] = s;
  }
  for (int e = tid; e < C * 15; e += kThreads)
    m15[(size_t)row * C * 15 + e] = ms[e];
}

template <typename T>
int launch_refresh(const void* comp, const void* rowp, const void* pxf,
                   void* m15, void* red, int G, int C, int ks, int N,
                   int cols, void* stream) {
  const size_t smem =
      ((size_t)C * (kComp + 15) + 2 * kChunk + kWarps * kRed) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        refresh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  refresh_kernel<T><<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)comp, (const T*)rowp, (const T*)pxf, (T*)m15, (T*)red, C, ks,
      N, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* celeste_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int celeste_refresh_f32(const void* comp, const void* rowp,
                                   const void* pxf, void* m15, void* red,
                                   int G, int C, int ks, int N, int cols,
                                   void* stream) {
  return launch_refresh<float>(comp, rowp, pxf, m15, red, G, C, ks, N, cols,
                               stream);
}

extern "C" int celeste_refresh_f64(const void* comp, const void* rowp,
                                   const void* pxf, void* m15, void* red,
                                   int G, int C, int ks, int N, int cols,
                                   void* stream) {
  return launch_refresh<double>(comp, rowp, pxf, m15, red, G, C, ks, N, cols,
                                stream);
}
