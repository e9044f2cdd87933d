// Fused Gaussian-mixture render + masked Poisson log-likelihood, one
// thread block per (lane, band) row.
//
// Replaces celeste_jl_tpu/ops/pallas_render.py::_kernel, the MCMC/AIS
// likelihood. Per row: the C packed components [mu1, mu2, p11, p12, p22,
// logw] and [row offset, col offset, flux] go in; the tile's pixels, mask,
// iota and background (P x P each, taken from the tile the row's index
// names, so the AIS samples of one source share its tiles) are scored as
//     rate = iota (bg + flux sum_c exp(logw_c - q_c / 2))  (1 where masked)
//     out  = sum_pixels mask (x log(rate) - rate)
// Same expressions as ops/render.mixture_poisson_ll_plain (the JAX
// package's _xla_reference), components summed in order c = 0..C-1.
//
// What bounds it on the card: the exps. At the galaxy model's C = 28 a
// row does 28 exps and ~12 C flops per active pixel against 4 tile values
// read (shared by the rows of one source): at most ~1 GFLOP per 3200-row
// launch of 32 x 32 tiles, ~16 us at the f32 peak, while the tiles are
// ~5 MB (~2 us). The accurate expf (not __expf, to hold the twin's
// tolerance) costs an SFU op plus a few FMAs, so the SFU's rate, not the
// FMA pipe, sets the floor; the design therefore renders only the active
// pixels (a masked pixel's rate is 1 whatever its density, so skipping it
// changes no bit of the result): at the AIS's patch radius 8 about a
// quarter of a 32 x 32 tile, ~0.3 GFLOP and ~4 us a launch. The price of
// one block per row is idle warps over the masked rows of the tile, which
// a later design can avoid by walking a list of the active pixels. Every
// per-pixel intermediate stays in registers: the row's components are
// staged once in shared memory (in chunks of kChunk, so any C runs), each
// thread accumulates the mixture density of its pixels over C and its
// share of the log-likelihood, and a warp-shuffle plus shared-memory
// reduction gives the row's sum. No atomics: the result is the same from
// run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__global__ void render_ll_kernel(const T* __restrict__ comps,
                                 const T* __restrict__ meta,
                                 const T* __restrict__ pix,
                                 const T* __restrict__ mask,
                                 const T* __restrict__ iota,
                                 const T* __restrict__ bg,
                                 const int* __restrict__ tile_index,
                                 T* __restrict__ out, int C, int P,
                                 int n_tiles) {
  __shared__ T sc[kChunk * 6];
  __shared__ T red[kWarps];
  const int r = blockIdx.x;
  const int N = P * P;
  const int ti = tile_index[r];
  if (ti < 0 || ti >= n_tiles) {  // no tile: NaN, and no stray read
    if (threadIdx.x == 0) out[r] = T(NAN);
    return;
  }
  const size_t tb = (size_t)ti * N;
  const T* cr = comps + (size_t)r * C * 6;
  const T off1 = meta[4 * r], off2 = meta[4 * r + 1], flux = meta[4 * r + 2];
  const bool one_chunk = C <= kChunk;

  if (one_chunk) {
    for (int e = threadIdx.x; e < C * 6; e += blockDim.x) sc[e] = cr[e];
    __syncthreads();
  }

  T sum = T(0);
  for (int base = 0; base < N; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const int i = p / P, j = p - (p / P) * P;
    const T x1 = T(i) + off1, x2 = T(j) + off2;
    // a masked pixel's rate is 1 whatever its density: skip the render
    const T m = p < N ? mask[tb + p] : T(0);
    T acc = T(0);
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int nc = min(kChunk, C - c0);
      if (!one_chunk) {
        __syncthreads();
        for (int e = threadIdx.x; e < nc * 6; e += blockDim.x)
          sc[e] = cr[c0 * 6 + e];
        __syncthreads();
      }
      if (m > T(0)) {
        for (int c = 0; c < nc; ++c) {
          const T* k = sc + 6 * c;
          const T dx1 = x1 - k[0], dx2 = x2 - k[1];
          const T q = k[2] * dx1 * dx1 + T(2) * k[3] * dx1 * dx2 +
                      k[4] * dx2 * dx2;
          acc = acc + exp_t(k[5] - T(0.5) * q);
        }
      }
    }
    if (p < N) {
      T rate = iota[tb + p] * (bg[tb + p] + flux * acc);
      rate = m > T(0) ? rate : T(1);
      sum += m * (pix[tb + p] * log_t(rate) - rate);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int w = 0; w < kWarps; ++w) total += red[w];
    out[r] = total;
  }
}

template <typename T>
int launch_render_ll(const void* comps, const void* meta, const void* pix,
                     const void* mask, const void* iota, const void* bg,
                     const void* tile_index, void* out, int R, int C, int P,
                     int n_tiles, void* stream) {
  render_ll_kernel<T><<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)comps, (const T*)meta, (const T*)pix, (const T*)mask,
      (const T*)iota, (const T*)bg, (const int*)tile_index, (T*)out, C, P,
      n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int celeste_mixture_poisson_ll_f32(
    const void* comps, const void* meta, const void* pix, const void* mask,
    const void* iota, const void* bg, const void* tile_index, void* out,
    int R, int C, int P, int n_tiles, void* stream) {
  return launch_render_ll<float>(comps, meta, pix, mask, iota, bg,
                                 tile_index, out, R, C, P, n_tiles, stream);
}

extern "C" int celeste_mixture_poisson_ll_f64(
    const void* comps, const void* meta, const void* pix, const void* mask,
    const void* iota, const void* bg, const void* tile_index, void* out,
    int R, int C, int P, int n_tiles, void* stream) {
  return launch_render_ll<double>(comps, meta, pix, mask, iota, bg,
                                  tile_index, out, R, C, P, n_tiles, stream);
}
