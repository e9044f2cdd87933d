// K4: fused Gaussian-mixture render + masked Poisson log-likelihood over
// the active pixels of each tile; one thread block per group of rows that
// share a tile, one warp per row.
//
// Replaces celeste_jl_tpu/ops/pallas_render.py::_kernel, the MCMC/AIS
// likelihood. A row r has C_r packed components [mu1, mu2, p11, p12, p22,
// logw] (rows comp_ptr[r] .. comp_ptr[r + 1] - 1 of comps, so rows of
// different models share a launch) and meta [row offset, col offset,
// flux, unused]. Its tile's active pixels (x, iota, bg at tile row i,
// column j) are scored as
//     rate = iota (bg + flux sum_c exp(logw_c - q_c / 2))
//     out  = sum_active (x log(rate) - rate)
// with q_c the precision quadratic form at (i + row offset, j + col
// offset). That is ops/render.mixture_poisson_ll_plain's masked sum over
// the whole tile (the JAX package's _xla_reference): a masked pixel adds
// exactly -0 there. Components are summed in order c = 0..C-1, with the
// twin's expressions.
//
// What bounds it on the card: the accurate expf (not __expf, to hold the
// twin's f32 tolerance), C_r of them per active pixel of a row, on the SFU
// (16 a clock per SM), plus its range reduction and the quadratic form on
// the FMA pipe, ~15 instructions per component and pixel. At the AIS's
// galaxy launch (3200 rows, C = 28, ~290 active pixels of a 32 x 32 tile)
// that is ~26M exps: ~7 us on the SFUs, ~13 us of issue. The bytes are
// small: each tile's active pixels and each row's components, read once.
//
// The design:
// - the kernel walks a compact list of each tile's active pixels
//   (ops/render.ActiveTiles, built once per set of tiles) instead of the
//   P x P grid: at the AIS's radius 8 three quarters of a 32 x 32 tile are
//   masked;
// - a block serves up to `warps` rows of one tile (the AIS samples, both
//   models and the step-out copies of one source band, grouped by
//   ops/render.RowPlan, heaviest first): it stages the tile's active
//   pixels in shared memory once for all of them, and each warp scores one
//   row, with that row's components staged in its own slice of shared
//   memory and up to four pixels per lane, so that each component read
//   (two vector loads: a warp issues one shared load a clock against four
//   arithmetic instructions) serves four exps;
// - each row carries its own component count, so the star (C = 2) and
//   galaxy (C = 28) rows of one evaluation go in one launch;
// - no atomics: each lane sums its pixels' terms in double, a warp
//   butterfly adds the lanes, and the result is the same from run to run.
// Pixels are staged kPixChunk and components kCompChunk at a time, so any
// tile size and any C run. A work item whose tile is -1 (its rows' tile
// index was out of range) writes NaN for them; a tile with no active pixel
// gives 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 16;
constexpr int kCompChunk = 32;   // components staged per warp at a time
constexpr int kCompStride = 8;   // a staged component: 6 values and a pad
constexpr int kPixChunk = 512;   // active pixels staged per block at a time
// pixels a lane renders at once: four in f32; two in f64, where four
// would not fit the registers
template <typename T>
struct MaxNP {
  static constexpr int value = sizeof(T) == 4 ? 4 : 2;
};
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

// a staged component [mu1, mu2, p11, p12, p22, logw] by 16-byte loads
__device__ __forceinline__ void load_comp(const float* k, float (&v)[6]) {
  const float4 a = reinterpret_cast<const float4*>(k)[0];
  const float2 b = reinterpret_cast<const float2*>(k)[2];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y;
}
__device__ __forceinline__ void load_comp(const double* k, double (&v)[6]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const double2 a = reinterpret_cast<const double2*>(k)[q];
    v[2 * q] = a.x, v[2 * q + 1] = a.y;
  }
}

// One warp's pass over NPX groups of 32 staged pixels, a0 + 32 u + lane:
// the row's mixture density at each (the C components, staged kCompChunk
// at a time unless they were staged once), and the scores of the pixels
// below n added to sum. A slot at or past n renders pixel n - 1 and is not
// scored. Every lane of the warp calls it with the same arguments.
template <typename T, int NPX>
__device__ __forceinline__ void score_pixels(
    T* sc, const T* cr, int C, bool one_chunk, int a0, int n, int lane,
    T off1, T off2, T flux, const int* s_pos, const T* s_x, const T* s_io,
    const T* s_bg, double& sum) {
  T x1[NPX], x2[NPX], acc[NPX];
  int p[NPX];
#pragma unroll
  for (int u = 0; u < NPX; ++u) {
    p[u] = min(a0 + 32 * u + lane, n - 1);
    const int pos = s_pos[p[u]];
    x1[u] = T(pos >> 16) + off1;
    x2[u] = T(pos & 0xffff) + off2;
    acc[u] = T(0);
  }
  for (int c0 = 0; c0 < C; c0 += kCompChunk) {
    const int nc = min(kCompChunk, C - c0);
    if (!one_chunk) {
      __syncwarp();
      for (int e = lane; e < nc * 6; e += 32)
        sc[(e / 6) * kCompStride + e % 6] = cr[c0 * 6 + e];
      __syncwarp();
    }
    for (int c = 0; c < nc; ++c) {
      T k[6];
      load_comp(sc + c * kCompStride, k);
#pragma unroll
      for (int u = 0; u < NPX; ++u) {
        const T dx1 = x1[u] - k[0], dx2 = x2[u] - k[1];
        const T q = k[2] * dx1 * dx1 + T(2) * k[3] * dx1 * dx2 +
                    k[4] * dx2 * dx2;
        acc[u] += exp_t(k[5] - T(0.5) * q);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NPX; ++u) {
    if (a0 + 32 * u + lane < n) {
      const T rate = s_io[p[u]] * (s_bg[p[u]] + flux * acc[u]);
      sum += (double)(s_x[p[u]] * log_t(rate) - rate);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
render_ll_kernel(const T* __restrict__ comps, const int* __restrict__ comp_ptr,
                 const T* __restrict__ meta, const int* __restrict__ tile_ptr,
                 const int* __restrict__ apos, const T* __restrict__ ax,
                 const T* __restrict__ aiota, const T* __restrict__ abg,
                 const int* __restrict__ order, const int* __restrict__ work,
                 T* __restrict__ out) {
  __shared__ int s_pos[kPixChunk];
  __shared__ T s_x[kPixChunk], s_io[kPixChunk], s_bg[kPixChunk];
  extern __shared__ __align__(16) unsigned char s_comp[];  // per warp

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = work[3 * blockIdx.x];
  const int r0 = work[3 * blockIdx.x + 1], r1 = work[3 * blockIdx.x + 2];
  const bool has_row = warp < r1 - r0;
  const int row = has_row ? order[r0 + warp] : 0;
  if (tile < 0) {  // the rows' tile index was out of range: NaN, no read
    if (has_row && lane == 0) out[row] = T(NAN);
    return;
  }
  const int p0 = tile_ptr[tile], p1 = tile_ptr[tile + 1];
  T off1 = T(0), off2 = T(0), flux = T(0);
  int cb = 0, C = 0;
  if (has_row) {
    off1 = meta[4 * row];
    off2 = meta[4 * row + 1];
    flux = meta[4 * row + 2];
    cb = comp_ptr[row];
    C = comp_ptr[row + 1] - cb;
  }
  const T* cr = comps + (size_t)cb * 6;
  T* sc = reinterpret_cast<T*>(s_comp) + warp * kCompChunk * kCompStride;
  const bool one_chunk = C <= kCompChunk;
  if (one_chunk)  // visible to the warp after the block barrier below
    for (int e = lane; e < C * 6; e += 32)
      sc[(e / 6) * kCompStride + e % 6] = cr[e];

  double sum = 0.0;
  for (int q0 = p0; q0 < p1; q0 += kPixChunk) {
    const int n = min(kPixChunk, p1 - q0);
    __syncthreads();  // the last chunk's readers are done
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      s_pos[e] = apos[q0 + e];
      s_x[e] = ax[q0 + e];
      s_io[e] = aiota[q0 + e];
      s_bg[e] = abg[q0 + e];
    }
    __syncthreads();
    if (!has_row) continue;
    // np groups of 32 pixels a pass; the last pass takes only the groups
    // that hold a pixel (a warp-uniform count)
    constexpr int np = MaxNP<T>::value;
    for (int a0 = 0; a0 < n; a0 += 32 * np) {
      const int groups = min(np, (n - a0 + 31) / 32);
      if (np == 4 && groups == 4)
        score_pixels<T, np>(sc, cr, C, one_chunk, a0, n, lane, off1, off2,
                            flux, s_pos, s_x, s_io, s_bg, sum);
      else if (np == 4 && groups == 3)
        score_pixels<T, 3>(sc, cr, C, one_chunk, a0, n, lane, off1, off2,
                           flux, s_pos, s_x, s_io, s_bg, sum);
      else if (groups == 2)
        score_pixels<T, 2>(sc, cr, C, one_chunk, a0, n, lane, off1, off2,
                           flux, s_pos, s_x, s_io, s_bg, sum);
      else
        score_pixels<T, 1>(sc, cr, C, one_chunk, a0, n, lane, off1, off2,
                           flux, s_pos, s_x, s_io, s_bg, sum);
    }
  }
  if (!has_row) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) out[row] = T(sum);
}

template <typename T>
int launch_render_ll(const void* comps, const void* comp_ptr, const void* meta,
                     const void* tile_ptr, const void* apos, const void* ax,
                     const void* aiota, const void* abg, const void* order,
                     const void* work, void* out, int n_work, int warps,
                     void* stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * kCompChunk * kCompStride * sizeof(T);
  render_ll_kernel<T><<<n_work, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const T*)comps, (const int*)comp_ptr, (const T*)meta,
      (const int*)tile_ptr, (const int*)apos, (const T*)ax, (const T*)aiota,
      (const T*)abg, (const int*)order, (const int*)work, (T*)out);
  return (int)cudaGetLastError();
}

// registers, local (stack + spill) bytes, shared bytes and resident blocks
// per SM of the kernel at `warps` warps a block
template <typename T>
int render_ll_attrs(int warps, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, render_ll_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)warps * kCompChunk * kCompStride * sizeof(T);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, render_ll_kernel<T>, 32 * warps, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)(fa.sharedSizeBytes + smem);
  out[3] = blocks;
  return (int)err;
}

}  // namespace

#define CELESTE_RENDER_ENTRY(SUFFIX, T)                                       \
  extern "C" int celeste_mixture_poisson_ll_##SUFFIX(                         \
      const void* comps, const void* comp_ptr, const void* meta,              \
      const void* tile_ptr, const void* apos, const void* ax,                 \
      const void* aiota, const void* abg, const void* order,                  \
      const void* work, void* out, int n_work, int warps, void* stream) {     \
    return launch_render_ll<T>(comps, comp_ptr, meta, tile_ptr, apos, ax,     \
                               aiota, abg, order, work, out, n_work, warps,   \
                               stream);                                       \
  }                                                                           \
  extern "C" int celeste_mixture_poisson_ll_attrs_##SUFFIX(int warps,         \
                                                           int* out) {        \
    return render_ll_attrs<T>(warps, out);                                    \
  }

CELESTE_RENDER_ENTRY(f32, float)
CELESTE_RENDER_ENTRY(f64, double)
