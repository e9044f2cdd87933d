// K1: the analytic-Hessian refresh pixel pass over the active pixels, one
// thread block per (source, band) row.
//
// Replaces celeste_jl_tpu/ops/pallas_refresh.py::_refresh_kernel. Per row:
// render the C mixture components on the tile (the first ks are star
// components), form the Poisson-bound weight fields, and emit only
// pixel-contracted outputs: the W-weighted degree-<=4 moments of every
// component, m15 (C, 15), and 72 reductions (layout in ops/refresh.py:
// lik_core, Hcross 6x6, H_tC 6x4, H_CC 7, g_C 4). Same expressions as
// ops/refresh.pixel_terms_plain.
//
// What bounds it on the card: the per-pixel arithmetic, not bytes. A row
// reads 5 N + 42 C values and writes 15 C + 72, while each active pixel
// costs C exps and ~95 instructions per component (C = 30, N = 1024 on
// the main path, ~3/4 of the pixels active). A first port read each
// coefficient from shared memory once per pixel (23 loads per component
// and pixel, where an SM issues one shared load a clock against four
// arithmetic instructions), rendered every component twice, visited the
// masked pixels and kept 72 sums in registers through the render (one
// block per SM). The design:
// - only the active pixels: the block compacts the row's active pixel
//   indices into shared memory (a block-wide prefix sum over the mask, by
//   warp ballots, the mask read a few chunks ahead), as many as the shared
//   buffers hold at a time (a fill). A masked pixel contributes exactly 0
//   to every output (every term carries m, and its E = 1, V = 0), so
//   skipping it changes only the order of additions;
// - pass 1a (a thread per two active pixels) renders each component once,
//   leaves g in shared memory, and forms the jacobians J0, J1 from the
//   chain coefficients' live entries only: the structural zeros of
//   P = chain R (models/mixture_derivs; the JAX kernel skips them too, and
//   tests/test_torch_refresh.py holds the pattern). Star components reach
//   J0 rows t = 0, 1 through b = 1, 2 only, so J0's rows 2..5 are 0;
//   galaxy components use 17 of the 36 entries. A component's live
//   coefficients sit in shared memory as 16-byte vectors (kLive values),
//   so one load brings four coefficients, each used for two pixels. The
//   pixels' fields are loaded from device memory while they render;
// - pass 1b (the same thread, one of its pixels at a time) forms the
//   weight fields, writes W0, W1 and sums the reductions: Hcross is
//   symmetric, so 21 of its entries are summed and mirrored at the end,
//   57 sums in all. They live in registers for one fill only, and a warp
//   adds them up with 62 shuffles (each lane keeps half of its values at
//   each step) into its slot of shared memory;
// - pass 2 (a warp per two components) reads g back and forms only l1, l2
//   and the 15 W-weighted moments: no second exp.
// The operands are read where they lie (no packed copy per call). In f32
// two blocks share an SM (the register cap and the shared buffers are set
// for it), in f64 one. No atomics: the result is the same from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLive = 24;   // mu(2), L(3), z, P's 17 live entries, a pad
constexpr int kRed = 72;
constexpr int kAcc = 57;    // lik, Hcross upper 21, H_tC 24, H_CC 7, g_C 4
constexpr int kHc = 1, kTc = 22, kCc = 46, kGc = 53;
constexpr int kJf = 10;     // per pixel from pass 1a: J0[2], J1[6], fs0, fs1
constexpr int kFx = 5;      // per pixel, loaded in pass 1a: m, x, iota, a0, b0
constexpr int kNP = 2;      // pixels a thread renders at once in pass 1a
constexpr unsigned kFull = 0xffffffffu;
// shared memory of one SM, and of one block at most (H100)
constexpr int kSmemSM = 233472;
constexpr int kSmemBlock = 232448;

// kLive slot -> offset in a component's 42 values [mu (2), L (3), z,
// P (36)]: mu1, mu2, L00, L01, L11, z, then P[t][b] (at 6 + 6 t + b) for
// (t, b) = (0, 1), (0, 2), (1, 1), (1, 2), (2, 0), (3, 0), (3, 3), (3, 4),
// (3, 5), (4, 0), (4, 3), (4, 4), (4, 5), (5, 0), (5, 3), (5, 4), (5, 5);
// the pad reads nothing
__constant__ int kLiveSrc[kLive] = {0,  1,  2,  3,  4,  5,  7,  8,
                                    13, 14, 18, 24, 27, 28, 29, 30,
                                    33, 34, 35, 36, 39, 40, 41, 0};

template <typename T>
struct Blocks {  // blocks per SM the launcher sizes the buffers for
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

// the first N values of a staged component, by 16-byte vector loads
template <int N>
__device__ __forceinline__ void load_live(const float* src, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}
template <int N>
__device__ __forceinline__ void load_live(const double* src, double (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const double2 x = reinterpret_cast<const double2*>(src)[q];
    v[2 * q] = x.x;
    v[2 * q + 1] = x.y;
  }
}

// (i, j), i <= j, of a symmetric 6 x 6 -> its slot among the 21
__host__ __device__ constexpr int tri(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// One step of a warp sum that spreads its results: a lane keeps one half
// of its 2 H values, by the bit o of its lane number, and adds its
// partner's copy of that half.
template <int H, typename T>
__device__ __forceinline__ void spread_step(T* v, int o, int lane) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T send = up ? v[i] : v[i + H];
    const T keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

// Sums each of 64 values over the warp with 62 shuffles, not 320:
// afterwards lane L holds in v[j], j < 2, the sum of value
// spread_index<64>(j, L).
template <typename T>
__device__ __forceinline__ void spread_sum64(T* v, int lane) {
  spread_step<32>(v, 16, lane);
  spread_step<16>(v, 8, lane);
  spread_step<8>(v, 4, lane);
  spread_step<4>(v, 2, lane);
  spread_step<2>(v, 1, lane);
}

// The same for 16 values with 16 shuffles: lane L holds in v[0] the sum
// of value spread_index<16>(0, L), as does lane L ^ 1.
template <typename T>
__device__ __forceinline__ void spread_sum16(T* v, int lane) {
  spread_step<8>(v, 16, lane);
  spread_step<4>(v, 8, lane);
  spread_step<2>(v, 4, lane);
  spread_step<1>(v, 2, lane);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
}

// mm[k] += wg poly_k(l1, l2), l = L d: the 15 moments (mm[15] unused)
template <typename T>
__device__ __forceinline__ void add_moments(T* mm, T d1, T d2, T L00, T L01,
                                            T L11, T wg) {
  const T l1 = L00 * d1 + L01 * d2;
  const T l2 = L01 * d1 + L11 * d2;
  const T p20 = l1 * l1, p11 = l1 * l2, p02 = l2 * l2;
  const T poly[15] = {T(1), l1, l2, p20, p11, p02,
                      p20 * l1, p20 * l2, l1 * p02, p02 * l2,
                      p20 * p20, p20 * p11, p20 * p02, p11 * p02,
                      p02 * p02};
#pragma unroll
  for (int k = 0; k < 15; ++k) mm[k] += wg * poly[k];
}

template <int N>
__device__ __forceinline__ int spread_index(int j, int lane) {
  int idx = j;
#pragma unroll
  for (int s = 0; s < 5; ++s)
    if ((N >> s) >= 2) idx += ((lane >> (4 - s)) & 1) * (N >> (s + 1));
  return idx;
}

// Pass 1a for NPX pixels (slots of list) of one thread: render every
// component once, leave g in gs, the jacobians and component sums in jf,
// and the pixel's fields (m, x, iota, a0, b0, loaded from `fields` while
// it renders) in fx. A slot that is not valid renders the list's last
// pixel and writes nothing.
template <typename T, int NPX>
__device__ __forceinline__ void render_pixels(const T* cp, int C, int ks,
                                              int cap, int cols,
                                              const int* list,
                                              const int* slot,
                                              const bool* valid, T off0,
                                              T off1, const T* const* fields,
                                              T* gs, T* jf, T* fx) {
  T x1[NPX], x2[NPX], fs0[NPX], fs1[NPX], J0[NPX][2], J1[NPX][6];
  T fv[NPX][kFx];
#pragma unroll
  for (int u = 0; u < NPX; ++u) {
    const int ij = list[slot[u]];
    const int n = (ij >> 16) * cols + (ij & 0xffff);
#pragma unroll
    for (int f = 0; f < kFx; ++f) fv[u][f] = fields[f][n];
    x1[u] = off0 + T(1 + (ij >> 16));
    x2[u] = off1 + T(1 + (ij & 0xffff));
    fs0[u] = fs1[u] = J0[u][0] = J0[u][1] = T(0);
#pragma unroll
    for (int t = 0; t < 6; ++t) J1[u][t] = T(0);
  }
  for (int c = 0; c < ks; ++c) {
    T v[12];
    load_live(cp + c * kLive, v);
#pragma unroll
    for (int u = 0; u < NPX; ++u) {
      const T d1 = x1[u] - v[0], d2 = x2[u] - v[1];
      const T l1 = v[2] * d1 + v[3] * d2, l2 = v[3] * d1 + v[4] * d2;
      const T g = v[5] * exp_t(T(-0.5) * (d1 * l1 + d2 * l2));
      if (valid[u]) gs[(size_t)c * cap + slot[u]] = g;
      fs0[u] += g;
      const T gb1 = g * l1, gb2 = g * l2;
      J0[u][0] += v[6] * gb1 + v[7] * gb2;
      J0[u][1] += v[8] * gb1 + v[9] * gb2;
    }
  }
#pragma unroll 2
  for (int c = ks; c < C; ++c) {
    T v[kLive];
    load_live(cp + c * kLive, v);
#pragma unroll
    for (int u = 0; u < NPX; ++u) {
      const T d1 = x1[u] - v[0], d2 = x2[u] - v[1];
      const T l1 = v[2] * d1 + v[3] * d2, l2 = v[3] * d1 + v[4] * d2;
      const T g = v[5] * exp_t(T(-0.5) * (d1 * l1 + d2 * l2));
      if (valid[u]) gs[(size_t)c * cap + slot[u]] = g;
      fs1[u] += g;
      const T gb1 = g * l1, gb2 = g * l2, gb3 = g * (l1 * l1),
              gb4 = g * (l1 * l2), gb5 = g * (l2 * l2);
      J1[u][0] += v[6] * gb1 + v[7] * gb2;
      J1[u][1] += v[8] * gb1 + v[9] * gb2;
      J1[u][2] += v[10] * g;
      J1[u][3] += v[11] * g + v[12] * gb3 + v[13] * gb4 + v[14] * gb5;
      J1[u][4] += v[15] * g + v[16] * gb3 + v[17] * gb4 + v[18] * gb5;
      J1[u][5] += v[19] * g + v[20] * gb3 + v[21] * gb4 + v[22] * gb5;
    }
  }
#pragma unroll
  for (int u = 0; u < NPX; ++u) {
    if (!valid[u]) continue;
    T* f = jf + slot[u];
    f[0] = J0[u][0];
    f[cap] = J0[u][1];
#pragma unroll
    for (int t = 0; t < 6; ++t) f[(2 + t) * cap] = J1[u][t];
    f[8 * cap] = fs0[u];
    f[9 * cap] = fs1[u];
#pragma unroll
    for (int k = 0; k < kFx; ++k) fx[k * cap + slot[u]] = fv[u][k];
  }
}

// Shared memory of a block: C components (live layout), their moments,
// per held pixel g of each component, W0, W1, the pass-1a fields, the
// pixel fields and the packed coordinates, and the per-warp sums and
// ballot counts.
template <typename T>
size_t smem_bytes(int C, int cap) {
  return ((size_t)C * (kLive + 15) + (size_t)(C + 2 + kJf + kFx) * cap +
          kWarps * kAcc) * sizeof(T) +
         ((size_t)cap + 2 * kWarps) * sizeof(int);
}

// Active pixels held at a time: a multiple of kNP kThreads, as many as fit
// Blocks<T> blocks on an SM (at least one such multiple), no more than the
// tile needs.
template <typename T>
int capacity(int C, int N) {
  const int step = kNP * kThreads;
  const size_t budget = (size_t)kSmemSM / Blocks<T>::value - 1024;
  const size_t per = (size_t)(C + 2 + kJf + kFx) * sizeof(T) + sizeof(int);
  const size_t fixed = smem_bytes<T>(C, 0);
  int cap = budget > fixed ? (int)((budget - fixed) / per) : 0;
  cap = cap / step * step;
  const int need = (N + step - 1) / step * step;
  return max(step, min(cap, need));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Blocks<T>::value)
refresh_kernel(const T* __restrict__ mu, const T* __restrict__ lv,
               const T* __restrict__ z, const T* __restrict__ pch,
               const T* __restrict__ cl4, const T* __restrict__ off,
               const T* __restrict__ pixels, const T* __restrict__ mask,
               const T* __restrict__ iota, const T* __restrict__ a0,
               const T* __restrict__ b0, T* __restrict__ m15,
               T* __restrict__ red, int C, int ks, int N, int cols, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cp = reinterpret_cast<T*>(smem);     // C * kLive
  T* ms = cp + C * kLive;                  // C * 15
  T* gs = ms + C * 15;                     // C * cap
  T* w0s = gs + (size_t)C * cap;           // cap
  T* w1s = w0s + cap;                      // cap
  T* jf = w1s + cap;                       // kJf * cap
  T* fx = jf + (size_t)kJf * cap;          // kFx * cap
  T* part = fx + (size_t)kFx * cap;        // kWarps * kAcc
  int* list = reinterpret_cast<int*>(part + kWarps * kAcc);  // cap
  int* wcount = list + cap;                // 2 * kWarps

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < C * kLive; e += kThreads) {
    const size_t rc = (size_t)row * C + e / kLive;  // (row, component)
    const int k = e % kLive;
    T v = T(0);
    if (k < 2)
      v = mu[rc * 2 + k];
    else if (k < 5)
      v = lv[rc * 3 + k - 2];
    else if (k == 5)
      v = z[rc];
    else if (k < kLive - 1)
      v = pch[rc * 36 + kLiveSrc[k] - 6];
    cp[e] = v;
  }
  for (int e = tid; e < C * 15; e += kThreads) ms[e] = T(0);
  for (int e = tid; e < kWarps * kAcc; e += kThreads) part[e] = T(0);

  const T cl0 = cl4[4 * row], cl1 = cl4[4 * row + 1];
  const T cll0 = cl4[4 * row + 2], cll1 = cl4[4 * row + 3];
  const T off0 = off[2 * row], off1 = off[2 * row + 1];
  const size_t base = (size_t)row * N;
  const T* msk = mask + base;
  const T* const fields[kFx] = {msk, pixels + base, iota + base, a0 + base,
                                b0 + base};
  __syncthreads();

  // the mask of this and the next kAhead chunks of kThreads pixels
  constexpr int kAhead = 3;
  T m_ring[kAhead + 1];
#pragma unroll
  for (int q = 0; q <= kAhead; ++q)
    m_ring[q] = q * kThreads + tid < N ? msk[q * kThreads + tid] : T(0);
  int raw = 0, round = 0;
  while (raw < N) {
    // fill: compact the next active pixels into list, (i << 16) | j
    int n_list = 0;
    while (raw < N) {
      const int p = raw + tid;
      const bool act = m_ring[0] > T(0);
      const unsigned bal = __ballot_sync(kFull, act);
      int* wc = wcount + (round & 1) * kWarps;  // two buffers: no barrier
      ++round;                                  // between read and rewrite
      if (lane == 0) wc[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wc[w] : 0;
        total += wc[w];
      }
      if (n_list + total > cap) break;  // block-uniform
      if (act)
        list[n_list + before + __popc(bal & ((1u << lane) - 1u))] =
            (p / cols) << 16 | (p % cols);
      n_list += total;
      raw += kThreads;
#pragma unroll
      for (int q = 0; q < kAhead; ++q) m_ring[q] = m_ring[q + 1];
      const int pa = p + kAhead * kThreads + kThreads;
      m_ring[kAhead] = pa < N ? msk[pa] : T(0);
    }
    __syncthreads();

    // pass 1a: a thread renders pixels a0 + u kThreads + tid, u < kNP; a
    // warp takes the two-pixel path if any of its lanes has a second one
    for (int a0i = 0; a0i < n_list; a0i += kNP * kThreads) {
      int slot[kNP];
      bool valid[kNP];
#pragma unroll
      for (int u = 0; u < kNP; ++u) {
        const int a = a0i + u * kThreads + tid;
        valid[u] = a < n_list;
        slot[u] = valid[u] ? a : n_list - 1;
      }
      if (a0i + kThreads + warp * 32 < n_list)
        render_pixels<T, 2>(cp, C, ks, cap, cols, list, slot, valid, off0,
                            off1, fields, gs, jf, fx);
      else if (a0i + warp * 32 < n_list)
        render_pixels<T, 1>(cp, C, ks, cap, cols, list, slot, valid, off0,
                            off1, fields, gs, jf, fx);
    }

    // pass 1b: the same thread, one of its pixels at a time
    T acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = T(0);
    for (int a = tid; a < n_list; a += kThreads) {
      const T m = fx[a], x = fx[cap + a], iot = fx[2 * cap + a];
      const T J0[2] = {jf[a], jf[cap + a]};
      T J1[6];
#pragma unroll
      for (int t = 0; t < 6; ++t) J1[t] = jf[(2 + t) * cap + a];
      const T fs0 = jf[8 * cap + a], fs1 = jf[9 * cap + a];

      // Poisson-bound weight fields (ops/refresh._poisson_weight_fields)
      const T s1 = cl0 * fs0 + cl1 * fs1;
      const T s2 = cll0 * fs0 * fs0 + cll1 * fs1 * fs1;
      const T E = fx[3 * cap + a] + s1;
      const T V = fx[4 * cap + a] + s2 - s1 * s1;
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
      w0s[a] = g1 * cl0 + g2 * u0;
      w1s[a] = g1 * cl1 + g2 * u1;
      acc[0] += m * (x * (log_t(E) - T(0.5) * V * rE2) - iot * E);

      // cross fields (ops/refresh._cross_fields), J0 rows 2..5 being 0
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
      T U0[6], U1[6];
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        U0[t] = t < 2 ? f00 * J0[t] + f01 * J1[t] : f01 * J1[t];
        U1[t] = t < 2 ? f01 * J0[t] + f11 * J1[t] : f11 * J1[t];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j)
          acc[kHc + tri(i, j)] += i < 2 ? J0[i] * U0[j] + J1[i] * U1[j]
                                        : J1[i] * U1[j];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[kTc + i * 4 + j] += i < 2 ? J0[i] * A0[j] + J1[i] * A1[j]
                                        : J1[i] * A1[j];
      }
      acc[kCc + 0] += h11 * fs0 * fs0;
      acc[kCc + 1] += h11 * fs0 * fs1;
      acc[kCc + 2] += h11 * fs1 * fs1;
      acc[kCc + 3] += h12 * fs0 * (fs0 * fs0);
      acc[kCc + 4] += h12 * fs0 * (fs1 * fs1);
      acc[kCc + 5] += h12 * fs1 * (fs0 * fs0);
      acc[kCc + 6] += h12 * fs1 * (fs1 * fs1);
      acc[kGc + 0] += g1 * fs0;
      acc[kGc + 1] += g1 * fs1;
      acc[kGc + 2] += g2 * (fs0 * fs0);
      acc[kGc + 3] += g2 * (fs1 * fs1);
    }
    {
      T v[64];
#pragma unroll
      for (int k = 0; k < 64; ++k) v[k] = k < kAcc ? acc[k] : T(0);
      spread_sum64(v, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = spread_index<64>(j, lane);
        if (k < kAcc) part[warp * kAcc + k] += v[j];
      }
    }
    __syncthreads();

    // pass 2: a warp per two components, 15 W-weighted moments each, from
    // the g that pass 1a left
    for (int c0 = 2 * warp; c0 < C; c0 += 2 * kWarps) {
      const int c1 = c0 + 1 < C ? c0 + 1 : c0;
      const T* pa = cp + c0 * kLive;
      const T* pb = cp + c1 * kLive;
      const T ma1 = pa[0], ma2 = pa[1], La00 = pa[2], La01 = pa[3];
      const T La11 = pa[4];
      const T mb1 = pb[0], mb2 = pb[1], Lb00 = pb[2], Lb01 = pb[3];
      const T Lb11 = pb[4];
      const T* wa = c0 < ks ? w0s : w1s;
      const T* wb = c1 < ks ? w0s : w1s;
      const T* ga = gs + (size_t)c0 * cap;
      const T* gb = gs + (size_t)c1 * cap;
      T mma[16], mmb[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) mma[k] = mmb[k] = T(0);
      for (int a = lane; a < n_list; a += 32) {
        const int ij = list[a];
        const T x1 = off0 + T(1 + (ij >> 16));
        const T x2 = off1 + T(1 + (ij & 0xffff));
        add_moments(mma, x1 - ma1, x2 - ma2, La00, La01, La11, wa[a] * ga[a]);
        add_moments(mmb, x1 - mb1, x2 - mb2, Lb00, Lb01, Lb11, wb[a] * gb[a]);
      }
      spread_sum16(mma, lane);
      spread_sum16(mmb, lane);
      const int k = spread_index<16>(0, lane);
      if (!(lane & 1) && k < 15) {
        ms[c0 * 15 + k] += mma[0];
        if (c1 != c0) ms[c1 * 15 + k] += mmb[0];
      }
    }
    __syncthreads();  // before the next fill rewrites list, gs, w0s, w1s
  }

  if (tid < kRed) {
    // output slot tid <- sum k (Hcross mirrored from its upper half)
    int k;
    if (tid == 0) {
      k = 0;
    } else if (tid < 37) {
      const int i = (tid - 1) / 6, j = (tid - 1) % 6;
      k = kHc + (i <= j ? tri(i, j) : tri(j, i));
    } else {
      k = tid - 37 + kTc;  // H_tC, H_CC and g_C follow in order
    }
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += part[w * kAcc + k];
    red[(size_t)row * kRed + tid] = s;
  }
  for (int e = tid; e < C * 15; e += kThreads)
    m15[(size_t)row * C * 15 + e] = ms[e];
}

template <typename T>
int launch_refresh(const void* mu, const void* lv, const void* z,
                   const void* pch, const void* cl4, const void* off,
                   const void* pixels, const void* mask, const void* iota,
                   const void* a0, const void* b0, void* m15, void* red,
                   int G, int C, int ks, int N, int cols, void* stream) {
  if (cols < 1 || cols >= (1 << 15) || N / cols >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  const int cap = capacity<T>(C, N);
  const size_t smem = smem_bytes<T>(C, cap);
  if (smem > (size_t)kSmemBlock) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        refresh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  refresh_kernel<T><<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)mu, (const T*)lv, (const T*)z, (const T*)pch, (const T*)cl4,
      (const T*)off, (const T*)pixels, (const T*)mask, (const T*)iota,
      (const T*)a0, (const T*)b0, (T*)m15, (T*)red, C, ks, N, cols, cap);
  return (int)cudaGetLastError();
}

// registers, local (stack + spill) bytes, dynamic shared bytes and
// resident blocks per SM of the kernel for C components on a 32 x 32 tile
template <typename T>
int refresh_attrs(int C, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, refresh_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(C, capacity<T>(C, 1024));
  err = cudaFuncSetAttribute(refresh_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, refresh_kernel<T>, kThreads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)err;
}

}  // namespace

extern "C" const char* celeste_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#define CELESTE_REFRESH_ENTRY(SUFFIX, T)                                      \
  extern "C" int celeste_refresh_##SUFFIX(                                    \
      const void* mu, const void* lv, const void* z, const void* pch,         \
      const void* cl4, const void* off, const void* pixels, const void* mask, \
      const void* iota, const void* a0, const void* b0, void* m15, void* red, \
      int G, int C, int ks, int N, int cols, void* stream) {                  \
    return launch_refresh<T>(mu, lv, z, pch, cl4, off, pixels, mask, iota,    \
                             a0, b0, m15, red, G, C, ks, N, cols, stream);    \
  }                                                                           \
  extern "C" int celeste_refresh_attrs_##SUFFIX(int C, int* out) {            \
    return refresh_attrs<T>(C, out);                                          \
  }

CELESTE_REFRESH_ENTRY(f32, float)
CELESTE_REFRESH_ENTRY(f64, double)
