// The A-round engine of the parallel-Jacobi sweep kernels, one thread block
// per matrix: the fused sweep K2 (jacobi_sweep.cu, A and Q) and the A
// phase K2a of the split sweep (jacobi_sweep_split.cu, A and a log of each
// round's (c, s)) are two instances of `sweep_kernel`.
//
// A sweep is D-1 rounds. Each round computes, for the D/2 pairs at
// positions (2k, 2k+1), the rotation (c, s) from the round's starting A
// (live only where |a_pq| > 1e-30), rotates the rows and then the columns
// of A (and the columns of Q), and applies the circle-method permutation
// (ops/jacobi._round_robin_perm): the element at position j comes from
// position perm[j]. Same formulas as ops/eigh.jacobi_sweep_plain, with the
// arithmetic of jacobi_round.cuh.
//
// What bounds it on the card: not bytes (A and Q cross device memory once
// a sweep) and not flops (~9 D^2 a round with Q, ~6 D^2 without), but the
// chain of D-1 dependent rounds, each a barrier, the (c, s) chain (two
// divisions and two square roots in a row) and the shared-memory traffic
// of the rotated entries. The design, with D a template parameter (even D
// in [4, 64], CELESTE_SWEEP_DIMS):
// - one barrier a round. A ping-pongs between two shared buffers: a worker
//   lane reads a 2x2 block (rows 2 k1, 2 k1 + 1, columns 2 k2, 2 k2 + 1) of
//   the round's A as two vector loads, rotates its rows and then its
//   columns, and writes the four entries straight to their permuted places
//   in the other buffer. Meanwhile warp 0 (lane k) recomputes, from the
//   same round's A and (c, s), the three entries of the next round's pair
//   k (the same arithmetic, so the same bits as the entries the workers
//   store) and writes the next (c, s) into a second (c, s) buffer, and,
//   with the log, to the log in device memory (two coalesced stores a
//   round, off the workers' path). The barrier at the end of the round
//   publishes both.
// - no index arithmetic in the round loop: worker warp 1 + G takes the row
//   pairs G, G + RW, ..., with G a template parameter, so every row offset
//   (through the permutation, the same every round) is a constant; lane k2
//   takes column pair k2 and holds its two destination columns.
// - Q needs no second buffer: it is held with its columns in the circle
//   method's label order (position j of round 0 holds label label0(j)),
//   where a round's pair k is the labels (arr_r[k], arr_r[D-1-k]) with
//   arr_r[0] = 0 and arr_r[i] = 1 + (i - 1 - r) mod (D-1). Lane k2 of a
//   worker warp rotates its pair slot's two label columns in place in the
//   warp's rows, stepping each label down by one a round (mod D-1). The
//   permutation has order D-1, so after the sweep the labels are back where
//   they started and Q is stored back through label0.
// - 3 D^2 values of shared memory with Q (21 KB in f32 at D = 42), 2 D^2
//   without (14 KB), and 4 warps (the (c, s) warp on a scheduler of its own
//   when a block is alone on its SM), so eight matrices fit on an SM and
//   the fit's 1024 matrices run in one wave on 132 SMs.

#pragma once

#include <type_traits>

#include "jacobi_round.cuh"

// The sizes the sweep kernels are compiled for: every even D in [4, 64]
// (ops/eigh.SWEEP_DIMS); anything else is refused.
#define CELESTE_SWEEP_DIMS(X)                                                 \
  X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(18) X(20) X(22) X(24) X(26)      \
  X(28) X(30) X(32) X(34) X(36) X(38) X(40) X(42) X(44) X(46) X(48) X(50)   \
  X(52) X(54) X(56) X(58) X(60) X(62) X(64)

namespace {

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// The label of position j of a sweep's round 0 (Q's columns are held in
// label order).
template <int D>
__host__ __device__ constexpr int label0(int j) {
  return (j & 1) ? D - 1 - (j >> 1) : (j >> 1);
}

// The compile-time schedule of a D x D sweep.
template <int D>
struct Sweep {
  static constexpr int K = D / 2;
  // worker warps: warp 1 + G takes the row pairs k1 = G, G + RW, ... of A
  // and the rows G, G + RW, ... of Q; its lane k takes column pair k of A
  // and pair slot k of Q (lanes past K idle)
  static constexpr int RW = K < 3 ? K : 3;
  static constexpr int kThreads = 32 * (1 + RW);
  static constexpr int NI = (K + RW - 1) / RW;  // row pairs of A a warp
  static constexpr int NQ = (D + RW - 1) / RW;  // rows of Q a warp
  static constexpr int kBatchA = 7;  // blocks whose loads go out together
  static constexpr int kBatchQ = 14;  // rows of Q likewise
  // the circle method's permutation and its inverse (where position i's
  // element goes)
  __host__ __device__ static constexpr int perm(int j) {
    return (j & 1) == 0 ? ((j >> 1) < 2 ? (j >> 1) : j - 2)
                        : ((j >> 1) < K - 1 ? j + 2 : D - 2);
  }
  __host__ __device__ static constexpr int pinv(int i) {
    return i == 0 ? 0
         : i == 1 ? 2
         : (i & 1) ? i - 2
         : i == D - 2 ? D - 1
                      : i + 2;
  }
  // A's two buffers, Q's one with Q, and two (c, s) buffers
  static constexpr size_t smem_bytes(size_t value, bool with_q) {
    return (with_q ? 3 : 2) * (size_t)D * D * value + 2 * K * 2 * value;
  }
  // the blocks an SM holds by its 227 KB of shared memory (1 KB reserved a
  // block), at most 8 in f32 (132 SMs x 8 >= 1024 matrices: one wave) and
  // 5 in f64 (102 registers a thread: a round's loads in f64 take ~96):
  // the register budget __launch_bounds__ asks for
  static constexpr int min_blocks(size_t value, bool with_q) {
    return (int)(232448 / (smem_bytes(value, with_q) + 1024)) <
                   (value == 4 ? 8 : 5)
               ? (int)(232448 / (smem_bytes(value, with_q) + 1024))
               : (value == 4 ? 8 : 5);
  }
};

// Entry (x, y) of the next round's A, from its source 2x2 block: rx holds
// row x's pair of columns, ro row x^1's; xodd, yodd are x & 1 and y & 1;
// csa and csb are the (c, s) of x's and y's pairs. The workers' arithmetic,
// entry by entry.
template <typename T, typename P>
__device__ __forceinline__ T next_entry(P rx, P ro, bool xodd, bool yodd,
                                        P csa, P csb) {
  const T sa = xodd ? csa.y : -csa.y;
  const T sb = yodd ? csb.y : -csb.y;
  const T t0 = rot(rx.x, ro.x, csa.x, sa);
  const T t1 = rot(rx.y, ro.y, csa.x, sa);
  return yodd ? rot(t1, t0, csb.x, sb) : rot(t0, t1, csb.x, sb);
}

// One round of worker warp G (lane k2 < K): A's blocks (2 k1, 2 k2) for
// k1 = G, G + RW, ... from a into an, and, with Q, Q's pair slot k2 (labels
// pl, ql) in rows G, G + RW, ... With G a template parameter every row
// offset is a constant: the round does no index arithmetic. Loads go out a
// batch at a time (up to all of a round's), ahead of the batch's arithmetic
// and stores.
template <typename T, int D, int G, bool kWithQ>
__device__ __forceinline__ void worker_round(
    const T* __restrict__ a, T* __restrict__ an,
    const typename Pair<T>::type* __restrict__ cs, T* __restrict__ q, int k2,
    int col0, int col1, int pl, int ql) {
  using S = Sweep<D>;
  using P = typename Pair<T>::type;
  const P c2 = cs[k2];
  const T ms2 = -c2.y;
  const T* a2 = a + 2 * k2;
#pragma unroll
  for (int t0 = 0; t0 < S::NI; t0 += S::kBatchA) {
    P c1[S::kBatchA], r0[S::kBatchA], r1[S::kBatchA];
#pragma unroll
    for (int u = 0; u < S::kBatchA; ++u) {
      const int k1 = G + (t0 + u) * S::RW;
      if (t0 + u < S::NI && k1 < S::K) {
        c1[u] = cs[k1];
        r0[u] = *reinterpret_cast<const P*>(a2 + 2 * k1 * D);
        r1[u] = *reinterpret_cast<const P*>(a2 + (2 * k1 + 1) * D);
      }
    }
#pragma unroll
    for (int u = 0; u < S::kBatchA; ++u) {
      const int k1 = G + (t0 + u) * S::RW;
      if (t0 + u < S::NI && k1 < S::K) {
        const T ms1 = -c1[u].y;
        const T t00 = rot(r0[u].x, r1[u].x, c1[u].x, ms1);
        const T t01 = rot(r0[u].y, r1[u].y, c1[u].x, ms1);
        const T t10 = rot(r1[u].x, r0[u].x, c1[u].x, c1[u].y);
        const T t11 = rot(r1[u].y, r0[u].y, c1[u].x, c1[u].y);
        T* row0 = an + S::pinv(2 * k1) * D;
        T* row1 = an + S::pinv(2 * k1 + 1) * D;
        row0[col0] = rot(t00, t01, c2.x, ms2);
        row0[col1] = rot(t01, t00, c2.x, c2.y);
        row1[col0] = rot(t10, t11, c2.x, ms2);
        row1[col1] = rot(t11, t10, c2.x, c2.y);
      }
    }
  }
  if constexpr (kWithQ) {
    T* const qp = q + pl;
    T* const qq = q + ql;
#pragma unroll
    for (int t0 = 0; t0 < S::NQ; t0 += S::kBatchQ) {
      T x[S::kBatchQ], y[S::kBatchQ];
#pragma unroll
      for (int u = 0; u < S::kBatchQ; ++u) {
        const int i = G + (t0 + u) * S::RW;
        if (t0 + u < S::NQ && i < D) {
          x[u] = qp[i * D];
          y[u] = qq[i * D];
        }
      }
#pragma unroll
      for (int u = 0; u < S::kBatchQ; ++u) {
        const int i = G + (t0 + u) * S::RW;
        if (t0 + u < S::NQ && i < D) {
          qp[i * D] = rot(x[u], y[u], c2.x, ms2);
          qq[i * D] = rot(y[u], x[u], c2.x, c2.y);
        }
      }
    }
  }
}

// worker_round for the warp's own G, chosen at run time
template <typename T, int D, bool kWithQ, int G = 0>
__device__ __forceinline__ void worker_dispatch(
    int g, const T* a, T* an, const typename Pair<T>::type* cs, T* q, int k2,
    int col0, int col1, int pl, int ql) {
  if (g == G) {
    worker_round<T, D, G, kWithQ>(a, an, cs, q, k2, col0, col1, pl, ql);
  } else if constexpr (G + 1 < Sweep<D>::RW) {
    worker_dispatch<T, D, kWithQ, G + 1>(g, a, an, cs, q, k2, col0, col1, pl,
                                         ql);
  }
}

// One sweep of matrix blockIdx.x: A into Ao; with kWithQ, Q's columns
// rotated into Qo; with kLog, round r's (c, s) to cs_log[b][r][0][k] and
// cs_log[b][r][1][k] (the (B, D-1, 2, D/2) log of the split sweep).
template <typename T, int D, bool kWithQ, bool kLog>
__global__ void __launch_bounds__(Sweep<D>::kThreads,
                                  Sweep<D>::min_blocks(sizeof(T), kWithQ))
    sweep_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                 T* __restrict__ Ao, T* __restrict__ Qo,
                 T* __restrict__ cs_log) {
  using S = Sweep<D>;
  using P = typename Pair<T>::type;
  constexpr int K = S::K, n = D * D;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const a0 = reinterpret_cast<T*>(smem);
  T* const a1 = a0 + n;
  T* const q = a1 + n;  // with kWithQ only
  P* const cs0 = reinterpret_cast<P*>(a1 + (kWithQ ? 2 : 1) * n);
  P* const cs1 = cs0 + K;

  const size_t base = (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += S::kThreads) {
    a0[e] = A[base + e];
    if constexpr (kWithQ) {
      const int i = e / D, j = e - (e / D) * D;
      q[i * D + label0<D>(j)] = Q[base + e];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this matrix's log; warp 0 stores round r's (c, s) at lg + r * 2K
  T* const lg =
      kLog ? cs_log + (size_t)blockIdx.x * (D - 1) * 2 * K : nullptr;
  if (warp == 0 && lane < K) {  // round 0's (c, s)
    const int d = 2 * lane * (D + 1);
    T c, s;
    round_cs(a0[d], a0[d + D + 1], a0[d + 1], c, s);
    cs0[lane] = P{c, s};
    if constexpr (kLog) {
      lg[lane] = c;
      lg[K + lane] = s;
    }
  }
  __syncthreads();

  // warp 0, lane k: the next round's pair k is (perm(2k), perm(2k+1)) of
  // this round; its three entries come from the diagonal blocks of pa's
  // and qb's pairs and the block between them
  const bool cs_lane = warp == 0 && lane < K;
  const int pa = S::perm(2 * lane), qb = S::perm(2 * lane + 1);
  const int ka = pa >> 1, kb = qb >> 1;
  const int o_pp = pa * D + 2 * ka, o_qq = qb * D + 2 * kb;
  const int o_pq = pa * D + 2 * kb;
  const int x_step_a = (pa & 1) ? -D : D, x_step_b = (qb & 1) ? -D : D;

  // worker warps: column pair k2 = lane goes to columns col0, col1; its
  // pair slot's labels in Q this round are pl, ql (each steps down by one
  // a round, mod D-1; slot 0's first label stays 0)
  const bool worker = warp > 0 && lane < K;
  const int k2 = lane;
  const int col0 = S::pinv(2 * k2), col1 = S::pinv(2 * k2 + 1);
  int pl = k2, ql = D - 1 - k2;

  // columns 2k, 2k + 1 of a row, a vector load
  auto pair = [](const T* e) { return *reinterpret_cast<const P*>(e); };

  // round r: reads a and cs, writes an and (unless last) csn
  auto do_round = [&](int r, const T* a, T* an, const P* cs, P* csn) {
    if (cs_lane) {
      if (r + 1 < D - 1) {
        const P ca = cs[ka], cb = cs[kb];
        const bool xo = pa & 1, yo = qb & 1;
        const T app = next_entry<T>(
            pair(a + o_pp), pair(a + o_pp + x_step_a), xo, xo, ca, ca);
        const T aqq = next_entry<T>(
            pair(a + o_qq), pair(a + o_qq + x_step_b), yo, yo, cb, cb);
        const T apq = next_entry<T>(
            pair(a + o_pq), pair(a + o_pq + x_step_a), xo, yo, ca, cb);
        T c, s;
        round_cs(app, aqq, apq, c, s);
        csn[lane] = P{c, s};
        if constexpr (kLog) {
          T* const next = lg + (r + 1) * 2 * K;
          next[lane] = c;
          next[K + lane] = s;
        }
      }
    } else if (worker) {
      worker_dispatch<T, D, kWithQ>(warp - 1, a, an, cs, q, k2, col0, col1,
                                    pl, ql);
      if constexpr (kWithQ) {
        pl = k2 == 0 ? 0 : (pl == 1 ? D - 1 : pl - 1);
        ql = ql == 1 ? D - 1 : ql - 1;
      }
    }
  };

  for (int r = 0; r < D - 1; r += 2) {
    do_round(r, a0, a1, cs0, cs1);
    __syncthreads();
    if (r + 1 < D - 1) {
      do_round(r + 1, a1, a0, cs1, cs0);
      __syncthreads();
    }
  }

  // D - 1 is odd: the last round wrote a1
  for (int e = threadIdx.x; e < n; e += S::kThreads) {
    Ao[base + e] = a1[e];
    if constexpr (kWithQ) {
      const int i = e / D, j = e - (e / D) * D;
      Qo[base + e] = q[i * D + label0<D>(j)];
    }
  }
}

template <typename T, int D, bool kWithQ, bool kLog>
int launch_sweep(const void* A, const void* Q, void* Ao, void* Qo,
                 void* cs_log, int B, void* stream) {
  const size_t smem = Sweep<D>::smem_bytes(sizeof(T), kWithQ);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T, D, kWithQ, kLog>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_kernel<T, D, kWithQ, kLog>
      <<<B, Sweep<D>::kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)A, (const T*)Q, (T*)Ao, (T*)Qo, (T*)cs_log);
  return (int)cudaGetLastError();
}

// What the card reports for a kernel launched with `threads` threads and
// `smem` bytes of shared memory a block: registers, local memory, shared
// memory and resident blocks per SM (ops/_build.kernel_attrs).
template <typename Kernel>
int kernel_attrs(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)err;
}

template <typename T, int D, bool kWithQ, bool kLog>
int sweep_attrs(int* out) {
  return kernel_attrs(sweep_kernel<T, D, kWithQ, kLog>, Sweep<D>::kThreads,
                      Sweep<D>::smem_bytes(sizeof(T), kWithQ), out);
}

// f(std::integral_constant<int, D>{}) for D in CELESTE_SWEEP_DIMS; an
// error for any other D.
template <typename F>
int with_sweep_dim(int D, F&& f) {
  switch (D) {
#define CELESTE_SWEEP_CASE(DD) \
  case DD:                     \
    return f(std::integral_constant<int, DD>{});
    CELESTE_SWEEP_DIMS(CELESTE_SWEEP_CASE)
#undef CELESTE_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
