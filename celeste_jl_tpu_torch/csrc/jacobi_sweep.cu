// One cyclic parallel-Jacobi sweep of a batch of symmetric D x D matrices,
// one thread block per matrix.
//
// Replaces celeste_jl_tpu/ops/pallas_eigh.py::_sweep_aq_kernel (the fused
// A+Q sweep the TPU runs VMEM-resident on 128-lane blocks). A sweep is
// D-1 rounds. Each round computes, for the D/2 pairs at positions
// (2k, 2k+1), the rotation (c, s) from the round's starting A (live only
// where |a_pq| > 1e-30), rotates the rows and then the columns of A and
// the columns of Q, and applies the circle-method permutation
// (ops/jacobi._round_robin_perm): the element at position j comes from
// position perm[j]. Same formulas as ops/eigh.jacobi_sweep_plain, with the
// arithmetic of jacobi_round.cuh (the split sweep's too).
//
// What bounds it on the card: not bytes (A and Q cross device memory once
// a sweep) and not flops (~9 D^2 a round), but the chain of D-1 dependent
// rounds, each a barrier, the (c, s) chain (two divisions and two square
// roots in a row) and the shared-memory traffic of 2 D^2 rotated entries.
// The design, with D a template parameter (even D in [4, 64], one instance
// each):
// - one barrier a round. A ping-pongs between two shared buffers: a worker
//   lane reads a 2x2 block (rows 2 k1, 2 k1 + 1, columns 2 k2, 2 k2 + 1) of
//   the round's A as two vector loads, rotates its rows and then its
//   columns, and writes the four entries straight to their permuted places
//   in the other buffer. Meanwhile warp 0 (lane k) recomputes, from the
//   same round's A and (c, s), the three entries of the next round's pair
//   k (the same arithmetic, so the same bits as the entries the workers
//   store) and writes the next (c, s) into a second (c, s) buffer. The
//   barrier at the end of the round publishes both.
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
// - 3 D^2 values of shared memory (21 KB in f32 at D = 42) and 4 warps (the
//   (c, s) warp on a scheduler of its own when a block is alone on its SM),
//   so eight matrices fit on an SM and the fit's 1024 matrices run in one
//   wave on 132 SMs.

#include "jacobi_round.cuh"

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
  // the circle method's permutation, its inverse (where position i's
  // element goes), and the label of position j at round 0
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
  __host__ __device__ static constexpr int label0(int j) {
    return (j & 1) ? D - 1 - (j >> 1) : (j >> 1);
  }
  static constexpr size_t smem_bytes(size_t value) {
    return 3 * (size_t)D * D * value + 2 * K * 2 * value;
  }
  // the blocks an SM holds by its 227 KB of shared memory (1 KB reserved a
  // block), at most 8 (132 SMs x 8 >= 1024 matrices: one wave): the
  // register budget __launch_bounds__ asks for
  static constexpr int min_blocks(size_t value) {
    return (int)(232448 / (smem_bytes(value) + 1024)) < 8
               ? (int)(232448 / (smem_bytes(value) + 1024))
               : 8;
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
// k1 = G, G + RW, ... from a into an, and Q's pair slot k2 (labels pl, ql)
// in rows G, G + RW, ... With G a template parameter every row offset is a
// constant: the round does no index arithmetic. Loads go out a batch at a
// time (up to all of a round's), ahead of the batch's arithmetic and
// stores.
template <typename T, int D, int G>
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

// worker_round for the warp's own G, chosen at run time
template <typename T, int D, int G = 0>
__device__ __forceinline__ void worker_dispatch(
    int g, const T* a, T* an, const typename Pair<T>::type* cs, T* q, int k2,
    int col0, int col1, int pl, int ql) {
  if (g == G) {
    worker_round<T, D, G>(a, an, cs, q, k2, col0, col1, pl, ql);
  } else if constexpr (G + 1 < Sweep<D>::RW) {
    worker_dispatch<T, D, G + 1>(g, a, an, cs, q, k2, col0, col1, pl, ql);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Sweep<D>::kThreads,
                                  Sweep<D>::min_blocks(sizeof(T)))
    sweep_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                 T* __restrict__ Ao, T* __restrict__ Qo) {
  using S = Sweep<D>;
  using P = typename Pair<T>::type;
  constexpr int K = S::K, n = D * D;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const a0 = reinterpret_cast<T*>(smem);
  T* const a1 = a0 + n;
  T* const q = a1 + n;
  P* const cs0 = reinterpret_cast<P*>(q + n);
  P* const cs1 = cs0 + K;

  const size_t base = (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += S::kThreads) {
    const int i = e / D, j = e - (e / D) * D;
    a0[e] = A[base + e];
    q[i * D + S::label0(j)] = Q[base + e];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0 && lane < K) {  // round 0's (c, s)
    const int d = 2 * lane * (D + 1);
    T c, s;
    round_cs(a0[d], a0[d + D + 1], a0[d + 1], c, s);
    cs0[lane] = P{c, s};
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

  // one round: reads a and cs, writes an and (unless last) csn
  auto do_round = [&](const T* a, T* an, const P* cs, P* csn, bool last) {
    if (cs_lane) {
      if (!last) {
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
      }
    } else if (worker) {
      worker_dispatch<T, D>(warp - 1, a, an, cs, q, k2, col0, col1, pl, ql);
      pl = k2 == 0 ? 0 : (pl == 1 ? D - 1 : pl - 1);
      ql = ql == 1 ? D - 1 : ql - 1;
    }
  };

  for (int r = 0; r < D - 1; r += 2) {
    do_round(a0, a1, cs0, cs1, r + 1 == D - 1);
    __syncthreads();
    if (r + 1 < D - 1) {
      do_round(a1, a0, cs1, cs0, r + 2 == D - 1);
      __syncthreads();
    }
  }

  // D - 1 is odd: the last round wrote a1
  for (int e = threadIdx.x; e < n; e += S::kThreads) {
    const int i = e / D, j = e - (e / D) * D;
    Ao[base + e] = a1[e];
    Qo[base + e] = q[i * D + S::label0(j)];
  }
}

template <typename T, int D>
int launch_sweep(const void* A, const void* Q, void* Ao, void* Qo, int B,
                 void* stream) {
  const size_t smem = Sweep<D>::smem_bytes(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_kernel<T, D><<<B, Sweep<D>::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)Q, (T*)Ao, (T*)Qo);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int sweep_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sweep_kernel<T, D>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Sweep<D>::smem_bytes(sizeof(T));
  err = cudaFuncSetAttribute(sweep_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sweep_kernel<T, D>, Sweep<D>::kThreads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)err;
}

// D-dispatch: every even D in [4, 64]; anything else is refused.
#define CELESTE_SWEEP_DIMS(X)                                                 \
  X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(18) X(20) X(22) X(24) X(26)      \
  X(28) X(30) X(32) X(34) X(36) X(38) X(40) X(42) X(44) X(46) X(48) X(50)   \
  X(52) X(54) X(56) X(58) X(60) X(62) X(64)

template <typename T>
int dispatch_sweep(const void* A, const void* Q, void* Ao, void* Qo, int B,
                   int D, void* stream) {
  switch (D) {
#define CELESTE_SWEEP_CASE(DD) \
  case DD:                     \
    return launch_sweep<T, DD>(A, Q, Ao, Qo, B, stream);
    CELESTE_SWEEP_DIMS(CELESTE_SWEEP_CASE)
#undef CELESTE_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_attrs(int D, int* out) {
  switch (D) {
#define CELESTE_SWEEP_CASE(DD) \
  case DD:                     \
    return sweep_attrs<T, DD>(out);
    CELESTE_SWEEP_DIMS(CELESTE_SWEEP_CASE)
#undef CELESTE_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int celeste_jacobi_sweep_f32(const void* A, const void* Q,
                                        void* Ao, void* Qo, int B, int D,
                                        void* stream) {
  return dispatch_sweep<float>(A, Q, Ao, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_f64(const void* A, const void* Q,
                                        void* Ao, void* Qo, int B, int D,
                                        void* stream) {
  return dispatch_sweep<double>(A, Q, Ao, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_attrs_f32(int D, int* out) {
  return dispatch_attrs<float>(D, out);
}

extern "C" int celeste_jacobi_sweep_attrs_f64(int D, int* out) {
  return dispatch_attrs<double>(D, out);
}
