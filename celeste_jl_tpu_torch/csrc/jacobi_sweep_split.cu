// One cyclic parallel-Jacobi sweep in two launches: K2a rotates A through
// the D-1 rounds and logs each round's (c, s); K2b replays the log on Q.
//
// Replaces celeste_jl_tpu/ops/pallas_eigh.py::_sweep_a_kernel (K2a) and
// ::_sweep_q_kernel (K2b), the split sweep the JAX package runs when
// CELESTE_EIGH_FUSED=0. Same formulas as ops/eigh.jacobi_sweep_a_plain and
// jacobi_replay_q_plain, with the arithmetic of jacobi_round.cuh, so K2a
// followed by K2b gives the bits of the fused sweep K2 (jacobi_sweep.cu).
// The log is (B, D-1, 2, D/2): log[b][r][0][k] = c and log[b][r][1][k] = s
// of round r's pair k.
//
// K2a is jacobi_sweep.cuh's round engine without Q and with the log (one
// block a matrix, one barrier a round; warp 0, which computes the next
// round's (c, s), also stores them to the log). What bounds it is the
// engine's chain of D-1 rounds, as for K2. 2 D^2 + 2 D values of shared
// memory (14 KB in f32 at D = 42).
//
// K2b: Q's column rotations never mix rows, so each row of Q replays the
// log on its own. What bounds it is bytes (Q and the log in, Q out) and the
// launch: ~3.4k flops a row at D = 42, no dependency between rows. The
// design, with D a template parameter:
// - a thread a row, its row of Q in registers, by the circle method's
//   labels (as K2 holds Q): label 0 stays put and labels 1..D-1 step down
//   by one a round, so a round pairs the same places of a round-relative
//   layout every round, and each result goes one place up into a second
//   register array, the next round's layout (replay_round). The
//   permutation is a renaming, not a data move: a loop over two rounds at
//   a time, the two arrays swapping roles, does (D-1) D/2 rotations on
//   registers with every index a constant, no index arithmetic and no
//   barrier, in a body of two rounds' code (fully unrolled over the D-1
//   rounds instead, the instances took minutes to build and ran no
//   faster). After D-1 rounds the labels are back where they started.
// - M = 128 / D matrices a block, their rows on consecutive threads (a warp
//   spans at most two matrices at D >= 32). Q and the log cross device
//   memory once, through shared memory, in coalesced vector loads and
//   stores; the log is staged as (c, s) pairs, each round's row padded to a
//   whole 16-byte load, so the threads of a matrix read each round's pairs
//   as broadcasts, two pairs a load in f32. One barrier before the replay
//   and one after.
// - a thread reads and writes only its own row of the staged Q, so the row
//   goes back to where it came from without a barrier between the replay
//   and the write-back.
// Even D in [4, 64] (CELESTE_SWEEP_DIMS), any other D is refused.

#include "jacobi_sweep.cuh"

namespace {

// What one shared-memory load of the staged log brings: two (c, s) pairs
// in f32, one in f64.
template <typename T>
struct CsLoad;
template <>
struct CsLoad<float> {
  using type = float4;
  static constexpr int kPairs = 2;
  static __device__ __forceinline__ void get(const float4& v, int u,
                                             float& c, float& s) {
    c = u ? v.z : v.x;
    s = u ? v.w : v.y;
  }
};
template <>
struct CsLoad<double> {
  using type = double2;
  static constexpr int kPairs = 1;
  static __device__ __forceinline__ void get(const double2& v, int,
                                             double& c, double& s) {
    c = v.x;
    s = v.y;
  }
};

// K2b's compile-time shape.
template <typename T, int D>
struct Replay {
  static constexpr int K = D / 2, L = D - 1;
  static constexpr int M = 128 / D;  // matrices a block
  static constexpr int kThreads = (M * D + 31) / 32 * 32;
  // values of a round's (c, s) pairs in shared memory, padded to a load
  static constexpr int kStride =
      (2 * K + 2 * CsLoad<T>::kPairs - 1) / (2 * CsLoad<T>::kPairs) *
      (2 * CsLoad<T>::kPairs);
  static constexpr int kQ = M * D * D;      // Q's values a block
  static constexpr int kLog = M * L * kStride;  // the staged log's
  static constexpr size_t kSmem = (size_t)(kQ + kLog) * sizeof(T);
};

// One round of a row of Q. Label 0 (q0) never moves; labels 1..L are held
// round-relative: in round r, u[i] is label 1 + (i - r) mod L, so round r's
// pair 0 is (q0, u[L-1]) and its pair k > 0 is (u[k-1], u[L-1-k]) in every
// round, and round r + 1's u[i] is round r's result at i - 1 (mod L): each
// rotated entry goes one place up into v, the next round's layout.
template <typename T, int D>
__device__ __forceinline__ void replay_round(
    T& q0, const T (&u)[D - 1], T (&v)[D - 1],
    const typename CsLoad<T>::type* __restrict__ cs) {
  constexpr int K = D / 2, L = D - 1, kPairs = CsLoad<T>::kPairs;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += kPairs) {
    const typename CsLoad<T>::type w = cs[k0 / kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int k = k0 + j;
      if (k < K) {
        T c, s;
        CsLoad<T>::get(w, j, c, s);
        const T x = k == 0 ? q0 : u[k - 1], y = u[L - 1 - k];
        const T xn = rot(x, y, c, -s);
        if (k == 0) {
          q0 = xn;
        } else {
          v[k] = xn;
        }
        v[L - k == L ? 0 : L - k] = rot(y, x, c, s);
      }
    }
  }
}

// K2b: the logged column rotations and permutations replayed on Q.
template <typename T, int D>
__global__ void __launch_bounds__(Replay<T, D>::kThreads)
    replay_q_kernel(const T* __restrict__ Q, const T* __restrict__ cs_log,
                    T* __restrict__ Qo, int B) {
  using R = Replay<T, D>;
  using P = typename Pair<T>::type;
  using V = typename CsLoad<T>::type;
  using W = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  constexpr int K = R::K, L = R::L;
  constexpr int kW = sizeof(W) / sizeof(T);  // values a 16-byte vector
  constexpr int kRound = R::kStride / (2 * CsLoad<T>::kPairs);  // loads
  extern __shared__ __align__(16) unsigned char smem[];
  T* const qs = reinterpret_cast<T*>(smem);
  T* const ls = qs + R::kQ;

  const int b0 = blockIdx.x * R::M;
  const int nm = min(R::M, B - b0);
  const int tid = threadIdx.x;
  {  // Q as it is, 16 bytes a load (D^2 values a matrix: a whole number)
    const W* src = reinterpret_cast<const W*>(Q + (size_t)b0 * D * D);
    W* dst = reinterpret_cast<W*>(qs);
    for (int v = tid; v < nm * D * D / kW; v += R::kThreads) dst[v] = src[v];
  }
  {  // the log, 2 values a load (a matrix's log starts on a pair), each
     // value to its place in a (c, s) pair of its round's padded row
    const P* src = reinterpret_cast<const P*>(cs_log + (size_t)b0 * L * D);
    for (int v = tid; v < nm * L * K; v += R::kThreads) {
      const P x = src[v];
      const int row = v / K, e = 2 * (v - row * K);  // row = m L + r
      const int k0 = e % K, h0 = e / K;
      const int k1 = (e + 1) % K, h1 = (e + 1) / K;
      ls[row * R::kStride + 2 * k0 + h0] = x.x;
      ls[row * R::kStride + 2 * k1 + h1] = x.y;
    }
  }
  __syncthreads();

  if (tid < nm * D) {  // row tid % D of matrix b0 + tid / D
    T q0, u[L], v[L];
    P* const row = reinterpret_cast<P*>(qs + tid * D);
    // position j holds label label0(j): label 0 to q0, label l to u[l - 1]
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const P x = row[j];
      if (j == 0) {
        q0 = x.x;
      } else {
        u[label0<D>(2 * j) - 1] = x.x;
      }
      u[label0<D>(2 * j + 1) - 1] = x.y;
    }
    const V* cs = reinterpret_cast<const V*>(ls + (tid / D) * L * R::kStride);
#pragma unroll 1
    for (int r = 0; r + 1 < L; r += 2) {
      replay_round<T, D>(q0, u, v, cs);
      replay_round<T, D>(q0, v, u, cs + kRound);
      cs += 2 * kRound;
    }
    replay_round<T, D>(q0, u, v, cs);  // round L - 1 (L is odd)
    // after L rounds v[i] is label 1 + i again
#pragma unroll
    for (int j = 0; j < K; ++j)
      row[j] = P{j == 0 ? q0 : v[label0<D>(2 * j) - 1],
                 v[label0<D>(2 * j + 1) - 1]};
  }
  __syncthreads();
  {
    const W* src = reinterpret_cast<const W*>(qs);
    W* dst = reinterpret_cast<W*>(Qo + (size_t)b0 * D * D);
    for (int v = tid; v < nm * D * D / kW; v += R::kThreads) dst[v] = src[v];
  }
}

template <typename T, int D>
int launch_replay(const void* Q, const void* cs, void* Qo, int B,
                  void* stream) {
  using R = Replay<T, D>;
  if (R::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        replay_q_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)R::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  replay_q_kernel<T, D><<<(B + R::M - 1) / R::M, R::kThreads, R::kSmem,
                          (cudaStream_t)stream>>>(
      (const T*)Q, (const T*)cs, (T*)Qo, B);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_a(const void* A, void* Ao, void* cs, int B, int D,
               void* stream) {
  return with_sweep_dim(D, [&](auto d) {
    return launch_sweep<T, decltype(d)::value, false, true>(
        A, nullptr, Ao, nullptr, cs, B, stream);
  });
}

template <typename T>
int dispatch_q(const void* Q, const void* cs, void* Qo, int B, int D,
               void* stream) {
  return with_sweep_dim(D, [&](auto d) {
    return launch_replay<T, decltype(d)::value>(Q, cs, Qo, B, stream);
  });
}

template <typename T>
int attrs_a(int D, int* out) {
  return with_sweep_dim(D, [&](auto d) {
    return sweep_attrs<T, decltype(d)::value, false, true>(out);
  });
}

template <typename T>
int attrs_q(int D, int* out) {
  return with_sweep_dim(D, [&](auto d) {
    using R = Replay<T, decltype(d)::value>;
    return kernel_attrs(replay_q_kernel<T, decltype(d)::value>, R::kThreads,
                        R::kSmem, out);
  });
}

}  // namespace

extern "C" int celeste_jacobi_sweep_a_f32(const void* A, void* Ao, void* cs,
                                          int B, int D, void* stream) {
  return dispatch_a<float>(A, Ao, cs, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_a_f64(const void* A, void* Ao, void* cs,
                                          int B, int D, void* stream) {
  return dispatch_a<double>(A, Ao, cs, B, D, stream);
}

extern "C" int celeste_jacobi_replay_q_f32(const void* Q, const void* cs,
                                           void* Qo, int B, int D,
                                           void* stream) {
  return dispatch_q<float>(Q, cs, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_replay_q_f64(const void* Q, const void* cs,
                                           void* Qo, int B, int D,
                                           void* stream) {
  return dispatch_q<double>(Q, cs, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_a_attrs_f32(int D, int* out) {
  return attrs_a<float>(D, out);
}

extern "C" int celeste_jacobi_sweep_a_attrs_f64(int D, int* out) {
  return attrs_a<double>(D, out);
}

extern "C" int celeste_jacobi_replay_q_attrs_f32(int D, int* out) {
  return attrs_q<float>(D, out);
}

extern "C" int celeste_jacobi_replay_q_attrs_f64(int D, int* out) {
  return attrs_q<double>(D, out);
}
