// One cyclic parallel-Jacobi sweep in two launches, one thread block per
// matrix in each.
//
// Replaces celeste_jl_tpu/ops/pallas_eigh.py::_sweep_a_kernel (K2a) and
// ::_sweep_q_kernel (K2b), the split sweep the JAX package runs when
// CELESTE_EIGH_FUSED=0. K2a rotates A through the D-1 rounds, exactly as
// csrc/jacobi_sweep.cu does (same rotation formula, same circle-method
// permutation, same expression order), and writes each round's (c, s) to
// a (B, D-1, 2, K) log in device memory; K2b loads the log and replays
// the column rotations and permutations on Q. Same expressions as
// ops/eigh.jacobi_sweep_a_plain and jacobi_replay_q_plain, so in f64 the
// split and fused sweeps agree to rounding.
//
// What bounds it on the card: as for the fused sweep, the chain of D-1
// dependent rounds behind block barriers, not bytes or flops; the split
// adds the log (2 K (D-1) values per matrix, written once and read once)
// and a second launch. K2a keeps A, its scratch copy and the round's
// (c, s) in shared memory (2 D^2 values: 14 KB in f32 at D = 42); K2b
// keeps Q, its ping-pong copy and the whole log there (2 D^2 + D (D-1)
// values). Even D, 4 <= D <= 64.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// Row or column `i` of a rotated pair: c x_i - s x_{i+1} at an even
// position, c x_i + s x_{i-1} at an odd one.
template <typename T>
__device__ __forceinline__ T rotated(T own, T other, T c, T s, int i) {
  return (i & 1) ? c * own + s * other : c * own + (-s) * other;
}

// perm = interleave(ev, od): ev = [0, 1, 2, 4, ..., 2(K-2)],
// od = [3, 5, ..., 2K-1, 2(K-1)] (ops/jacobi._round_robin_perm)
__device__ __forceinline__ void fill_perm(int* perm, int D) {
  const int K = D / 2;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const int k = j >> 1;
    if ((j & 1) == 0) perm[j] = k < 2 ? k : 2 * (k - 1);
    else perm[j] = k < K - 1 ? 2 * k + 3 : 2 * (K - 1);
  }
}

// K2a: A through the D-1 rounds; cs_log[b][r] = (c[0..K), s[0..K)).
template <typename T>
__global__ void sweep_a_kernel(const T* __restrict__ A, T* __restrict__ Ao,
                               T* __restrict__ cs_log, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * D, K = D / 2;
  T* a = reinterpret_cast<T*>(smem);
  T* tmp = a + n;
  T* cs = tmp + n;                         // c[K], then s[K]
  int* perm = reinterpret_cast<int*>(cs + 2 * K);

  const size_t base = (size_t)blockIdx.x * n;
  T* out_log = cs_log + (size_t)blockIdx.x * (D - 1) * 2 * K;
  for (int e = threadIdx.x; e < n; e += blockDim.x) a[e] = A[base + e];
  fill_perm(perm, D);
  __syncthreads();

  for (int r = 0; r < D - 1; ++r) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const T app = a[(2 * k) * D + 2 * k];
      const T aqq = a[(2 * k + 1) * D + 2 * k + 1];
      const T apq = a[(2 * k) * D + 2 * k + 1];
      const bool live = abs_t(apq) > T(1e-30);
      const T tau = (aqq - app) / (T(2) * (live ? apq : T(1)));
      const T sgn = tau >= T(0) ? T(1) : T(-1);
      T t = sgn / (abs_t(tau) + sqrt_t(T(1) + tau * tau));
      t = live ? t : T(0);
      const T c = T(1) / sqrt_t(T(1) + t * t);
      cs[k] = c;
      cs[K + k] = t * c;
      out_log[(size_t)r * 2 * K + k] = c;
      out_log[(size_t)r * 2 * K + K + k] = t * c;
    }
    __syncthreads();

    // rows of A into tmp
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      const int ki = i >> 1;
      const int io = (i & 1) ? i - 1 : i + 1;
      tmp[e] = rotated(a[e], a[io * D + j], cs[ki], cs[K + ki], i);
    }
    __syncthreads();

    // columns of tmp, then the permutation of rows and columns, into A
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      const int pi = perm[i], pj = perm[j];
      const int kj = pj >> 1;
      const int jo = (pj & 1) ? pj - 1 : pj + 1;
      a[e] = rotated(tmp[pi * D + pj], tmp[pi * D + jo], cs[kj], cs[K + kj],
                     pj);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n; e += blockDim.x) Ao[base + e] = a[e];
}

// K2b: the logged column rotations and permutations replayed on Q.
template <typename T>
__global__ void replay_q_kernel(const T* __restrict__ Q,
                                const T* __restrict__ cs_log,
                                T* __restrict__ Qo, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * D, K = D / 2, nl = (D - 1) * 2 * K;
  T* q = reinterpret_cast<T*>(smem);
  T* q2 = q + n;
  T* cs = q2 + n;                          // the whole log
  int* perm = reinterpret_cast<int*>(cs + nl);

  const size_t base = (size_t)blockIdx.x * n;
  const T* in_log = cs_log + (size_t)blockIdx.x * nl;
  for (int e = threadIdx.x; e < n; e += blockDim.x) q[e] = Q[base + e];
  for (int e = threadIdx.x; e < nl; e += blockDim.x) cs[e] = in_log[e];
  fill_perm(perm, D);
  __syncthreads();

  for (int r = 0; r < D - 1; ++r) {
    const T* c = cs + (size_t)r * 2 * K;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      const int pj = perm[j];
      const int kj = pj >> 1;
      const int jo = (pj & 1) ? pj - 1 : pj + 1;
      q2[e] = rotated(q[i * D + pj], q[i * D + jo], c[kj], c[K + kj], pj);
    }
    T* sw = q;
    q = q2;
    q2 = sw;
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n; e += blockDim.x) Qo[base + e] = q[e];
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_a(const void* A, void* Ao, void* cs, int B, int D, void* stream) {
  const int K = D / 2;
  const size_t smem = 2 * (size_t)D * D * sizeof(T) + 2 * K * sizeof(T) +
                      D * sizeof(int);
  const int err = set_smem(sweep_a_kernel<T>, smem);
  if (err) return err;
  sweep_a_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (T*)Ao, (T*)cs, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_q(const void* Q, const void* cs, void* Qo, int B, int D,
             void* stream) {
  const size_t smem = 2 * (size_t)D * D * sizeof(T) +
                      (size_t)(D - 1) * D * sizeof(T) + D * sizeof(int);
  const int err = set_smem(replay_q_kernel<T>, smem);
  if (err) return err;
  replay_q_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)Q, (const T*)cs, (T*)Qo, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int celeste_jacobi_sweep_a_f32(const void* A, void* Ao, void* cs,
                                          int B, int D, void* stream) {
  return launch_a<float>(A, Ao, cs, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_a_f64(const void* A, void* Ao, void* cs,
                                          int B, int D, void* stream) {
  return launch_a<double>(A, Ao, cs, B, D, stream);
}

extern "C" int celeste_jacobi_replay_q_f32(const void* Q, const void* cs,
                                           void* Qo, int B, int D,
                                           void* stream) {
  return launch_q<float>(Q, cs, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_replay_q_f64(const void* Q, const void* cs,
                                           void* Qo, int B, int D,
                                           void* stream) {
  return launch_q<double>(Q, cs, Qo, B, D, stream);
}
