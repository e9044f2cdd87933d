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
// position perm[j]. Same expressions as ops/eigh.jacobi_sweep_plain.
//
// What bounds it on the card: each round is ~5 D^2 flops on 4 D^2 values
// behind three block barriers, so a sweep is latency-bound on the barrier
// chain; device memory sees A and Q once per sweep. The design keeps A,
// Q and their scratch copies in shared memory (4 D^2 values: 28 KB in f32
// at D = 42) for the whole sweep, folds the column rotation of A into its
// permutation (one pass writes A[i][j] = rot(T)[perm[i]][perm[j]]), and
// ping-pongs Q between two buffers, so a round is two passes over A and
// one over Q. Even D, 4 <= D <= 64.

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

template <typename T>
__global__ void sweep_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                             T* __restrict__ Ao, T* __restrict__ Qo, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * D, K = D / 2;
  T* a = reinterpret_cast<T*>(smem);
  T* tmp = a + n;
  T* q = tmp + n;
  T* q2 = q + n;
  T* cs = q2 + n;                          // c[K], then s[K]
  int* perm = reinterpret_cast<int*>(cs + 2 * K);

  const size_t base = (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    a[e] = A[base + e];
    q[e] = Q[base + e];
  }
  // perm = interleave(ev, od): ev = [0, 1, 2, 4, ..., 2(K-2)],
  // od = [3, 5, ..., 2K-1, 2(K-1)]
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const int k = j >> 1;
    if ((j & 1) == 0) perm[j] = k < 2 ? k : 2 * (k - 1);
    else perm[j] = k < K - 1 ? 2 * k + 3 : 2 * (K - 1);
  }
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
    }
    __syncthreads();

    // rows of A into tmp; columns + permutation of Q into q2
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / D, j = e - (e / D) * D;
      const int ki = i >> 1;
      const int io = (i & 1) ? i - 1 : i + 1;
      tmp[e] = rotated(a[e], a[io * D + j], cs[ki], cs[K + ki], i);
      const int pj = perm[j];
      const int kj = pj >> 1;
      const int jo = (pj & 1) ? pj - 1 : pj + 1;
      q2[e] = rotated(q[i * D + pj], q[i * D + jo], cs[kj], cs[K + kj], pj);
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
    T* sw = q;
    q = q2;
    q2 = sw;
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    Ao[base + e] = a[e];
    Qo[base + e] = q[e];
  }
}

template <typename T>
int launch_sweep(const void* A, const void* Q, void* Ao, void* Qo, int B,
                 int D, void* stream) {
  const int K = D / 2;
  const size_t smem = 4 * (size_t)D * D * sizeof(T) + 2 * K * sizeof(T) +
                      D * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)Q, (T*)Ao, (T*)Qo, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int celeste_jacobi_sweep_f32(const void* A, const void* Q,
                                        void* Ao, void* Qo, int B, int D,
                                        void* stream) {
  return launch_sweep<float>(A, Q, Ao, Qo, B, D, stream);
}

extern "C" int celeste_jacobi_sweep_f64(const void* A, const void* Q,
                                        void* Ao, void* Qo, int B, int D,
                                        void* stream) {
  return launch_sweep<double>(A, Q, Ao, Qo, B, D, stream);
}
