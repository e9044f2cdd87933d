// Checks of ../ieee_fast.cuh against IEEE division (`/`) on the card, for
// tests/test_torch_kernels.py; built apart from the kernel library
// (ops/_build.build with these sources).
//
// celeste_ieee_fast_check: per pair, mode 0 writes div_rn_fast(a, b) and
// a / b, mode 1 div_rn(a, b) and a / b.
// celeste_ieee_fast_rcp_scaling: rcp.approx.ftz of +-m 2^k against +-rcp(m)
// 2^-k, bit for bit, for every significand m and every k in [-60, 60].
// celeste_ieee_fast_exhaustive: div_rn_fast(a, b) against a / b, bit for
// bit, for every a in [1, 2) and every b in [1, 2) whose significand's low
// 23 bits lie in [b_first, b_first + nb).
// The last two count mismatches into out[0] and leave one mismatching pair
// (float bits) in out[1], out[2].

#include <cuda_runtime.h>

#include "../ieee_fast.cuh"

namespace {

constexpr int kSig = 1 << 23;  // significands of one binade

__device__ __forceinline__ float rcp_approx(float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}

__device__ __forceinline__ void report(unsigned long long* out,
                                       unsigned long long bad, unsigned a,
                                       unsigned b) {
  if (!bad) return;
  atomicAdd(out, bad);
  out[1] = a;
  out[2] = b;
}

__global__ void check_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ fast,
                             float* __restrict__ ieee, int n, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fast[i] = mode ? div_rn(a[i], b[i]) : div_rn_fast(a[i], b[i]);
  ieee[i] = a[i] / b[i];
}

// one thread per significand, all exponents and both signs
__global__ void rcp_scaling_kernel(unsigned long long* out) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= kSig) return;
  const unsigned r1 =
      __float_as_uint(rcp_approx(__uint_as_float(0x3f800000u | m)));
  unsigned long long bad = 0;
  unsigned bad_b = 0;
  for (int k = -60; k <= 60; ++k) {
    const unsigned b = ((unsigned)(127 + k) << 23) | m;
    const unsigned want = r1 - ((unsigned)k << 23);  // exponent - k
    for (unsigned s = 0; s < 2; ++s) {
      const unsigned sign = s << 31;
      if (__float_as_uint(rcp_approx(__uint_as_float(b | sign))) !=
          (want | sign)) {
        ++bad;
        bad_b = b | sign;
      }
    }
  }
  report(out, bad, 0, bad_b);
}

// blockIdx.x picks b; the threads of its gridDim.y blocks stride over
// every a
__global__ void exhaustive_kernel(int b_first, unsigned long long* out) {
  const float b = __uint_as_float(0x3f800000u | (b_first + blockIdx.x));
  unsigned long long bad = 0;
  unsigned bad_a = 0;
  for (unsigned m = blockIdx.y * blockDim.x + threadIdx.x; m < kSig;
       m += gridDim.y * blockDim.x) {
    const float a = __uint_as_float(0x3f800000u | m);
    if (__float_as_uint(div_rn_fast(a, b)) != __float_as_uint(a / b)) {
      ++bad;
      bad_a = __float_as_uint(a);
    }
  }
  report(out, bad, bad_a, __float_as_uint(b));
}

}  // namespace

extern "C" int celeste_ieee_fast_check(const void* a, const void* b,
                                       void* fast, void* ieee, int n,
                                       int mode, void* stream) {
  check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)fast, (float*)ieee, n, mode);
  return (int)cudaGetLastError();
}

extern "C" int celeste_ieee_fast_rcp_scaling(void* out, void* stream) {
  rcp_scaling_kernel<<<kSig / 256, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int celeste_ieee_fast_exhaustive(int b_first, int nb, void* out,
                                            void* stream) {
  if (b_first < 0 || nb < 1 || nb > kSig - b_first)
    return (int)cudaErrorInvalidValue;
  exhaustive_kernel<<<dim3(nb, 32), 256, 0, (cudaStream_t)stream>>>(
      b_first, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
