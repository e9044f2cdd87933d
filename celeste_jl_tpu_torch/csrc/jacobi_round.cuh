// The arithmetic of one parallel-Jacobi round, shared by the fused sweep
// (jacobi_sweep.cu) and the split pair (jacobi_sweep_split.cu), so that the
// two give the same bits: one pair's rotation (c, s) and the rotation of
// one entry of a pair of rows or columns. Every product that feeds a sum
// is written as an explicit fma or multiply, so the compiler has no
// contraction left to choose and an entry computed twice in a kernel (the
// fused sweep recomputes the next round's diagonal) has the same bits both
// times. Same formulas as ops/eigh._round_cs and _rotate_pairs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// One entry of a rotated pair: c x_own + sgn_s x_other, with sgn_s = -s at
// the pair's even position and +s at its odd one.
template <typename T>
__device__ __forceinline__ T rot(T own, T other, T c, T sgn_s) {
  return fma_t(c, own, sgn_s * other);
}

// The rotation of a pair from its 2x2 block (app, aqq, apq): zero angle
// where |apq| <= 1e-30.
template <typename T>
__device__ __forceinline__ void round_cs(T app, T aqq, T apq, T& c, T& s) {
  const bool live = abs_t(apq) > T(1e-30);
  const T tau = (aqq - app) / (T(2) * (live ? apq : T(1)));
  const T sgn = tau >= T(0) ? T(1) : T(-1);
  T t = sgn / (abs_t(tau) + sqrt_t(fma_t(tau, tau, T(1))));
  t = live ? t : T(0);
  c = T(1) / sqrt_t(fma_t(t, t, T(1)));
  s = t * c;
}
