// One cyclic parallel-Jacobi sweep of a batch of symmetric D x D matrices,
// A and Q together, one thread block per matrix (K2).
//
// Replaces celeste_jl_tpu/ops/pallas_eigh.py::_sweep_aq_kernel (the fused
// A+Q sweep the TPU runs VMEM-resident on 128-lane blocks). The kernel is
// jacobi_sweep.cuh's round engine with Q and without the (c, s) log: its
// design and what bounds it are described there. The split sweep's A
// phase (K2a, jacobi_sweep_split.cu) is the same engine without Q and with
// the log, so the two routes give the same bits.

#include "jacobi_sweep.cuh"

namespace {

template <typename T>
int dispatch_sweep(const void* A, const void* Q, void* Ao, void* Qo, int B,
                   int D, void* stream) {
  return with_sweep_dim(D, [&](auto d) {
    return launch_sweep<T, decltype(d)::value, true, false>(
        A, Q, Ao, Qo, nullptr, B, stream);
  });
}

template <typename T>
int dispatch_attrs(int D, int* out) {
  return with_sweep_dim(D, [&](auto d) {
    return sweep_attrs<T, decltype(d)::value, true, false>(out);
  });
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
