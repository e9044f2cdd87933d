"""PyTorch / CUDA port of celeste_jl_tpu for NVIDIA Hopper (sm_90a).

The JAX package `celeste_jl_tpu` stays the reference; this package mirrors
its layout (io/, models/, ops/, vi/, mcmc/, parallel/, utils/, main.py,
synthetic.py) so every counterpart is easy to find. It imports torch and
never jax, nor anything of `celeste_jl_tpu`: the numpy-only modules it
needs (io/, models/params.py, models/priors.py with data/priors.npz,
models/image.py, vi/init.py) are its own copies.

Slices ported so far: the batched source fit that bench.py times,
`vi.optimize.fit_sources_compacted` with the pjacobi trust-region solver;
MCMC/AIS, `mcmc.infer.run_ais_batched`; one sky box,
`parallel.run.infer_box`, its joint schedule fused by default
(parallel/fused.py); several boxes as one schedule,
`parallel.run.joint_infer_fields` (`python -m
celeste_jl_tpu_torch.benchmark.multifield`); and the survey app,
`python -m celeste_jl_tpu_torch` (main.py: SDSS FITS files in, PSF fits,
inference, a saved catalog out), through hand-written CUDA kernels
(csrc/):
  refresh.cu        the analytic-Hessian refresh pixel pass (ops/refresh.py)
  jacobi_sweep.cu   one parallel-Jacobi eigensolver sweep (ops/eigh.py)
  jacobi_sweep_split.cu  the same sweep in two launches, A rounds with a
                    (c, s) log, then its replay on Q (ops/eigh.py)
  tr_subproblem.cu  the trust-region subproblem in the eigenbasis (ops/tr.py)
  render.cu         the mixture render + Poisson log-likelihood of the MCMC
                    densities (ops/render.py)

Every kernel has a plain PyTorch twin beside it. A wrapper runs the twin
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Batched functions take the lane axis S (or the S*B row axis) explicitly,
and tensors arrive on a device the caller chose.
"""

import torch

# The JAX reference runs its Newton-Schulz and re-formation products at
# Precision.HIGHEST; their f32 ports must never run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
