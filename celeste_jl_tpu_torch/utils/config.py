"""Inference configuration (the port's copy of
celeste_jl_tpu/utils/config.Config, config.jl:2-25). The JAX package's
XLA compile-cache helpers are not carried over: torch has no compile
cache to key."""

from dataclasses import dataclass


@dataclass
class Config:
    # patches must be at least this many pixels in radius
    min_radius_pix: float = 8.0
    # number of temperatures in the annealed importance sampling ladder
    num_ais_temperatures: int = 50
    # number of AIS importance samples
    num_ais_samples: int = 10
    # outer iterations (warm sweeps) of joint variational inference
    num_joint_vi_iters: int = 3
    # Hessian-refresh budget per joint class-step: a batched class-step
    # runs every lane until the slowest converges, so the cap bounds what a
    # never-converging lane burns per step; a truncated lane resumes next
    # sweep from its current vp
    joint_step_refreshes: int = 15
    # the same budget for the polish sweeps after the probe; 0 = full
    polish_refreshes: int = 15
    # Gauss-Seidel polish sweeps after the probe (2 re-equilibrates a
    # probe's basin flip on a 3-source blend, where 1 does not)
    polish_sweeps: int = 2
    # Hessian-refresh budget of the fresh-init keep-better probe; 0 = full
    probe_refreshes: int = 25
