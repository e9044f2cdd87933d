"""Inference configuration (the fields of celeste_jl_tpu/utils/config.Config
that the port's paths read; config.jl:2-25)."""

from dataclasses import dataclass


@dataclass
class Config:
    # patches must be at least this many pixels in radius
    min_radius_pix: float = 8.0
    # number of temperatures in the annealed importance sampling ladder
    num_ais_temperatures: int = 50
    # number of AIS importance samples
    num_ais_samples: int = 10
