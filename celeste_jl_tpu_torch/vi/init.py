"""Variational-parameter initialization (the port's copy of
celeste_jl_tpu/vi/init.generic_init_source, DeterministicVI.jl:39-103)."""

import numpy as np

from ..models.params import NUM_CANONICAL_PARAMS, ids


def generic_init_source(init_pos):
    vp = np.zeros(NUM_CANONICAL_PARAMS)
    vp[ids.is_star] = 0.5
    vp[ids.pos] = np.asarray(init_pos, dtype=np.float64)
    vp[ids.flux_loc] = np.log(2.0)
    vp[ids.flux_scale] = 1e-3
    vp[ids.gal_frac_dev] = 0.5
    vp[ids.gal_axis_ratio] = 0.5
    vp[ids.gal_angle] = 0.0
    vp[ids.gal_radius_px] = 1.0
    vp[ids.k] = 1.0 / 8.0
    vp[ids.color_mean] = 0.0
    vp[ids.color_var] = 1e-2
    return vp
