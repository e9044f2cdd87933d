"""Canonical variational-parameter layout (the port's copy of
celeste_jl_tpu/models/params.py, numpy only).

The 44-dim per-source variational parameter vector ("vp"), 0-based.
Semantics follow the reference model (Celeste.jl src/model/param_set.jl:76-107),
re-expressed as flat numpy index arrays for tensor gather/scatter.

Parameter meanings:
  pos            world coordinates (RA, Dec) — point estimate
  gal_frac_dev   weight of the de Vaucouleurs profile in the galaxy mixture
  gal_axis_ratio minor/major axis ratio in (0, 1]
  gal_angle      angle in radians north of east
  gal_radius_px  galaxy scale (major-axis sigma, px)
  flux_loc       [star, gal] lognormal location of reference-band (r) flux, nMgy
  flux_scale     [star, gal] lognormal scale (variance param) of r-band flux
  color_mean     (4, 2) mean log flux ratios between adjacent bands
  color_var      (4, 2) variances of the log flux ratios
  is_star        [P(star), P(galaxy)] categorical
  k              (8, 2) color-prior GMM component responsibilities
"""

import numpy as np

NUM_BANDS = 5
NUM_SOURCE_TYPES = 2
NUM_COLOR_COMPONENTS = 8


class _Ids:
    """0-based index layout of the 44-dim canonical parameter vector."""

    pos = np.array([0, 1])
    gal_frac_dev = 2
    gal_axis_ratio = 3
    gal_angle = 4
    gal_radius_px = 5
    flux_loc = np.array([6, 7])        # [star, galaxy]
    flux_scale = np.array([8, 9])      # [star, galaxy]
    # color_mean[c, i]: color c in 0..3, source type i in 0..1
    color_mean = np.arange(10, 18).reshape(NUM_SOURCE_TYPES, NUM_BANDS - 1).T
    color_var = np.arange(18, 26).reshape(NUM_SOURCE_TYPES, NUM_BANDS - 1).T
    is_star = np.array([26, 27])       # [P(star), P(galaxy)]
    # k[d, i]: color component d in 0..7, source type i in 0..1
    k = np.arange(28, 44).reshape(NUM_SOURCE_TYPES, NUM_COLOR_COMPONENTS).T


ids = _Ids()
NUM_CANONICAL_PARAMS = 44


# Fixed galaxy profile prototypes: GMM approximations of the de Vaucouleurs
# (8 components) and exponential (6 components) radial profiles.
# Values are the standard Hogg & Lang profile fits, identical to the
# reference's (model/light_source_model.jl:45-72).
def _galaxy_prototypes():
    dev_amp = np.array([4.26347652e-2, 2.40127183e-1, 6.85907632e-1, 1.51937350,
                        2.83627243, 4.46467501, 5.72440830, 5.60989349])
    dev_amp /= dev_amp.sum()
    dev_var = np.array([2.23759216e-4, 1.00220099e-3, 4.18731126e-3, 1.69432589e-2,
                        6.84850479e-2, 2.87207080e-1, 1.33320254, 8.40215071])
    exp_amp = np.array([2.34853813e-3, 3.07995260e-2, 2.23364214e-1,
                        1.17949102, 4.33873750, 5.99820770])
    exp_amp /= exp_amp.sum()
    exp_var = np.array([1.20078965e-3, 8.84526493e-3, 3.91463084e-2,
                        1.39976817e-1, 4.60962500e-1, 1.50159566])
    effective_radii = [1.078031, 0.928896]
    dev_var = dev_var / effective_radii[0] ** 2
    exp_var = exp_var / effective_radii[1] ** 2
    return (dev_amp, dev_var), (exp_amp, exp_var)


(DEV_AMP, DEV_VAR), (EXP_AMP, EXP_VAR) = _galaxy_prototypes()

# Packed (14,) arrays: first 8 = de Vaucouleurs, last 6 = exponential.
# GAL_ETA = component weight, GAL_NU = component scale (multiplies the
# galaxy shape covariance), GAL_IS_DEV = 1 for dev components.
GAL_ETA = np.concatenate([DEV_AMP, EXP_AMP])
GAL_NU = np.concatenate([DEV_VAR, EXP_VAR])
GAL_IS_DEV = np.concatenate([np.ones(8), np.zeros(6)])
NUM_GAL_COMPONENTS = 14
