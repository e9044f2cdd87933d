"""Variational-parameter initialization (the port's copy of
celeste_jl_tpu/vi/init.py, DeterministicVI.jl:39-103)."""

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


def _get_color(flux_hi, flux_lo):
    if flux_hi > 0 and flux_lo > 0:
        return min(max(np.log(flux_hi / flux_lo), -9.0), 9.0)
    if flux_hi > 0:
        return 3.0
    if flux_lo > 0:
        return -3.0
    return 0.0


def _get_colors(fluxes):
    return np.array([_get_color(fluxes[c + 1], fluxes[c]) for c in range(4)])


def catalog_init_source(ce, max_gal_radius_px=np.inf):
    vp = generic_init_source(ce.pos)
    vp[ids.is_star[0]] = 0.8 if ce.is_star else 0.2
    vp[ids.is_star[1]] = 0.2 if ce.is_star else 0.8
    vp[ids.flux_loc[0]] = np.log(max(0.1, ce.star_fluxes[2]))
    vp[ids.flux_loc[1]] = np.log(max(0.1, ce.gal_fluxes[2]))
    vp[ids.color_mean[:, 0]] = _get_colors(ce.star_fluxes)
    vp[ids.color_mean[:, 1]] = _get_colors(ce.gal_fluxes)
    vp[ids.gal_frac_dev] = min(max(ce.gal_frac_dev, 0.015), 0.985)
    vp[ids.gal_axis_ratio] = (0.8 if ce.is_star
                              else min(max(ce.gal_axis_ratio, 0.015), 0.985))
    vp[ids.gal_angle] = ce.gal_angle
    vp[ids.gal_radius_px] = (0.2 if ce.is_star
                             else min(max_gal_radius_px,
                                      max(ce.gal_radius_px, 0.2)))
    return vp


def init_sources(target_indices, catalog):
    """Initialize all sources from the catalog; re-initialize optimization
    targets generically (DeterministicVI.jl:94-103)."""
    vps = [catalog_init_source(ce) for ce in catalog]
    for s in target_indices:
        vps[s] = generic_init_source(catalog[s].pos)
    return np.stack(vps)
