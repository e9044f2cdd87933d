"""Unit-flux light densities fs0m (star) and fs1m (galaxy) on patch tiles
(port of celeste_jl_tpu/models/fsm.py). Functions broadcast over leading
(source, band) axes."""

import functools

import torch

from .bvn import eval_bvn_mixture_grid, get_bvn_cov
from .params import GAL_ETA, GAL_IS_DEV, GAL_NU
from .patches import pixel_coord_grids
from .psf import psf_alphas, psf_covs, psf_mus


def galaxy_prototypes(like):
    """(eta, nu, is_dev) of the 14 galaxy profile components as tensors of
    `like`'s dtype and device."""
    return _prototypes(like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _prototypes(dtype, device):
    # constant: copied to the device once, not on every render
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(GAL_ETA, **kw), torch.as_tensor(GAL_NU, **kw),
            torch.as_tensor(GAL_IS_DEV, **kw))


def linear_world_to_pix(wcs_jacobian, world_center, pixel_center, world_pos):
    """pixel = pixel_center + J (world - world_center), (..., 2)
    (model/wcs_utils.jl:14-18)."""
    return pixel_center + torch.einsum(
        "...ij,...j->...i", wcs_jacobian, world_pos - world_center)


def star_density_grid(pos_world, psf, wcs_jacobian, world_center,
                      pixel_center, offset, P):
    """Unit-flux star density: the PSF mixture at the source position,
    (..., P, P)."""
    m_pos = linear_world_to_pix(wcs_jacobian, world_center, pixel_center,
                                pos_world)
    x1, x2 = pixel_coord_grids(offset, P, dtype=psf.dtype)
    means = psf_mus(psf) + m_pos[..., None, :]
    return eval_bvn_mixture_grid(x1, x2, means, psf_covs(psf),
                                 psf_alphas(psf))


def galaxy_density_grid(pos_world, gal_frac_dev, gal_axis_ratio, gal_angle,
                        gal_radius_px, psf, wcs_jacobian, world_center,
                        pixel_center, offset, P):
    """Unit-flux galaxy density, (..., P, P): the 14-component profile
    (8 de Vaucouleurs + 6 exponential) convolved with each PSF component,
    covariances psf_cov + nu * XiXi, weights alpha * eta * frac."""
    m_pos = linear_world_to_pix(wcs_jacobian, world_center, pixel_center,
                                pos_world)
    x1, x2 = pixel_coord_grids(offset, P, dtype=psf.dtype)

    XiXi = get_bvn_cov(gal_axis_ratio, gal_angle, gal_radius_px)  # (...,2,2)
    eta, nu, is_dev = galaxy_prototypes(psf)
    fd = gal_frac_dev[..., None]
    frac = is_dev * fd + (1.0 - is_dev) * (1.0 - fd)               # (..., 14)

    a = psf_alphas(psf)                    # (..., K)
    mu = psf_mus(psf)                      # (..., K, 2)
    cv = psf_covs(psf)                     # (..., K, 2, 2)
    K, n_gal = mu.shape[-2], eta.shape[0]
    lead = mu.shape[:-2]

    weights = (a[..., :, None] * (eta * frac)[..., None, :]).reshape(
        lead + (K * n_gal,))
    covs = (cv[..., :, None, :, :]
            + nu[:, None, None] * XiXi[..., None, None, :, :]).reshape(
        lead + (K * n_gal, 2, 2))
    means = ((mu + m_pos[..., None, :])[..., :, None, :]
             .expand(lead + (K, n_gal, 2)).reshape(lead + (K * n_gal, 2)))
    return eval_bvn_mixture_grid(x1, x2, means, covs, weights)


def source_densities_all_bands(pos_world, gal_frac_dev, gal_axis_ratio,
                               gal_angle, gal_radius_px, patch):
    """fs0m, fs1m of every source on every band, each (S, B, P, P).

    pos_world (S, 2) and the shape parameters (S,) broadcast over the band
    axis of the stacked patch."""
    P = tuple(patch.pixels.shape[-2:])
    args = (patch.psf, patch.wcs_jacobian, patch.world_center,
            patch.pixel_center, patch.offset, P)
    pos = pos_world[:, None, :]
    fs0m = star_density_grid(pos, *args)
    fs1m = galaxy_density_grid(pos, gal_frac_dev[:, None],
                               gal_axis_ratio[:, None], gal_angle[:, None],
                               gal_radius_px[:, None], *args)
    return fs0m, fs1m
