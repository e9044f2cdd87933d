"""The variational ELBO on fixed-shape patch tiles (port of
celeste_jl_tpu/vi/elbo.py, elbo_objective.jl:274-392 and elbo_kl.jl).

Per pixel (band b, count x, calibration iota, sky eps):
    E[G] = eps + sum_i a_i E[l_b|i] fs_i,   Var[G] from the second moments
    elbo += x (log iota + log E[G] - Var G / (2 E[G]^2)) - iota E[G]
            - lgamma(x + 1)
Functions take a leading source axis S and return per-source values; the
gradient of their sum over sources is the per-source gradient, because
sources are independent. This is the cheap (f, g) evaluator of the fit,
differentiated with torch.autograd.
"""

import functools
import math

import numpy as np
import torch

from ..models import priors as priors_mod
from ..models.brightness import brightness_moments
from ..models.fsm import source_densities_all_bands
from ..models.params import ids


def source_fs_grids(vp, patch):
    """fs0m, fs1m density grids of each source, (S, B, P, P)."""
    return source_densities_all_bands(vp[:, 0:2], vp[:, 2], vp[:, 3],
                                      vp[:, 4], vp[:, 5], patch)


def brightness_coeffs(vp):
    """The 20 brightness coefficients C = [a_i E[l_b|i], a_i E[l_b^2|i]]
    flattened, (..., 20); the pixel moments are linear in C."""
    E_l, E_ll = brightness_moments(vp)            # (..., 5, 2)
    a = vp[..., ids.is_star][..., None, :]        # (..., 1, 2)
    lead = vp.shape[:-1]
    return torch.cat([(a * E_l).reshape(lead + (10,)),
                      (a * E_ll).reshape(lead + (10,))], dim=-1)


def moment_grids_from_fs(C, fs0m, fs1m):
    """(E[G]_s, Var[G]_s) grids (S, B, P, P) from C (S, 20)."""
    S = C.shape[0]
    cl = C[:, :10].reshape(S, 5, 2)[..., None, None]    # (S, 5, 2, 1, 1)
    cll = C[:, 10:].reshape(S, 5, 2)[..., None, None]
    E_G_s = cl[:, :, 0] * fs0m + cl[:, :, 1] * fs1m
    E_G2_s = cll[:, :, 0] * fs0m ** 2 + cll[:, :, 1] * fs1m ** 2
    return E_G_s, E_G2_s - E_G_s ** 2


def source_moment_grids(vp, patch):
    """E[G]_s and Var[G]_s images of each source on its patch tiles, each
    (S, B, P, P), from vp (S, 44)."""
    fs0m, fs1m = source_fs_grids(vp, patch)
    return moment_grids_from_fs(brightness_coeffs(vp), fs0m, fs1m)


def pixel_log_likelihood(E_G_s, var_G_s, patch, bg_E_G=None, bg_var_G=None):
    """Masked Poisson-lower-bound log likelihood per source, (S,)."""
    E_G = patch.sky + E_G_s
    var_G = var_G_s
    if bg_E_G is not None:
        E_G = E_G + bg_E_G
    if bg_var_G is not None:
        var_G = var_G + bg_var_G

    mask = patch.mask
    # Masked lanes are sanitized so no NaN reaches the backward pass.
    x = torch.where(mask, patch.pixels, 0.0)
    iota = torch.where(mask, patch.iota, 1.0)
    E_G = torch.where(mask, E_G, 1.0)
    var_G = torch.where(mask, var_G, 0.0)

    log_term = torch.log(E_G) - var_G / (2.0 * E_G ** 2)
    pix = x * (torch.log(iota) + log_term) - iota * E_G - torch.lgamma(x + 1.0)
    return torch.sum(torch.where(mask, pix, 0.0), dim=(-3, -2, -1))


def elbo_likelihood(vp, patch, bg_E_G=None, bg_var_G=None):
    """Expected log likelihood of each source's active pixels, (S,)."""
    E_G_s, var_G_s = source_moment_grids(vp, patch)
    return pixel_log_likelihood(E_G_s, var_G_s, patch, bg_E_G, bg_var_G)


# ---------------------------------------------------------------------------
# KL divergences (closed forms, elbo_kl.jl:25-154)
# ---------------------------------------------------------------------------

class PriorConstants:
    """Prior values as tensors on one device, with the inverses and
    log-determinants of the color GMM covariances precomputed."""

    def __init__(self, is_star, flux_mean, flux_var, k, color_mean,
                 color_cov_inv, color_cov_logdet, gal_radius_px_mean,
                 gal_radius_px_var):
        self.is_star = is_star                    # (2,)
        self.flux_mean = flux_mean                # (2,)
        self.flux_var = flux_var                  # (2,)
        self.k = k                                # (8, 2)
        self.color_mean = color_mean              # (4, 8, 2)
        self.color_cov_inv = color_cov_inv        # (4, 4, 8, 2)
        self.color_cov_logdet = color_cov_logdet  # (8, 2)
        self.gal_radius_px_mean = float(gal_radius_px_mean)
        self.gal_radius_px_var = float(gal_radius_px_var)

    @classmethod
    def from_prior(cls, p, device, dtype):
        """From a numpy PriorParams (models/priors.py)."""
        cov = np.asarray(p.color_cov)
        inv = np.zeros_like(cov)
        logdet = np.zeros((8, 2))
        for d in range(8):
            for i in range(2):
                inv[:, :, d, i] = np.linalg.inv(cov[:, :, d, i])
                logdet[d, i] = np.linalg.slogdet(cov[:, :, d, i])[1]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        return cls(t(p.is_star), t(p.flux_mean), t(p.flux_var), t(p.k),
                   t(p.color_mean), t(inv), t(logdet),
                   p.gal_radius_px_mean, p.gal_radius_px_var)


@functools.lru_cache(maxsize=None)
def default_prior(device, dtype):
    """The package prior (priors.prior) on `device` in `dtype`; constant,
    so it is built once per (device, dtype)."""
    return PriorConstants.from_prior(priors_mod.prior, device, dtype)


def categorical_kl(p, q):
    return torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1)


def gaussian_kl(mu1, var1, mu2, var2):
    return 0.5 * (torch.log(var2) - torch.log(var1)
                  + (var1 + (mu1 - mu2) ** 2) / var2 - 1.0)


def subtract_kl(vp, prior: PriorConstants = None):
    """Negative KL(q || prior) plus the point-mass log prior on
    gal_radius_px (elbo_kl.jl:143-154), (...) from vp (..., 44)."""
    if prior is None:
        prior = default_prior(vp.device, vp.dtype)
    a = vp[..., ids.is_star]                 # (..., 2)
    flux_loc = vp[..., ids.flux_loc]
    flux_scale = vp[..., ids.flux_scale]
    k = vp[..., ids.k]                       # (..., 8, 2)

    kl = categorical_kl(a, prior.is_star)
    for i in range(2):
        kl = kl + a[..., i] * gaussian_kl(flux_loc[..., i],
                                          flux_scale[..., i],
                                          prior.flux_mean[i],
                                          prior.flux_var[i])
        kl = kl + a[..., i] * categorical_kl(k[..., :, i], prior.k[:, i])
        # KL(diag-MVN || MVN) against each of the 8 color components
        mu1 = vp[..., ids.color_mean[:, i]]                # (..., 4)
        var1 = vp[..., ids.color_var[:, i]]
        inv2 = prior.color_cov_inv[:, :, :, i]              # (4, 4, 8)
        dmu = prior.color_mean[:, :, i].T - mu1[..., None, :]  # (..., 8, 4)
        diag_inv = torch.diagonal(inv2, dim1=0, dim2=1)     # (8, 4)
        per = (torch.sum(diag_inv * var1[..., None, :], dim=-1) - 4.0
               + torch.einsum("...da,abd,...db->...d", dmu, inv2, dmu)
               + prior.color_cov_logdet[:, i]
               - torch.sum(torch.log(var1), dim=-1)[..., None])
        kl = kl + a[..., i] * torch.sum(k[..., :, i] * (0.5 * per), dim=-1)

    x = vp[..., ids.gal_radius_px]
    e_log_prob = -0.5 * (math.log(2.0 * math.pi)
                         + math.log(prior.gal_radius_px_var)
                         + (x - prior.gal_radius_px_mean) ** 2
                         / prior.gal_radius_px_var)
    return -kl + e_log_prob


def elbo(vp, patch, bg_E_G=None, bg_var_G=None, include_kl=True,
         prior: PriorConstants = None):
    """Single-source ELBO of every source, (S,) (elbo_objective.jl:482-492)."""
    out = elbo_likelihood(vp, patch, bg_E_G, bg_var_G)
    if include_kl:
        out = out + subtract_kl(vp, prior)
    return out
