"""Point-spread function as a K-component Gaussian mixture (port of
celeste_jl_tpu/models/psf.py). Packed (..., K, 6) rows are
[alpha, mu1, mu2, sigma11, sigma12, sigma22]."""

import numpy as np
import torch

from .bvn import eval_bvn_mixture_grid


def make_psf(alphas, mus, covs):
    """Pack a PSF mixture. alphas (K,), mus (K, 2), covs (K, 2, 2) ->
    (K, 6) numpy."""
    alphas = np.asarray(alphas, dtype=np.float64)
    mus = np.asarray(mus, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    return np.concatenate(
        [alphas[:, None], mus,
         covs[:, 0, 0, None], covs[:, 0, 1, None], covs[:, 1, 1, None]],
        axis=1)


def psf_alphas(psf):
    return psf[..., 0]


def psf_mus(psf):
    return psf[..., 1:3]


def psf_covs(psf):
    s11, s12, s22 = psf[..., 3], psf[..., 4], psf[..., 5]
    return torch.stack([torch.stack([s11, s12], -1),
                        torch.stack([s12, s22], -1)], -2)


def gaussian_psf(sigma=1.5, K=2):
    """Isotropic test PSF of K concentric Gaussians, packed (K, 6) numpy
    (the same values as the JAX package's gaussian_psf)."""
    if K == 1:
        alphas, scales = [1.0], [1.0]
    else:
        alphas = [0.8] + [0.2 / (K - 1)] * (K - 1)
        scales = [1.0] + [2.0] * (K - 1)
    covs = np.stack([np.eye(2) * (sigma * s) ** 2 for s in scales])
    return make_psf(alphas, np.zeros((K, 2)), covs)


def get_psf_width(psf, width_scale=1.0):
    """Effective PSF width heuristic (model/psf_model.jl:32-52): the
    alpha-weighted mean of component major standard deviations, ignoring
    negligible components, scaled by width_scale. psf: (K, 6) numpy."""
    alphas = np.asarray(psf[:, 0])
    covs = np.asarray(psf[:, 3:6])
    w = 0.0
    total = 0.0
    for k in range(psf.shape[0]):
        if alphas[k] > 0.05:
            major_sd = np.sqrt(max(covs[k, 0], covs[k, 2]))
            w += alphas[k] * major_sd
            total += alphas[k]
    return width_scale * w / total


def render_psf(psf, size=51):
    """Rasterize PSF mixtures (..., K, 6) onto size x size grids centered on
    the stamp center (model/psf_model.jl:61-75), (..., size, size). A numpy
    psf renders in float64 on the CPU; a tensor in its dtype and device."""
    psf = torch.as_tensor(psf, dtype=None if torch.is_tensor(psf)
                          else torch.float64)
    c = (size + 1) / 2.0
    i = torch.arange(1, size + 1, dtype=psf.dtype, device=psf.device)
    x1, x2 = torch.meshgrid(i, i, indexing="ij")
    return eval_bvn_mixture_grid(x1, x2, psf_mus(psf) + c, psf_covs(psf),
                                 psf_alphas(psf))
