"""Bivariate normals on pixel grids (port of celeste_jl_tpu/models/bvn.py).

Every function broadcasts over leading axes: a batch of sources and bands
is one call, not a vmap.
"""

import torch

TWO_PI = 6.283185307179586


def get_bvn_cov(axis_ratio, angle, scale):
    """Covariance of a rotated 2-D Gaussian, (..., 2, 2) from (...) inputs
    (BivariateNormals.jl:29-43)."""
    cp = torch.cos(angle)
    sp = torch.sin(angle)
    ab_term = axis_ratio ** 2 - 1.0
    s2 = scale ** 2
    off = -s2 * cp * sp * ab_term
    c11 = s2 * (1.0 + ab_term * sp ** 2)
    c22 = s2 * (1.0 + ab_term * cp ** 2)
    return torch.stack([torch.stack([c11, off], -1),
                        torch.stack([off, c22], -1)], -2)


def eval_bvn_mixture_grid(x1, x2, means, covs, weights):
    """Mixture of weighted 2-D Gaussians on a pixel grid.

    x1, x2: (..., H, W) pixel coordinates; means (..., C, 2); covs
    (..., C, 2, 2); weights (..., C). Returns (..., H, W).
    """
    det = (covs[..., 0, 0] * covs[..., 1, 1]
           - covs[..., 0, 1] * covs[..., 1, 0])
    inv_det = 1.0 / det
    p11 = covs[..., 1, 1] * inv_det
    p22 = covs[..., 0, 0] * inv_det
    p12 = -covs[..., 0, 1] * inv_det
    z = weights / (TWO_PI * torch.sqrt(det))

    e = lambda t: t[..., None, None]                    # (..., C, 1, 1)
    dx1 = x1.unsqueeze(-3) - e(means[..., 0])           # (..., C, H, W)
    dx2 = x2.unsqueeze(-3) - e(means[..., 1])
    quad = (e(p11) * dx1 * dx1 + 2.0 * e(p12) * dx1 * dx2
            + e(p22) * dx2 * dx2)
    return torch.sum(e(z) * torch.exp(-0.5 * quad), dim=-3)
