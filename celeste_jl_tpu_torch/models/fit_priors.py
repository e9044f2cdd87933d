"""Fit the model priors from catalog data (the port's counterpart of
celeste_jl_tpu/models/fit_priors.py; cfg/gen_priors.jl rebuilt).

The reference fits, offline with GaussianMixtures.jl, an 8-component
full-covariance GMM over the 4 adjacent-band log-flux ratios (colors) per
source type, plus lognormal r-flux priors, and ships them as JLD artifacts
(cfg/star_prior.jld, gal_prior.jld; loaded by
model/light_source_model.jl:99-105). This module reproduces that pipeline:
EM for the color GMM as a float64 torch loop on an explicit device (the
JAX package's lax.scan written out, batched over components), moment fits
for the lognormals, and an .npz artifact in exactly the schema
models/priors.load_prior reads. The hard initialisation takes the JAX
package's numpy draws, so both packages start EM from the same
responsibilities.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve


def mag_to_nmgy(mag):
    """SDSS luptitude-free conversion (gen_priors.jl:11-13)."""
    return 10.0 ** ((np.asarray(mag) - 22.5) / -2.5)


def colors_from_fluxes(fluxes):
    """(N, 5) band fluxes -> (N, 4) adjacent-band log ratios."""
    f = np.asarray(fluxes, dtype=np.float64)
    return np.log(f[:, 1:] / f[:, :-1])


def _em(x, resp0, K=8, iters=200, ridge=1e-6):
    """Full-covariance GMM EM. x: (N, D) float64 tensor; resp0: (N, K)
    initial responsibilities on x's device. Returns (weights (K,), means
    (K, D), covs (K, D, D), final mean per-point log-likelihood)."""
    N, D = x.shape
    eye = torch.eye(D, dtype=x.dtype, device=x.device)

    def m_step(resp):
        nk = resp.sum(0) + 1e-12                       # (K,)
        w = nk / N
        mu = (resp.T @ x) / nk[:, None]                # (K, D)
        dx = x[None, :, :] - mu[:, None, :]            # (K, N, D)
        cov = torch.einsum("kn,knd,kne->kde", resp.T, dx, dx) \
            / nk[:, None, None]
        return w, mu, cov + ridge * eye

    def log_resp(w, mu, cov):
        chol = torch.linalg.cholesky(cov)              # (K, D, D)
        dx = x[None, :, :] - mu[:, None, :]            # (K, N, D)
        sol = torch.linalg.solve_triangular(chol, dx.transpose(1, 2),
                                            upper=False)  # (K, D, N)
        maha = torch.sum(sol ** 2, dim=1)              # (K, N)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        lp = (torch.log(w)[:, None] - 0.5 * (maha + logdet[:, None]
                                             + D * math.log(2 * math.pi)))
        return lp.T                                    # (N, K)

    resp, ll = resp0, None
    for _ in range(iters):
        w, mu, cov = m_step(resp)
        lp = log_resp(w, mu, cov)
        lse = torch.logsumexp(lp, dim=1)               # (N,)
        resp = torch.exp(lp - lse[:, None])
        ll = torch.mean(lse)
    w, mu, cov = m_step(resp)
    return w, mu, cov, ll


def fit_color_gmm(colors, K=8, iters=200, seed=0, *, device="cuda"):
    """Fit a K-component full-covariance GMM to (N, 4) colors on `device`
    (the card unless the caller asks for the CPU), in float64.

    Returns numpy (weights (K,), means (K, 4), covs (4, 4, K)) in the
    orientation PriorParams stores them."""
    dev = resolve(device)
    x = np.asarray(colors, dtype=np.float64)
    N = x.shape[0]
    rng = np.random.default_rng(seed)
    # k-means++-ish hard init: random distinct points as seeds
    seeds = x[rng.choice(N, K, replace=False)]
    d2 = np.linalg.norm(x[:, None, :] - seeds[None], axis=-1)
    hard = d2.argmin(1)
    resp0 = np.eye(K)[hard] * 0.9 + 0.1 / K
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    w, mu, cov, _ = _em(t(x), t(resp0), K=K, iters=iters)
    return (w.cpu().numpy(), mu.cpu().numpy(),
            np.transpose(cov.cpu().numpy(), (1, 2, 0)))


def fit_lognormal(x):
    """Lognormal (loc, var) by moments of log(x)."""
    lx = np.log(np.asarray(x, dtype=np.float64))
    return float(lx.mean()), float(lx.var())


def fit_prior(star_fluxes, gal_fluxes, gal_radius_px=None, K=8, iters=200,
              seed=0, is_star_frac=0.28, *, device="cuda"):
    """Fit a full PriorParams from per-type (N, 5) band-flux catalogs
    (r band = index 2) and optional galaxy radii (px); the color GMMs on
    `device`."""
    from .priors import PriorParams, prior as default_prior

    ws, ms, cs = fit_color_gmm(colors_from_fluxes(star_fluxes), K, iters,
                               seed, device=device)
    wg, mg, cg = fit_color_gmm(colors_from_fluxes(gal_fluxes), K, iters,
                               seed + 1, device=device)
    star_loc, star_var = fit_lognormal(np.asarray(star_fluxes)[:, 2])
    gal_loc, gal_var = fit_lognormal(np.asarray(gal_fluxes)[:, 2])
    if gal_radius_px is not None:
        rad_loc, rad_var = fit_lognormal(gal_radius_px)
    else:
        rad_loc = default_prior.gal_radius_px_mean
        rad_var = default_prior.gal_radius_px_var
    return PriorParams(
        is_star=np.array([is_star_frac, 1.0 - is_star_frac]),
        flux_mean=np.array([star_loc, gal_loc]),
        flux_var=np.array([star_var, gal_var]),
        k=np.stack([ws, wg], axis=1),
        color_mean=np.stack([ms.T, mg.T], axis=2),
        color_cov=np.stack([cs, cg], axis=3),
        gal_radius_px_mean=rad_loc,
        gal_radius_px_var=rad_var,
    )


def save_prior(path, p):
    """Write the npz artifact in the schema models/priors.load_prior reads
    (the JLD-artifact equivalent)."""
    np.savez(
        path,
        star_prior_weights=p.k[:, 0], gal_prior_weights=p.k[:, 1],
        star_prior_means=p.color_mean[:, :, 0],
        gal_prior_means=p.color_mean[:, :, 1],
        star_prior_covs=p.color_cov[:, :, :, 0],
        gal_prior_covs=p.color_cov[:, :, :, 1])
