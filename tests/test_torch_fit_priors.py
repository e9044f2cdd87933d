"""The port's prior fit (models/fit_priors.py: EM as a float64 torch loop)
against the JAX package's (a jitted lax.scan) on the same numpy inputs and
seed: weights, means and covariances to 1e-8; the artifact it saves is the
JAX package's file and loads through the port's models/priors.py."""

import numpy as np
import pytest
import torch

from celeste_jl_tpu.models import fit_priors as jfp
from celeste_jl_tpu_torch.models import fit_priors as fp
from celeste_jl_tpu_torch.models.priors import load_prior

torch.set_num_threads(1)

TOL = 1e-8


def _sample_gmm(rng, n, weights, means, covs):
    comps = rng.choice(len(weights), size=n, p=weights)
    return np.stack([rng.multivariate_normal(means[c], covs[c])
                     for c in comps])


def _fluxes(rng, n):
    """tests/test_fit_priors.py's catalogs: (N, 5) star and galaxy band
    fluxes and galaxy radii."""
    lnr = rng.normal(1.5, 0.8, (n, 1))
    colors = rng.normal(0.6, 0.3, (n, 4))
    lnf = np.cumsum(np.concatenate([np.zeros((n, 1)), colors], axis=1),
                    axis=1) + lnr
    star = np.exp(lnf - lnf[:, 2:3] + lnr)
    return star, star * 1.5, np.exp(rng.normal(0.5, 0.9, n))


def test_helpers_match_jax():
    mags = np.array([15.0, 20.0, 22.5, 24.1])
    np.testing.assert_array_equal(fp.mag_to_nmgy(mags),
                                  jfp.mag_to_nmgy(mags))
    f = np.exp(np.random.default_rng(0).normal(0, 1, (7, 5)))
    np.testing.assert_array_equal(fp.colors_from_fluxes(f),
                                  jfp.colors_from_fluxes(f))
    x = np.exp(np.random.default_rng(1).normal(1.3, 0.6, 500))
    assert fp.fit_lognormal(x) == jfp.fit_lognormal(x)


@pytest.mark.parametrize("K, iters", [(2, 150), (4, 60)])
def test_fit_color_gmm_matches_jax(K, iters):
    """tests/test_fit_priors.py's two-component mixture: the same hard
    init, then EM; each output within 1e-8 of JAX's, and the known
    mixture recovered."""
    rng = np.random.default_rng(0)
    means = np.array([[0.0, 0.0, 0.0, 0.0], [3.0, -2.0, 1.0, 2.0]])
    covs = np.array([np.eye(4) * 0.2, np.eye(4) * 0.5])
    x = _sample_gmm(rng, 1500, [0.3, 0.7], means, covs)
    got = fp.fit_color_gmm(x, K=K, iters=iters, seed=1, device="cpu")
    want = jfp.fit_color_gmm(x, K=K, iters=iters, seed=1)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    if K == 2:
        w, mu, _ = got
        np.testing.assert_allclose(np.sort(w), [0.3, 0.7], atol=0.03)


def test_fit_prior_matches_jax_and_loads(tmp_path):
    star, gal, radius = _fluxes(np.random.default_rng(2), 600)
    got = fp.fit_prior(star, gal, gal_radius_px=radius, K=3, iters=60,
                       device="cpu")
    want = jfp.fit_prior(star, gal, gal_radius_px=radius, K=3, iters=60)
    for f in ("is_star", "flux_mean", "flux_var", "k", "color_mean",
              "color_cov", "gal_radius_px_mean", "gal_radius_px_var"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=TOL, atol=TOL, err_msg=f)
    # without radii the shipped prior's radius terms are kept
    fp_default = fp.fit_prior(star, gal, K=2, iters=5, device="cpu")
    assert fp_default.gal_radius_px_mean == load_prior().gal_radius_px_mean

    fp.save_prior(str(tmp_path / "port.npz"), got)
    jfp.save_prior(str(tmp_path / "jax.npz"), want)
    mine, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path /
                                                           "jax.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in mine.files:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=TOL, atol=TOL)
    loaded = load_prior(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(loaded.k, got.k)
    np.testing.assert_array_equal(loaded.color_mean, got.color_mean)
    np.testing.assert_array_equal(loaded.color_cov, got.color_cov)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fp.fit_color_gmm(star[:, :4], K=2, iters=1)
