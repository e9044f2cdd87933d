"""The port's PSF fit (models/psf_fit.py, models/psf.make_psf and
render_psf) and per-source PSFs in the patches against the JAX package's,
f64 on the CPU, on the same stamps:

- fit_raw_psf on tests/test_psf_fit.py's known two-component mixture:
  packed params within 1e-6 relative, squared error within 1e-8 relative;
  fit_psfs_batched on elliptical stamps: the same bars, each lane equal to
  its one-lane fit;
- tests/test_psf_fit.py's round gaussian_psf stamps: the fit walks a flat
  ridge (a round component's angle is free; a 1e-15 change of the stamp
  moves JAX's own fit by ~7e-5, ROADMAP queue 3), so both fits are held
  to JAX's own bars against the stamp and to each other's density;
- trim_width and trim_psf: exact;
- fit_patch_psfs (S, B, K, 6) on a spatially varying elliptical psfmap,
  with a band that has no psfmap (the field-center fallback) and a wider
  fallback mixture (zero-weight padding): within 1e-6 relative;
- make_patches_batched(psfs=...): equal.
"""

import numpy as np
import pytest
import torch

from celeste_jl_tpu.io.sdss import SDSSPSFMap as JaxPSFMap
from celeste_jl_tpu.models import psf_fit as jfit
from celeste_jl_tpu.models.image import Image as JaxImage
from celeste_jl_tpu.models.patches import (make_patches_batched as
                                           jax_make_patches)
from celeste_jl_tpu.models.psf import gaussian_psf as jax_gaussian_psf
from celeste_jl_tpu.models.psf import make_psf as jax_make_psf
from celeste_jl_tpu.models.psf import render_psf as jax_render_psf
from celeste_jl_tpu.synthetic import gen_images, sample_star
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.io.sdss import SDSSPSFMap
from celeste_jl_tpu_torch.models import psf_fit
from celeste_jl_tpu_torch.models.patches import make_patches_batched
from celeste_jl_tpu_torch.models.psf import (gaussian_psf, make_psf,
                                             render_psf)

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _elliptical(sigma, angle, ratio=0.7, mu=(0.2, -0.1)):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    covs = [R @ np.diag([(k * sigma) ** 2, (ratio * k * sigma) ** 2]) @ R.T
            for k in (1.0, 2.2)]
    return make_psf([0.75, 0.25], [mu, [0.0, 0.1]], covs)


def test_make_and_render_psf_match_jax():
    rng = np.random.default_rng(0)
    alphas, mus = rng.uniform(0.1, 1, 3), rng.normal(size=(3, 2))
    A = rng.normal(size=(3, 2, 2))
    covs = A @ A.transpose(0, 2, 1) + np.eye(2)
    psf = make_psf(alphas, mus, covs)
    np.testing.assert_array_equal(psf, jax_make_psf(alphas, mus, covs))
    np.testing.assert_array_equal(gaussian_psf(1.4, K=3),
                                  jax_gaussian_psf(1.4, K=3))
    for size in (25, 40):
        got = render_psf(psf, size).numpy()
        assert _rel(got, np.asarray(jax_render_psf(psf, size))) < 1e-13
    brighter = psf.copy()
    brighter[:, 0] *= 2.0
    stacked = render_psf(torch.as_tensor(np.stack([psf, brighter])), 25)
    assert stacked.shape == (2, 25, 25)
    np.testing.assert_allclose(stacked[1].numpy(),
                               2 * render_psf(psf, 25).numpy(), rtol=1e-14)


def test_fit_raw_psf_matches_jax_on_the_known_mixture():
    truth = make_psf([0.6, 0.4], [[0.3, -0.2], [0.0, 0.1]],
                     [np.array([[2.0, 0.3], [0.3, 1.5]]),
                      np.array([[6.0, -0.5], [-0.5, 7.0]])])
    stamp = render_psf(truth, 41).numpy()
    got, err = psf_fit.fit_raw_psf(stamp, K=2, **CPU)
    want, jerr = jfit.fit_raw_psf(stamp, K=2)
    assert got.shape == (2, 6)
    assert _rel(got, want) < 1e-6
    assert abs(err - jerr) <= 1e-8 * abs(jerr)
    # test_psf_fit.py's own bars
    model = render_psf(got, 41).numpy()
    assert np.max(np.abs(model - stamp)) / stamp.max() < 5e-3
    assert err < 1e-6


def test_fit_psfs_batched_matches_jax_and_one_lane_fits():
    stamps = np.stack([render_psf(_elliptical(s, a), 31).numpy()
                       for s, a in ((1.3, 0.4), (1.8, -0.7), (1.5, 1.2))])
    got, errs = psf_fit.fit_psfs_batched(stamps, K=2, **CPU)
    want, jerrs = jfit.fit_psfs_batched(stamps, K=2)
    assert got.shape == (3, 2, 6) and errs.shape == (3,)
    for i in range(3):
        assert _rel(got[i], want[i]) < 1e-6, i
        assert abs(errs[i] - jerrs[i]) <= 1e-8 * abs(jerrs[i]), i
        one, one_err = psf_fit.fit_raw_psf(stamps[i], K=2, **CPU)
        np.testing.assert_allclose(got[i], one, rtol=0,
                                   atol=1e-12 * np.abs(one).max())


@pytest.mark.parametrize("sigmas", [(1.2, 1.8), (1.4,)])
def test_round_stamps_meet_jax_bars(sigmas):
    stamps = np.stack([render_psf(gaussian_psf(sigma=s), 31).numpy()
                       for s in sigmas])
    got, errs = psf_fit.fit_psfs_batched(stamps, K=2, **CPU)
    want, _ = jfit.fit_psfs_batched(stamps, K=2)
    for i in range(len(sigmas)):
        model = render_psf(got[i], 31).numpy()
        jmodel = np.asarray(jax_render_psf(want[i], 31))
        assert np.max(np.abs(model - stamps[i])) / stamps[i].max() < 1e-3
        assert np.max(np.abs(model - jmodel)) / jmodel.max() < 1e-5
        assert abs(got[i][:, 0].sum() - 1.0) < 0.02
    assert np.all(errs < 1e-6)


def test_trim_matches_jax():
    for sigma, pct in ((1.0, 0.99), (1.6, 0.999), (3.0, 0.999)):
        stamp = render_psf(gaussian_psf(sigma=sigma), 51).numpy()
        assert psf_fit.trim_width(stamp, pct) == jfit.trim_width(stamp, pct)
        np.testing.assert_array_equal(psf_fit.trim_psf(stamp, pct),
                                      jfit.trim_psf(stamp, pct))
    padded = psf_fit._pad_components(gaussian_psf(1.5, K=2), 4)
    np.testing.assert_array_equal(
        padded, jfit._pad_components(jax_gaussian_psf(1.5, K=2), 4))


STAMP, HW = 31, 40


def _varying_psfmap(cls):
    """An elliptical PSF whose core widens along axis 1: eigen 0 the narrow
    PSF, eigen 1 (wide - narrow) with weight (x - 1)/(HW - 1)."""
    narrow = render_psf(_elliptical(1.2, 0.5), STAMP).numpy()
    wide = render_psf(_elliptical(2.0, 0.5), STAMP).numpy()
    rrows = np.stack([narrow.ravel(order="F"),
                      (wide - narrow).ravel(order="F")], axis=1)
    cmat = np.zeros((2, 1, 2))
    cmat[0, 0, 0] = 1.0
    cmat[1, 0, 1] = 1.0 / (cls.RCS * (HW - 1))
    return cls(rrows, STAMP, STAMP, cmat)


def _psfmap_images():
    """Five 40 x 40 bands, star-free: bands 0-3 carry the varying psfmap,
    band 4 none and a three-component field PSF (the fallback, and the
    padding of the fitted bands to K = 3)."""
    jax_images = [JaxImage(pixels=np.zeros((HW, HW)), band=b,
                           psf=jax_gaussian_psf(1.5, K=3 if b == 4 else 2),
                           sky=0.1, nelec_per_nmgy=1000.0,
                           meta={} if b == 4 else
                           {"psfmap": _varying_psfmap(JaxPSFMap)})
                  for b in range(5)]
    images = convert.images(jax_images)
    for img in images[:4]:
        img.meta = {"psfmap": _varying_psfmap(SDSSPSFMap)}
    return jax_images, images


def test_fit_patch_psfs_matches_jax():
    jax_images, images = _psfmap_images()
    positions = np.array([[5.0, 20.0], [20.5, 11.0], [36.0, 30.0]])
    got = psf_fit.fit_patch_psfs(images, positions, **CPU)
    want = jfit.fit_patch_psfs(jax_images, positions)
    assert got.shape == want.shape == (3, 5, 3, 6)
    for s in range(3):
        for b in range(5):
            assert _rel(got[s, b], want[s, b]) < 1e-6, (s, b)
    # the fallback band is the field PSF; the padding weighs nothing
    np.testing.assert_array_equal(got[:, 4], np.broadcast_to(
        images[4].psf, (3, 3, 6)))
    assert np.all(got[:, :4, 2, 0] == 0.0)
    # the local width follows the psfmap along axis 1
    widths = [np.sqrt(got[s, 0, 0, 3]) for s in range(3)]
    assert widths[0] < widths[1] < widths[2]

    # the patches carry them, as the JAX package's
    radii = np.full(3, 6.0)
    for g, w in zip(make_patches_batched(images, positions, radii, 16,
                                         psfs=got),
                    jax_make_patches(jax_images, positions, radii, 16,
                                     psfs=got)):
        for name, a, b in zip(w._fields, g, w):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_psf_fits_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    stamp = render_psf(gaussian_psf(1.5), 15).numpy()
    with pytest.raises(RuntimeError, match="cuda"):
        psf_fit.fit_raw_psf(stamp)
    with pytest.raises(RuntimeError, match="cuda"):
        psf_fit.fit_psfs_batched(stamp[None])
    _, images = _psfmap_images()
    with pytest.raises(RuntimeError, match="cuda"):
        psf_fit.fit_patch_psfs(images, [[5.0, 5.0]])


def test_per_source_psfs_recover_an_off_center_flux():
    """tests/test_patch_psf.py's bias check on the port: a star rendered
    with its local PSF is fitted better with the per-source PSFs than with
    the field-center PSF alone."""
    from celeste_jl_tpu_torch.models.params import ids
    from celeste_jl_tpu_torch.parallel.run import one_node_single_infer
    from celeste_jl_tpu_torch.utils.config import Config

    jax_images, _ = _psfmap_images()
    star = sample_star(pos=(34.0, 20.0), r_flux=20.0)
    local = psf_fit.fit_patch_psfs(convert.images(jax_images),
                                   [star.pos], **CPU)[0, 0, :2]
    center, _ = psf_fit.fit_raw_psf(psf_fit.trim_psf(
        _varying_psfmap(SDSSPSFMap)(HW / 2.0, HW / 2.0)), **CPU)
    for img in jax_images:
        img.psf, img.meta = local, {}
    gen_images(jax_images, [star], expectation=True)
    fluxes = []
    for use_map in (False, True):
        images = convert.images(jax_images)
        for img in images:
            img.psf = center
            img.meta = ({"psfmap": _varying_psfmap(SDSSPSFMap)} if use_map
                        else {})
        res = one_node_single_infer(convert.catalog([star]), images,
                                    config=Config(min_radius_pix=12.0),
                                    device="cpu", dtype=torch.float64)[0]
        i = 0 if res.vs[ids.is_star[0]] > 0.5 else 1
        fluxes.append(float(np.exp(res.vs[ids.flux_loc[i]])))
    assert res.vs[ids.is_star[0]] > 0.5     # a star under its local PSF
    err_center, err_local = (abs(f - 20.0) / 20.0 for f in fluxes)
    assert err_local < 0.03 and err_local < err_center, fluxes
