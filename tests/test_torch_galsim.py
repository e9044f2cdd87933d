"""The port's GalSim-style suite (benchmark/galsim.py, independent_render.py,
bundle.py, the runner galsim_suite.py and synthetic.gen_images) against the
JAX package's, f64 on the CPU: the scenes, the truth renderer's and the
model renderer's pixels, the initialisation catalog, the tolerance gate,
the bundles each package writes for the other, and two scenes end to end
against the JAX package's artifact (benchmark/galsim_results.csv)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from celeste_jl_tpu import synthetic as jsyn
from celeste_jl_tpu.benchmark import bundle as jbundle
from celeste_jl_tpu.benchmark import galsim as jgs
from celeste_jl_tpu.benchmark import independent_render as jir
from celeste_jl_tpu_torch import convert, synthetic
from celeste_jl_tpu_torch.benchmark import accuracy as ab
from celeste_jl_tpu_torch.benchmark import bundle, galsim, galsim_suite
from celeste_jl_tpu_torch.benchmark import independent_render as ir
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel.run import card_newton_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "benchmark", "galsim_results.csv")
CE_FIELDS = ("pos", "is_star", "star_fluxes", "gal_fluxes", "gal_frac_dev",
             "gal_axis_ratio", "gal_angle", "gal_radius_px")


def _same_entries(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in CE_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_scenes_and_truth_match_jax():
    assert [s.name for s in galsim.SCENES] == [s.name for s in jgs.SCENES]
    assert len(galsim.SCENES) == 28 and galsim.CI_CASES == jgs.CI_CASES
    for s, js in zip(galsim.SCENES, jgs.SCENES):
        assert (s.psf_sigma_pixels, s.sky_nmgy, s.include_noise,
                s.world_origin) == (js.psf_sigma_pixels, js.sky_nmgy,
                                    js.include_noise, js.world_origin)
        _same_entries(galsim.scene_truth(s), jgs.scene_truth(js))


@pytest.mark.parametrize("name", ["three_sources_all_overlap",
                                  "galaxy_with_all", "galaxy_with_noise"])
def test_render_scene_matches_jax(name):
    """render_scene (the independent truth renderer, and the Poisson draws
    of a noisy scene) gives JAX's pixels to 1e-12 relative, and each of
    its renderers JAX's images."""
    images, truth = galsim.render_scene(galsim.SCENES_BY_NAME[name])
    jimages, jtruth = jgs.render_scene(jgs.SCENES_BY_NAME[name])
    _same_entries(truth, jtruth)
    for img, jimg in zip(images, jimages):
        np.testing.assert_allclose(img.pixels, jimg.pixels, rtol=1e-12)
        np.testing.assert_array_equal(img.psf, jimg.psf)
        assert (img.band, img.sky, img.nelec_per_nmgy) == (
            jimg.band, jimg.sky, jimg.nelec_per_nmgy)
    got = ir.render_scene_nmgy(images, truth)
    want = jir.render_scene_nmgy(jimages, jtruth)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(
        ir.render_galaxy_nmgy(40, 30, (20.3, 14.8), 3.0, images[0].psf, 0.4,
                              0.5, 0.7, 2.5, np.diag([1.0, 1.1])),
        jir.render_galaxy_nmgy(40, 30, (20.3, 14.8), 3.0, images[0].psf, 0.4,
                               0.5, 0.7, 2.5, np.diag([1.0, 1.1])),
        rtol=1e-12)


def test_gen_images_matches_jax():
    """synthetic.gen_images (the model's own renderer on the device) gives
    JAX's expected pixels to 1e-10 relative, and from the same seed the
    same Poisson draws."""
    truth = [jsyn.sample_star(pos=(14.2, 20.7), r_flux=30.0),
             jsyn.sample_galaxy(pos=(30.5, 12.1), r_flux=25.0,
                                gal_radius_px=2.3),
             jsyn.sample_galaxy(pos=(3.0, 36.0), r_flux=15.0)]
    for expectation in (True, False):
        jimgs = jsyn.make_blank_images(H=44, W=40, sky_nmgy=0.05,
                                       nelec_per_nmgy=900.0)
        imgs = convert.images(jimgs)
        jsyn.gen_images(jimgs, truth, expectation=expectation, seed=9)
        synthetic.gen_images(imgs, convert.catalog(truth),
                             expectation=expectation, seed=9, device="cpu")
        for img, jimg in zip(imgs, jimgs):
            if expectation:
                np.testing.assert_allclose(img.pixels, jimg.pixels,
                                           rtol=1e-10)
            else:
                np.testing.assert_array_equal(img.pixels, jimg.pixels)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            synthetic.render_source_nmgy(imgs[0], convert.catalog(truth)[0])


def test_initialization_catalog_and_gate_match_jax():
    for s, js in zip(galsim.SCENES, jgs.SCENES):
        for full in (False, True):
            _same_entries(
                galsim.make_initialization_catalog(galsim.scene_truth(s),
                                                   full),
                jgs.make_initialization_catalog(jgs.scene_truth(js), full))
    # a truth/prediction pair over every variable, with misses and a wrap
    truth = ab.catalog_entries_to_df(
        galsim.scene_truth(galsim.SCENES_BY_NAME["three_sources_two_overlap"]))
    rng = np.random.default_rng(3)
    pred = truth.copy()
    for c in galsim.COMPARISON_COLUMNS:
        pred[c] = truth[c] * rng.uniform(0.7, 1.3, len(truth))
    pred["gal_angle_deg"] = np.where(np.isnan(truth["gal_angle_deg"]),
                                     np.nan, 179.0)
    pred["gal_axis_ratio"] = np.full(len(truth), 0.3)
    ids = [f"s_{i:03d}" for i in range(len(truth))]
    truth.insert(0, "objid", ids)
    pred.insert(0, "objid", ids)
    jtruth = pd.DataFrame({c: truth[c] for c in truth.columns})
    jpred = pd.DataFrame({c: pred[c] for c in pred.columns})
    cmp_, jcmp = (galsim.truth_comparison_df(truth, pred),
                  jgs.truth_comparison_df(jtruth, jpred))
    assert cmp_.columns == list(jcmp.columns) and len(cmp_) == len(jcmp)
    for c in ("truth", "estimate"):
        np.testing.assert_array_equal(cmp_[c], jcmp[c].to_numpy(float))
    assert list(cmp_["variable"]) == list(jcmp["variable"])
    bad, jbad = galsim.estimate_violations(cmp_), \
        jgs.estimate_violations(jcmp)
    assert len(bad) > 0 and bad == jbad
    for v in galsim.COMPARISON_COLUMNS:
        assert galsim.max_error_for(v, 3.5) == jgs.max_error_for(v, 3.5)


def test_bundles_cross_read(tmp_path):
    """A bundle the JAX package wrote reads back in the port, and the
    port's in the JAX package: the same pixels, PSF, sky, calibration,
    WCS and truth; the two files are byte for byte the same."""
    images, truth = galsim.render_scene(
        galsim.SCENES_BY_NAME["overlapping_star_and_galaxy"])
    jimages, jtruth = jgs.render_scene(
        jgs.SCENES_BY_NAME["overlapping_star_and_galaxy"])
    bundle.write_image_bundle(str(tmp_path / "port.fits"), images, truth)
    jbundle.write_image_bundle(str(tmp_path / "jax.fits"), jimages, jtruth)
    assert (tmp_path / "port.fits").read_bytes() == \
        (tmp_path / "jax.fits").read_bytes()
    for (imgs, tr), (jimgs, jtr) in (
            (bundle.read_image_bundle(str(tmp_path / "jax.fits")),
             jbundle.read_image_bundle(str(tmp_path / "jax.fits"))),
            (bundle.read_image_bundle(str(tmp_path / "port.fits")),
             jbundle.read_image_bundle(str(tmp_path / "port.fits")))):
        _same_entries(tr, jtr)
        assert len(imgs) == len(jimgs) == 5 and len(tr) == len(truth)
        for a, b, orig in zip(imgs, jimgs, images):
            np.testing.assert_array_equal(a.pixels, b.pixels)
            np.testing.assert_allclose(a.pixels, orig.pixels, rtol=1e-6)
            np.testing.assert_array_equal(a.psf, np.asarray(b.psf))
            np.testing.assert_allclose(a.psf, orig.psf, rtol=1e-12)
            assert (a.band, a.sky, a.nelec_per_nmgy) == (
                b.band, b.sky, b.nelec_per_nmgy)
            np.testing.assert_array_equal(a.wcs.cd, b.wcs.cd)
            np.testing.assert_array_equal(a.wcs.crval, b.wcs.crval)
        for t, t0 in zip(tr, truth):
            np.testing.assert_allclose(t.pos, t0.pos, rtol=1e-12)
            np.testing.assert_allclose(
                t.star_fluxes if t.is_star else t.gal_fluxes,
                t0.star_fluxes if t0.is_star else t0.gal_fluxes, rtol=1e-12)


@pytest.mark.parametrize("solver", ["eig", "card"])
@pytest.mark.parametrize("name", ["simple_star", "galaxy_with_all"])
def test_scene_matches_the_jax_artifact(name, solver):
    """run_benchmarks (joint, f64, radius 40, the CPU) on the scene against
    its row of the JAX package's artifact: P(star) within 1e-4, the
    r-flux within 1e-4 relative and, for the galaxy, the axis ratio and
    radius within 1e-3 relative (a star's galaxy shape sits on a flat
    ridge and is not compared). solver: the CPU's default (eig), or the
    card's float64 solver (run.card_newton_config: pjacobi, here through
    the kernels' plain twins)."""
    newton = (card_newton_config(NewtonConfig(), torch.float64)
              if solver == "card" else None)
    truth_df, pred_df = galsim.run_benchmarks(
        [name], joint_inference=True, min_radius_pix=40.0, device="cpu",
        newton_config=newton)
    ref = ab.read_csv(ARTIFACT)
    row = ref[ref["objid"] == f"{name}_000"]
    assert len(row) == 1 and list(pred_df["objid"]) == [f"{name}_000"]
    np.testing.assert_allclose(truth_df["flux_r_nmgy"],
                               row["true_flux_r_nmgy"], rtol=1e-12)
    assert abs(pred_df["is_star"][0] - row["est_is_star"][0]) <= 1e-4
    np.testing.assert_allclose(pred_df["flux_r_nmgy"],
                               row["est_flux_r_nmgy"], rtol=1e-4)
    if truth_df["is_star"][0] < 0.5:
        for c in ("gal_axis_ratio", "gal_radius_px"):
            np.testing.assert_allclose(pred_df[c], row[f"est_{c}"],
                                       rtol=1e-3)


def test_suite_runner_writes_its_results(tmp_path):
    """galsim_suite.run_suite and write_results on a noise-free and a noisy
    scene, the fits cut to two Newton steps (the runner's bookkeeping, not
    the fit): the noisy scene rerun without noise, both files written (the
    CSV in the JAX runner's columns), the JSON record complete."""
    import json

    res = galsim_suite.run_suite(["simple_star", "star_with_noise"],
                                 radius=8.0, device="cpu",
                                 newton_config=NewtonConfig(max_iters=2))
    assert res["nf_wall_s"] > 0 and len(res["truth_df"]) == 2
    assert np.all(np.isfinite(res["pred_df"]["elbo"]))
    md, csv = galsim_suite.write_results(res, str(tmp_path), "cpu")
    got = pd.read_csv(csv)
    want = pd.read_csv(ARTIFACT)
    assert list(got.columns) == list(want.columns)
    assert list(got["objid"]) == ["simple_star_000", "star_with_noise_000"]
    text = open(md).read()
    assert "NOISE-FREE gate" in text and "| field" in text
    rec = json.loads(json.dumps(galsim_suite.summary(res, "cpu")))
    assert rec["scenes"] == 2 and rec["device"] == "cpu"
    assert rec["launches"] == {"refresh": 0, "jacobi_sweep": 0,
                               "tr_subproblem": 0}
