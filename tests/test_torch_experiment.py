"""The port's MCMC-vs-VI experiment (experiments/mcmc_experiment.py,
experiments/mcmc_figures.py) and its chain reporting (mcmc/infer.py's
samples_to_dataframe, samples_to_row, mcmc_to_df, which return
accuracy.Table's) against the JAX package's, float64 on the CPU:

- the prior catalog and the rendered field equal JAX's bit for bit;
- the chain reporting on fixed synthetic chains equals JAX's pandas frames
  to 1e-12 (no AIS run of the JAX package);
- the experiment end to end at 3 sources on 96 px with a short ladder and
  short chains (the CPU run of one_node_mcmc_infer): its CSVs are the
  files pandas writes of the same tables, JAX's mcmc_figures reads them
  and its calibration table, error comparison and AUCs agree with the
  port's to 1e-12, and the port's figures runner draws its figures.
"""

import functools
import os

import numpy as np
import pandas as pd
import pytest
import torch

from celeste_jl_tpu.benchmark import accuracy as jab
from celeste_jl_tpu.io.wcs import LinearWCS as JaxLinearWCS
from celeste_jl_tpu.mcmc import infer as jinfer
from celeste_jl_tpu.models.image import Image as JaxImage
from celeste_jl_tpu.models.psf import gaussian_psf as jax_gaussian_psf
from celeste_jl_tpu.synthetic import gen_images as jax_gen_images
from celeste_jl_tpu_torch.experiments import mcmc_experiment, mcmc_figures
from celeste_jl_tpu_torch.mcmc import infer
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

N_SOURCES, SIZE, SEED = 3, 96, 11


def _assert_table_equals_frame(table, frame, rtol=1e-12):
    assert table.columns == list(frame.columns)
    for c in frame.columns:
        if table[c].dtype == object:
            # pandas reads a column of empty strings back as NaN
            np.testing.assert_array_equal(
                table[c].astype(str),
                frame[c].fillna("").to_numpy().astype(str), err_msg=c)
        else:
            np.testing.assert_allclose(table[c].astype(float),
                                       frame[c].to_numpy(float), rtol=rtol,
                                       atol=0.0, err_msg=c)


def test_prior_catalog_and_field_match_jax():
    truth, images = mcmc_experiment.experiment_field(N_SOURCES, SIZE, SEED,
                                                     torch.device("cpu"))
    dpp = 0.396 / 3600.0
    jtruth = jab.generate_catalog_from_prior(N_SOURCES, extent=SIZE * dpp,
                                             margin=16.0 * dpp, seed=SEED)
    wcs = JaxLinearWCS(crpix=(0.0, 0.0), crval=(0.0, 0.0),
                       cd=np.eye(2) * dpp)
    jimages = [JaxImage(pixels=np.zeros((SIZE, SIZE)), band=b,
                        psf=jax_gaussian_psf(), sky=0.1,
                        nelec_per_nmgy=600.0, wcs=wcs) for b in range(5)]
    jax_gen_images(jimages, jtruth, seed=SEED)
    for a, b in zip(truth, jtruth):
        for f in ("pos", "is_star", "star_fluxes", "gal_fluxes",
                  "gal_frac_dev", "gal_axis_ratio", "gal_angle",
                  "gal_radius_px"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for img, jimg in zip(images, jimages):
        np.testing.assert_array_equal(img.pixels, jimg.pixels)
        np.testing.assert_array_equal(img.psf, jimg.psf)


def _chains(rng, n):
    """n AIS results with fixed chains: 4 chains of 6 draws each model."""
    out = []
    for i in range(n):
        star = rng.normal(size=(24, 7)) * 0.1 + np.arange(7)
        gal = rng.normal(size=(24, 11)) * 0.1 + 0.5
        gal[:, 8] = rng.uniform(0.2, 0.9, 24)
        out.append({"star_samples": star, "gal_samples": gal,
                    "ave_pstar": (0.9, 0.2, 0.5)[i % 3],
                    "star_lnZ": -100.0 - i, "gal_lnZ": -99.5 - i,
                    "objid": f"src{i}" if i else ""})
    return out


def test_chain_reporting_matches_jax_pandas():
    results = _chains(np.random.default_rng(4), 3)
    for is_star, key in ((True, "star_samples"), (False, "gal_samples")):
        chain = results[0][key]
        got = infer.samples_to_dataframe(chain, is_star)
        want = jinfer.samples_to_dataframe(chain, is_star)
        _assert_table_equals_frame(got, want)
        got_row = infer.samples_to_row(got, is_star)
        want_row = jinfer.samples_to_row(want, is_star)
        assert list(got_row) == list(want_row)
        np.testing.assert_allclose([float(v) for v in got_row.values()],
                                   [float(v) for v in want_row.values()],
                                   rtol=1e-12, atol=0.0)
    for num_chains in (4, 1):
        _assert_table_equals_frame(
            infer.mcmc_to_df(results, num_chains=num_chains),
            jinfer.mcmc_to_df(results, num_chains=num_chains))


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The port's experiment at 3 sources on 96 px, f64: 2 temperatures x
    2 samples, posterior chains of 1 draw (run_ais_batched's length,
    25 in the runner, patched here), joint VI with the schedule cut to a
    refresh of 2 steps a fit (on the CPU's plain twins a K4 evaluation of
    the 64 x 64 tiles takes ~40 ms and a slice sweep ~140 of them)."""
    out = str(tmp_path_factory.mktemp("experiment"))
    short = Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                   polish_refreshes=1, polish_sweeps=1, probe_refreshes=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(infer, "run_ais_batched", functools.partial(
            infer.run_ais_batched, num_samples_per_chain=1))
        res = mcmc_experiment.run(
            N_SOURCES, SIZE, SEED, temperatures=2, samples=2, output_dir=out,
            device="cpu", dtype=torch.float64, config=short,
            newton_config=NewtonConfig(max_iters=1, hess_every=2))
    return out, res


def test_experiment_writes_pandas_files(experiment):
    out, res = experiment
    assert sorted(res["files"]) == ["mc", "mc_samples", "truth", "vi",
                                    "vi_posterior"]
    mc = res["mc"]
    assert len(mc) == N_SOURCES
    assert np.all(np.isfinite(mc["star_lnZ"]))
    assert np.all(np.isfinite(mc["gal_lnZ"]))
    assert np.all(np.isfinite(res["vi_elbos"]))
    samples = np.load(res["files"]["mc_samples"])
    assert samples["star_0"].shape == (2 * 1, 7)
    assert samples["gal_2"].shape == (2 * 1, 11)
    for name in ("truth", "vi", "mc", "vi_posterior"):
        path = res["files"][name]
        frame = pd.read_csv(path, float_precision="round_trip")
        _assert_table_equals_frame(res[name], frame, rtol=0.0)
        # the bytes pandas writes of the same frame
        with open(path) as f:
            assert f.read() == frame.to_csv(index=False), name


def test_jax_figures_read_the_port_files(experiment):
    """JAX's make_calibration_table, make_error_comparison and make_roc on
    the port's CSVs equal the port's tables and AUCs; the port's runner
    writes calibration.csv as pandas does and draws its three figures."""
    out, _ = experiment
    read = lambda n: pd.read_csv(os.path.join(out, f"{n}.csv"),
                                 float_precision="round_trip")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_mcmc_figures", os.path.join(ROOT, "experiments",
                                         "mcmc_figures.py"))
    jfig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfig)
    want = jfig.make_calibration_table(read("truth"), read("vi"), read("mc"),
                                       os.path.join(out, "jax_cal.csv"))
    want_scores = jfig.make_error_comparison(
        read("truth"), read("vi"), read("mc"),
        os.path.join(out, "jax_errors.png"))
    want_auc = jfig.make_roc(read("truth"), read("vi"), read("mc"),
                             os.path.join(out, "jax_roc.png"))
    got = mcmc_figures.main(["--results-dir", out])
    _assert_table_equals_frame(got["calibration"], want)
    _assert_table_equals_frame(got["scores"], want_scores)
    assert list(got["auc"]) == list(want_auc) == ["VI", "MCMC"]
    np.testing.assert_allclose(list(got["auc"].values()),
                               list(want_auc.values()), rtol=1e-12, atol=0.0)
    with open(os.path.join(out, "calibration.csv")) as a, \
            open(os.path.join(out, "jax_cal.csv")) as b:
        assert a.read() == b.read()
    assert got["drew"]
    for name in mcmc_figures.FIGURES:
        assert os.path.getsize(os.path.join(out, name)) > 0
