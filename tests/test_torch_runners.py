"""The port's runners against the JAX package's, on the CPU:

- benchmark/bench_elbo.py: its evaluators at S = 4 on 16 x 16 tiles, f64,
  against JAX's elbo, value_and_grad through the render and
  _analytic_lik_hessian (plus the port's KL Hessian), to 1e-10 relative;
  then the
  runner's JSON lines at S = 2;
- benchmark/calibration.py: its aggregation on fixed tables against a
  pandas computation of run_calibration.py's formulas (1e-12); then the
  runner on one noisy scene at one seed, its tables against the same
  computation, per seed (the JAX package's get_uncertainty_df,
  get_error_df and get_scores_df and the seed column), on the scene's
  truth and estimates;
- benchmark/svi_compare.py: its field equals run_svi_compare.py's (the
  JAX package's sample_star, sample_galaxy and gen_images_fast) bit for
  bit; both runners, their fitters replaced by one fixed result a
  detection, print the same rows (the detections, the score against the
  truth and the mean ELBO, rounded as both round them); then the port's
  rows from its real fitters on a 4-source field;
- results_to_fits.py: the columns and values of JAX's
  tools/results_to_fits.py on the same .npz files (1e-12). JAX's color
  columns are object columns of 0-d arrays in pandas, which its tool
  writes as text ("0.0"); the port writes them as numbers, so those are
  compared as numbers.
"""

import importlib.util
import json
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import torch
from torch.func import hessian, vmap

from __graft_entry__ import _synthetic_batch
from celeste_jl_tpu.benchmark import accuracy as jab
from celeste_jl_tpu import synthetic as jsyn
from celeste_jl_tpu.ops import bijectors as jb
from celeste_jl_tpu.parallel import run as jrun
from celeste_jl_tpu.utils import config as jconfig
from celeste_jl_tpu.vi import optimize as jo
from celeste_jl_tpu.vi.elbo import elbo as jax_elbo
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.benchmark import (accuracy, bench_elbo,
                                            calibration, svi_compare)
from celeste_jl_tpu_torch.io.fits import open_fits
from celeste_jl_tpu_torch.io.dataset import BoundingBox
from celeste_jl_tpu_torch.main import save_results
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.ops import bijectors as tb
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel.state import OptimizedSource
from celeste_jl_tpu_torch.results_to_fits import results_to_fits
from celeste_jl_tpu_torch.vi.elbo import subtract_kl
from celeste_jl_tpu_torch.vi.init import generic_init_source
from celeste_jl_tpu_torch.vi.optimize import _make_bounds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SHORT_NEWTON = NewtonConfig(max_iters=1, hess_every=2)
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _close(got, want, rtol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1.0),
                               err_msg=name)


def _jax_module(path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_elbo_evaluators_match_jax():
    vp0s, patches = _synthetic_batch(n_sources=4, tile=16, seed=0)
    vp = np.asarray(vp0s, np.float64)
    jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64))
                      if np.asarray(x).dtype.kind == "f" else jnp.asarray(x),
                      patches)
    t = torch.tensor(vp)
    got = {k: fn() for k, fn in bench_elbo.evaluators(
        t, convert.sky_patch(patches, "cpu", F64)).items()}

    def one(v, p):
        b = jo._make_bounds(v[0:2])
        fr = jb.to_free(jb.enforce(v, b), b)
        neg = lambda x: -jax_elbo(jb.to_bound(x, b), p)
        f, g = jax.value_and_grad(neg)(fr)
        return (jax_elbo(v, p), f, g,
                -jo._analytic_lik_hessian(fr, b, p, None, None))

    e, f, g, H = jax.jit(jax.vmap(one))(jnp.asarray(vp), jp)
    # the KL Hessian, the port's own (the KL is held to JAX's in
    # test_torch_elbo.py), added to JAX's likelihood Hessian
    bounds = _make_bounds(t[:, 0:2])
    free = tb.to_free(tb.enforce(t, bounds), bounds)
    kl = lambda fr, lo, up, sc: subtract_kl(tb.to_bound(
        fr, tb.BoxBounds(lo, up, sc)))
    H = np.asarray(H) - vmap(hessian(kl))(free, *bounds).numpy()
    _close(got["elbo_evals_per_sec"], e, 1e-10, "elbo")
    for key in ("fg_evals_per_sec", "fg_analytic_evals_per_sec"):
        _close(got[key][0], f, 1e-10, f"{key} f")
        _close(got[key][1], g, 1e-10, f"{key} g")
    for name, a, b in zip("fgH", got["fgh_evals_per_sec"], (f, g, H)):
        _close(a, b, 1e-10, f"fgh {name}")


def test_bench_elbo_runner_prints_its_metrics(monkeypatch, capsys):
    for k, v in (("BENCH_ELBO_SOURCES", "2"), ("BENCH_ELBO_TILE", "16"),
                 ("BENCH_ELBO_REPEATS", "1")):
        monkeypatch.setenv(k, v)
    lines = bench_elbo.main([], device="cpu", dtype=F64,
                            newton_config=SHORT_NEWTON)
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [l["metric"] for l in lines] == [
        "elbo_evals_per_sec", "fg_evals_per_sec",
        "fg_analytic_evals_per_sec", "fgh_evals_per_sec",
        "single_fit_latency_ms"]
    assert all(np.isfinite(l["value"]) and l["value"] > 0 for l in lines)
    assert lines[1]["fg_analytic_evals_per_sec"] == lines[2]["value"]
    assert all(l["card"] == "cpu" for l in lines)


def _calibration_tables(rng):
    """Two seeds' uncertainty and field-score tables, as the port's Table
    and as pandas frames, with a NaN error and a zero std."""
    unc, scores, unc_pd, scores_pd = [], [], [], []
    names = ["log_flux_r_nmgy", "color_ug", "color_gr"]
    for seed in (1234, 9153):
        n = 7
        t = {"name": np.array([names[i % 3] for i in range(n)], object),
             "error": rng.normal(size=n),
             "posterior_std_err": rng.uniform(0.1, 2.0, n)}
        t["error"][2] = np.nan
        t["posterior_std_err"][4] = 0.0
        s = {"field": np.array(["position", "flux_r_mag", "color_ug"][
            :2 + (seed > 2000)], object)}
        s["N"] = rng.integers(2, 9, len(s["field"]))
        s["first"] = rng.uniform(0, 1, len(s["field"]))
        tab, stab = accuracy.Table(t), accuracy.Table(s)
        tab["seed"] = seed
        stab["seed"] = seed
        unc.append(tab)
        scores.append(stab)
        unc_pd.append(pd.DataFrame(t).assign(seed=seed))
        scores_pd.append(pd.DataFrame(s).assign(seed=seed))
    return unc, scores, unc_pd, scores_pd


def _equal(table, frame, rtol=1e-12):
    assert table.columns == list(frame.columns)
    for c in frame.columns:
        if table[c].dtype == object:
            assert list(table[c]) == list(frame[c]), c
        else:
            np.testing.assert_allclose(table[c].astype(float),
                                       frame[c].to_numpy(float), rtol=rtol,
                                       err_msg=c)


def _jax_aggregate(unc_pd, scores_pd):
    """run_calibration.py's tables in pandas (its main, lines 63-84) from
    each seed's uncertainty and field-score frames."""
    all_unc = pd.concat(unc_pd, ignore_index=True)
    want_cal = jab.score_uncertainty(all_unc)
    want_cal["N"] = [int((all_unc["name"] == f).sum())
                     for f in want_cal["field"]]
    qs = []
    for f, g in all_unc.groupby("name"):
        z = np.abs(g["error"].to_numpy() / g["posterior_std_err"].to_numpy())
        z = z[np.isfinite(z)]
        qs.append({"field": f, "z_median": float(np.median(z)),
                   "z_p90": float(np.quantile(z, 0.9)),
                   "z_max": float(z.max())})
    want_scores = pd.concat(scores_pd, ignore_index=True).groupby(
        "field", as_index=False).agg(N=("N", "sum"),
                                     mean_err=("first", "mean"))
    return want_cal, pd.DataFrame(qs), want_scores


def test_calibration_aggregation_matches_pandas():
    unc, scores, unc_pd, scores_pd = _calibration_tables(
        np.random.default_rng(2))
    got = calibration.aggregate(unc, scores)
    for table, frame in zip(got, _jax_aggregate(unc_pd, scores_pd)):
        _equal(table, frame)


def _frame(table):
    return pd.DataFrame({c: table[c] for c in table.columns})


def _records_equal(records, frame, rtol=1e-12):
    assert [list(r) for r in records] == [list(frame.columns)] * len(frame)
    for c in frame.columns:
        got = [r[c] for r in records]
        if not pd.api.types.is_numeric_dtype(frame[c]):
            assert got == list(frame[c]), c
        else:
            np.testing.assert_allclose(np.asarray(got, np.float64),
                                       frame[c].to_numpy(float), rtol=rtol,
                                       err_msg=c)


def test_calibration_runner_on_one_scene(monkeypatch, tmp_path, capsys):
    """The runner's tables equal run_calibration.py's per-seed pipeline
    and aggregation in pandas on the truth and estimates the scene's
    run returned."""
    monkeypatch.setenv("CAL_SEEDS", "1")
    runs = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        runs.append((kwargs["seed"], *out))
        return out

    real = calibration.run_benchmarks
    monkeypatch.setattr(calibration, "run_benchmarks", spy)
    record = calibration.main(["--scenes", "overlapping_stars", "--out",
                               str(tmp_path)], device="cpu",
                              newton_config=SHORT_NEWTON)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == record
    assert record["sources"] == [2] and record["seeds"] == 1
    assert [seed for seed, _, _ in runs] == calibration.seeds(1) == [1234]
    unc_pd, scores_pd = [], []
    for seed, truth, pred in runs:
        truth, pred = _frame(truth), _frame(pred)
        unc = jab.get_uncertainty_df(truth, pred, aligned=True)
        unc["seed"] = seed
        unc_pd.append(unc)
        err = jab.get_error_df(truth, pred)
        scores_pd.append(jab.get_scores_df(truth, err).assign(seed=seed))
    want_cal, want_zq, want_scores = _jax_aggregate(unc_pd, scores_pd)
    _records_equal(record["calibration"], want_cal)
    _records_equal(record["z_quantiles"], want_zq)
    _records_equal(record["mean_errors"], want_scores)
    assert sorted(want_cal["field"]) == sorted([
        "log_flux_r_nmgy", "color_ug", "color_gr", "color_ri", "color_iz"])
    assert all(r["N"] == 2 for r in record["calibration"])
    assert (tmp_path / "calibration_results.md").exists()


def _jax_svi_field(n_sources, size, seed):
    """run_svi_compare.py's field (its main, lines 52-68), through the JAX
    package."""
    margin = 16.0
    rng = np.random.default_rng(seed)
    truth, n_star = [], n_sources // 2
    pos = margin + rng.random((n_sources, 2)) * (size - 2 * margin)
    for i in range(n_sources):
        p = tuple(pos[i])
        if i < n_star:
            truth.append(jsyn.sample_star(pos=p, r_flux=float(
                np.exp(rng.normal(3.0, 0.6)))))
        else:
            truth.append(jsyn.sample_galaxy(
                pos=p, r_flux=float(np.exp(rng.normal(3.2, 0.5))),
                gal_radius_px=float(np.exp(rng.normal(0.7, 0.3))),
                gal_axis_ratio=float(rng.uniform(0.25, 0.9)),
                gal_angle=float(rng.uniform(0.0, np.pi))))
    images = jsyn.make_blank_images(H=size, W=size, sky_nmgy=0.05,
                                    nelec_per_nmgy=800.0)
    jsyn.gen_images_fast(images, truth, seed=seed)
    return truth, images


SVI_FIELD = dict(n_sources=6, size=64, seed=7)


def test_svi_field_matches_jax():
    truth, images = svi_compare.svi_field(device=torch.device("cpu"),
                                          **SVI_FIELD)
    jtruth, jimages = _jax_svi_field(**SVI_FIELD)
    assert len(truth) == len(jtruth) == SVI_FIELD["n_sources"]
    for a, b in zip(truth, jtruth):
        for f in ("pos", "is_star", "star_fluxes", "gal_fluxes",
                  "gal_frac_dev", "gal_axis_ratio", "gal_angle",
                  "gal_radius_px"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for img, jimg in zip(images, jimages):
        np.testing.assert_array_equal(img.pixels, jimg.pixels)


def _fixed_fits(catalog, images, **kwargs):
    """One fixed result a detection, from its position and order: P(star)
    and the fluxes vary by source, so the score's branches all run."""
    out = []
    for i, ce in enumerate(catalog):
        pos = np.asarray(ce.pos, np.float64)
        vs = np.asarray(generic_init_source(pos), np.float64).copy()
        vs[ids.is_star[0]] = (0.9, 0.2, 0.6)[i % 3]
        vs[ids.is_star[1]] = 1.0 - vs[ids.is_star[0]]
        for j in (0, 1):
            vs[ids.flux_loc[j]] = 2.5 + 0.1 * i + 0.3 * j
            vs[ids.flux_scale[j]] = 0.01 * (1 + i)
        out.append(SimpleNamespace(init_pos=pos, vs=vs,
                                   elbo=-1000.0 - 7.0 * i - float(pos[0])))
    return out


def test_svi_compare_rows_match_jax_runner(monkeypatch, tmp_path, capsys):
    """run_svi_compare.py's main (a copy, so its svi_results.md goes to
    tmp_path) and the port's on the same small field, each runner's
    fitters replaced by _fixed_fits: the same rows, but the walls."""
    env = {"SVI_SOURCES": str(SVI_FIELD["n_sources"]),
           "SVI_SIZE": str(SVI_FIELD["size"]),
           "SVI_SEED": str(SVI_FIELD["seed"]), "SVI_STEPS": "3",
           "SVI_REPEAT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(jconfig, "enable_compile_cache", lambda: None)
    for mod in (jrun, svi_compare):
        monkeypatch.setattr(mod, "one_node_single_infer", _fixed_fits)
        monkeypatch.setattr(mod, "one_node_svi_infer", _fixed_fits)
    (tmp_path / "benchmark").mkdir()
    script = tmp_path / "benchmark" / "run_svi_compare.py"
    shutil.copy(os.path.join(ROOT, "benchmark", "run_svi_compare.py"),
                script)
    _jax_module(str(script), "jax_run_svi_compare").main()
    want = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    got = svi_compare.main([], device="cpu", dtype=F64)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("wall_s", "sources_per_sec"):
            w.pop(k)
        assert {k: g[k] for k in w} == w
    assert want[0]["sources"] >= 4 and want[0]["n_matched"] >= 4
    assert 0.0 < want[0]["type_accuracy"] < 1.0


def test_svi_compare_runner_rows(monkeypatch, tmp_path, capsys):
    for k, v in (("SVI_SOURCES", "4"), ("SVI_SIZE", "64"), ("SVI_STEPS", "3"),
                 ("SVI_REPEAT", "1")):
        monkeypatch.setenv(k, v)
    rows = svi_compare.main(["--out", str(tmp_path)], device="cpu",
                            dtype=F64, newton_config=SHORT_NEWTON)
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert printed == rows
    assert [(r["method"], r["pixel_fraction"]) for r in rows] == [
        ("single_vi", None), ("svi", 1.0), ("svi", 0.5), ("svi", 0.25)]
    for r in rows:
        assert r["sources"] >= 3 and r["n_matched"] >= 3
        assert np.isfinite(r["mean_elbo"]) and r["backend"] == "cpu"
    assert (tmp_path / "svi_results.md").exists()


def test_results_to_fits_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for k in range(2):
        results = []
        for i in range(3 + k):
            pos = rng.uniform(0.0, 1.0, 2)
            vs = generic_init_source(pos)
            vs[26] = rng.uniform(0.05, 0.95)
            vs[27] = 1.0 - vs[26]
            vs[2:6] = (rng.uniform(0.1, 0.9), rng.uniform(0.3, 0.9),
                       rng.uniform(0.0, np.pi), rng.uniform(0.8, 3.0))
            results.append(OptimizedSource(
                init_pos=pos, vs=vs, elbo=float(rng.normal(-1e3, 10)),
                converged=bool(i % 2), is_sky_bad=(k == 1 and i == 0)))
        box = BoundingBox(0.1 * k, 0.1 * k + 0.1, 0.0, 0.1)
        paths.append(save_results(str(tmp_path / "out"), box, results))
    jtool = _jax_module(os.path.join("tools", "results_to_fits.py"),
                        "jax_results_to_fits")
    n_jax = jtool.results_to_fits(paths, str(tmp_path / "jax.fits"))
    n = results_to_fits(paths, str(tmp_path / "port.fits"))
    assert n == n_jax == 6
    got = open_fits(str(tmp_path / "port.fits"))
    want = open_fits(str(tmp_path / "jax.fits"))
    assert got[0].header["NSRC"] == want[0].header["NSRC"] == 6
    gd, wd = got[1].data, want[1].data
    assert list(gd) == list(wd)
    for c in wd:
        a, b = np.asarray(gd[c]), np.asarray(wd[c])
        if c.startswith("color_") and b.dtype.kind == "U":
            b = b.astype(np.float64)
        assert a.dtype == b.dtype, c
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
