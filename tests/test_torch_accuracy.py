"""The port's accuracy scoring (benchmark/accuracy.py, pandas-free) against
the JAX package's pandas version on the same numpy inputs: every column of
every table to 1e-12, the CSV files byte for byte, the coadd loader on a
FITS file written here, and the primary loader on the SDSS fixture."""

import numpy as np
import pandas as pd
import pytest
import torch

from celeste_jl_tpu.benchmark import accuracy as jab
from celeste_jl_tpu.io.sdss import SDSSDataSet as JaxSDSS
from celeste_jl_tpu.models.priors import prior as jax_prior
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.benchmark import accuracy as ab
from celeste_jl_tpu_torch.io.fits import write_fits
from celeste_jl_tpu_torch.io.sdss import RunCamcolField, SDSSDataSet
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.models.priors import prior
from celeste_jl_tpu_torch.parallel.state import OptimizedSource
from sdss_fixtures import make_sdss_field

torch.set_num_threads(1)

TOL = 1e-12


def assert_table_matches(got, want):
    """A Table against a pandas DataFrame: the same columns in the same
    order, text equal, numbers within 1e-12 with NaN where pandas has it."""
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        w = want[c].to_numpy()
        if w.dtype.kind in "OUS" or str(want[c].dtype) in ("str", "string"):
            assert [str(v) for v in got[c]] == [str(v) for v in w], c
        else:
            np.testing.assert_allclose(np.asarray(got[c], float),
                                       np.asarray(w, float), rtol=TOL,
                                       atol=TOL, equal_nan=True, err_msg=c)


def _catalog(seed, n=12):
    """Prior draws (the JAX package's), spread over a 0.02-degree box."""
    cat = jab.generate_catalog_from_prior(n, extent=0.02, margin=0.002,
                                          seed=seed)
    return cat, convert.catalog(cat)


def _results(cat, seed, jitter=3e-5):
    """OptimizedSources near the entries: the entries' catalog init with
    positions moved by up to `jitter` degrees and every other field
    perturbed; one bad-sky row."""
    from celeste_jl_tpu.vi.init import catalog_init_source

    rng = np.random.default_rng(seed)
    out = []
    for i, ce in enumerate(cat):
        vs = np.asarray(catalog_init_source(ce), np.float64).copy()
        vs[ids.pos] += rng.uniform(-jitter, jitter, 2)
        p = rng.uniform(0.05, 0.95)
        vs[ids.is_star] = [p, 1 - p]
        vs[ids.flux_loc] += rng.normal(0, 0.1, 2)
        vs[ids.color_mean.ravel()] += rng.normal(0, 0.1, 8)
        vs[ids.gal_axis_ratio] = rng.uniform(0.2, 1.0)
        vs[ids.gal_angle] = rng.uniform(-4, 4)
        out.append(OptimizedSource(init_pos=np.asarray(ce.pos), vs=vs,
                                   elbo=-1.0, converged=True,
                                   is_sky_bad=(i == 3)))
    return out


def test_helpers_match_jax():
    rng = np.random.default_rng(0)
    flux = np.concatenate([rng.lognormal(1, 2, 50), [0.0, -1.0, 1e-12]])
    mags = rng.uniform(12, 26, 50)
    for b in range(5):
        np.testing.assert_allclose(ab.mag_to_flux(mags, b),
                                   jab.mag_to_flux(mags, b), rtol=TOL)
        np.testing.assert_allclose(ab.flux_to_mag(flux, b),
                                   jab.flux_to_mag(flux, b), rtol=TOL,
                                   equal_nan=True)
        np.testing.assert_allclose(
            ab.color_from_mags(mags, b, mags[::-1], 4 - b),
            jab.color_from_mags(mags, b, mags[::-1], 4 - b), rtol=TOL)
    np.testing.assert_array_equal(ab.color_from_fluxes(flux, flux[::-1]),
                                  jab.color_from_fluxes(flux, flux[::-1]))
    ang = rng.uniform(-720, 720, 50)
    np.testing.assert_array_equal(ab.canonical_angle(ang),
                                  jab.canonical_angle(ang))
    np.testing.assert_array_equal(ab.degrees_to_diff(ang, ang[::-1]),
                                  jab.degrees_to_diff(ang, ang[::-1]))
    colors = rng.normal(0, 1, 4)
    np.testing.assert_array_equal(ab.fluxes_from_colors(7.0, colors),
                                  jab.fluxes_from_colors(7.0, colors))


def test_catalog_tables_and_prior_draws_match_jax():
    """generate_catalog_from_prior/draw_source_params take the same draws;
    catalog_entries_to_df, variational_params_to_row and celeste_to_df
    give JAX's rows (the bad-sky row dropped)."""
    np.testing.assert_array_equal(prior.color_cov, jax_prior.color_cov)
    jcat, cat = _catalog(seed=5)
    mine = ab.generate_catalog_from_prior(12, extent=0.02, margin=0.002,
                                          seed=5)
    for a, b in zip(mine, cat):
        assert all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    assert_table_matches(ab.catalog_entries_to_df(cat),
                         jab.catalog_entries_to_df(jcat))
    res = _results(jcat, seed=6)
    got, want = ab.celeste_to_df(res), jab.celeste_to_df(res)
    assert len(got) == len(res) - 1
    assert_table_matches(got, want)
    row, jrow = ab.variational_params_to_row(res[0].vs), \
        jab.variational_params_to_row(res[0].vs)
    assert list(row) == list(jrow)
    for k in row:
        np.testing.assert_allclose(row[k], jrow[k], rtol=TOL)
    assert len(ab.celeste_to_df([])) == len(jab.celeste_to_df([])) == 0


def _tables(seed):
    jcat, cat = _catalog(seed)
    truth = ab.catalog_entries_to_df(cat)
    jtruth = jab.catalog_entries_to_df(jcat)
    # the second prediction's positions straddle the 1.1e-4-degree match
    # radius
    preds = [_results(jcat, seed + 10), _results(jcat, seed + 20,
                                                 jitter=1.5e-4)]
    return (truth, [ab.celeste_to_df(p) for p in preds], jtruth,
            [jab.celeste_to_df(p) for p in preds])


@pytest.mark.parametrize("n_pred", [1, 2])
def test_matching_and_scores_match_jax(n_pred):
    """match_catalogs, get_error_df, filter_rows, get_scores_df and
    score_predictions (one prediction, and two with the diff columns) on
    predictions whose positions sit inside and outside the match radius."""
    truth, preds, jtruth, jpreds = _tables(seed=1)
    preds, jpreds = preds[:n_pred], jpreds[:n_pred]
    mt, mp = ab.match_catalogs(truth, preds)
    jmt, jmp = jab.match_catalogs(jtruth, jpreds)
    assert 0 < len(mt) < len(truth) or n_pred == 1
    assert_table_matches(mt, jmt)
    for a, b in zip(mp, jmp):
        assert_table_matches(a, b)
    errs = [ab.get_error_df(mt, p) for p in mp]
    jerrs = [jab.get_error_df(jmt, p) for p in jmp]
    for a, b in zip(errs, jerrs):
        assert_table_matches(a, b)
    for c in errs[0].columns:
        np.testing.assert_array_equal(ab.filter_rows(mt, errs[0], c),
                                      jab.filter_rows(jmt, jerrs[0], c))
    assert_table_matches(ab.score_predictions(truth, preds),
                         jab.score_predictions(jtruth, jpreds))


@pytest.mark.parametrize("aligned", [False, True])
def test_uncertainty_scores_match_jax(aligned):
    truth, (pred, _), jtruth, (jpred, _) = _tables(seed=2)
    if aligned:   # the bad-sky row dropped from both
        keep = np.arange(len(truth)) != 3
        truth, jtruth = truth[keep], jtruth[keep].reset_index(drop=True)
    got = ab.get_uncertainty_df(truth, pred, aligned=aligned)
    want = jab.get_uncertainty_df(jtruth, jpred, aligned=aligned)
    assert_table_matches(got, want)
    assert_table_matches(ab.score_uncertainty(got),
                         jab.score_uncertainty(want))


def test_catalog_csv_round_trip_matches_pandas(tmp_path):
    """write_catalog writes the file pandas writes; read_catalog reads
    pandas' file as pandas does; an incomplete table is refused."""
    truth, (pred, _), jtruth, (jpred, _) = _tables(seed=3)
    pred.insert(0, "objid", [f"s{i:03d}" for i in range(len(pred))])
    jpred.insert(0, "objid", [f"s{i:03d}" for i in range(len(jpred))])
    ab.write_catalog(tmp_path / "port.csv", pred)
    jab.write_catalog(tmp_path / "jax.csv", jpred)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert_table_matches(ab.read_catalog(tmp_path / "jax.csv"),
                         jab.read_catalog(tmp_path / "jax.csv"))
    with pytest.raises(ValueError, match="missing columns"):
        ab.write_catalog(tmp_path / "bad.csv", pred[["objid", "ra"]])
    # the scores table, with its integer column, round-trips as pandas does
    ab.score_predictions(truth, [pred]).to_csv(tmp_path / "s.csv")
    assert_table_matches(ab.read_csv(tmp_path / "s.csv"),
                         pd.read_csv(tmp_path / "s.csv"))


def test_load_coadd_catalog_matches_jax(tmp_path):
    """A CasJobs-style Stripe 82 table written here: stars, dev and exp
    galaxies, a saturated row and a known-bad objid, both dropped."""
    rng = np.random.default_rng(4)
    n = 9
    cols = {"objid": np.array([8647474692482203000 + i for i in range(n)]
                              + [], dtype=np.int64),
            "ra": rng.uniform(0, 1, n), "dec": rng.uniform(-1, 1, n),
            "probpsf": np.array([1, 0, 0, 1, 0, 0, 1, 0, 0], np.int32),
            "fracdev_r": rng.uniform(0, 1, n),
            "is_saturated": np.array([0, 0, 0, 0, 1, 0, 0, 0, 0], np.int32)}
    cols["objid"][5] = int(sorted(ab.BAD_COADD_OBJID)[0])
    for kind in ("psf", "dev", "exp"):
        for c in "ugriz":
            cols[f"{kind}mag_{c}"] = rng.uniform(17, 23, n)
    for f in ("ab", "rad", "phi"):
        for kind in ("dev", "exp"):
            hi = {"ab": 1.0, "rad": 5.0, "phi": 400.0}[f]
            cols[f"{kind}{f}_r"] = rng.uniform(0.1, hi, n)
    path = str(tmp_path / "coadd.fit")
    write_fits(path, [(None, []), (cols, [])])
    got, want = ab.load_coadd_catalog(path), jab.load_coadd_catalog(path)
    assert len(got) == n - 2
    assert_table_matches(got, want)


def test_load_primary_matches_jax(tmp_path):
    rcf, _, _ = make_sdss_field(tmp_path)
    got = ab.load_primary(SDSSDataSet(tmp_path, device="cpu"),
                          RunCamcolField(rcf.run, rcf.camcol, rcf.field))
    want = jab.load_primary(JaxSDSS(tmp_path), rcf)
    assert len(got) > 0
    assert_table_matches(got, want)
