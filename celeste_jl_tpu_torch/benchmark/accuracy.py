"""Catalog schema, conversions and scoring (the port's copy of
celeste_jl_tpu/benchmark/accuracy.py; AccuracyBenchmark.jl rebuilt).

The JAX package's tables are pandas DataFrames; the card's machine has no
pandas, so the tables here are `Table`s: an ordered dict of numpy columns
with row selection and concatenation. Every function keeps its JAX name
(`*_df`), its column names and its numbers. The catalog CSV schema
matches the reference's CATALOG_COLUMNS (AccuracyBenchmark.jl:40-66) so
scores are comparable, and the CSV files are the ones pandas writes.
"""

import csv

import numpy as np

from ..models.image import CatalogEntry
from ..models.params import ids
from ..utils.coordinates import angular_separation, match_coordinates

CATALOG_COLUMNS = {
    "ra", "dec", "is_star", "flux_r_nmgy", "color_ug", "color_gr",
    "color_ri", "color_iz", "gal_frac_dev", "gal_axis_ratio",
    "gal_radius_px", "gal_angle_deg",
}
STDERR_COLUMNS = {
    "log_flux_r_stderr", "color_ug_stderr", "color_gr_stderr",
    "color_ri_stderr", "color_iz_stderr",
}
COLOR_COLUMNS = ["color_ug", "color_gr", "color_ri", "color_iz"]
ABSOLUTE_ERROR_COLUMNS = (["gal_frac_dev", "gal_axis_ratio",
                           "gal_radius_px"] + COLOR_COLUMNS)

ARCSEC_PER_DEGREE = 3600.0
SDSS_ARCSEC_PER_PIXEL = 0.396

# SDSS asinh magnitude softening parameters, bands ugriz
# (AccuracyBenchmark.jl:131-137)
ASINH_SOFTENING = np.array([1.4e-10, 0.9e-10, 1.2e-10, 1.8e-10, 7.4e-10])


# -----------------------------------------------------------------------------
# The column table


def _column(values, n=None):
    """A 1-D numpy column: numbers as float64/int64/bool, text as str."""
    if np.ndim(values) == 0:
        values = [values] * (n if n is not None else 1)
    a = np.asarray(values)
    if a.dtype.kind in "US":
        return a.astype(object)
    if a.dtype == object:
        if all(isinstance(v, str) for v in a):
            return a
        return a.astype(np.float64)
    return a


class Table:
    """An ordered dict of equal-length numpy columns (the slice of a pandas
    DataFrame that the scoring uses). t["col"] is a column; t[mask] and
    t[index array] are the selected rows, renumbered from 0."""

    def __init__(self, columns=None):
        self._cols = {}
        for k, v in (columns or {}).items():
            self[k] = v

    @classmethod
    def from_rows(cls, rows):
        """Rows (dicts) -> a Table; the columns in the order first seen, a
        key missing from a row NaN (pandas.DataFrame(rows))."""
        rows = list(rows)
        names = list(dict.fromkeys(k for r in rows for k in r))
        return cls({k: _column([r.get(k, np.nan) for r in rows])
                    for k in names})

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name):
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list) and key and isinstance(key[0], str):
            return Table({k: self._cols[k] for k in key})
        return self.take(key)

    def __setitem__(self, name, values):
        col = _column(values, len(self) if self._cols else None)
        if self._cols and len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = col

    def take(self, rows):
        """The rows selected by a boolean mask or an index array."""
        rows = np.asarray(rows)
        if rows.dtype != bool:
            rows = rows.astype(np.int64)
        return Table({k: v[rows] for k, v in self._cols.items()})

    def insert(self, loc, name, values):
        """Add a column at position loc (pandas DataFrame.insert); a
        scalar fills every row."""
        n = len(self) if self._cols else None
        items = list(self._cols.items())
        self._cols = {}
        for k, v in items[:loc]:
            self._cols[k] = v
        self._cols[name] = _column(values, n)
        for k, v in items[loc:]:
            self._cols[k] = v

    def groupby(self, name):
        """[(key, the rows with that key)] in sorted key order, as pandas'
        groupby(name) iterates."""
        col = self._cols[name]
        return [(k, self.take(col == k)) for k in sorted(set(col.tolist()))]

    def copy(self):
        return Table({k: v.copy() for k, v in self._cols.items()})

    def row(self, i):
        return {k: v[i] for k, v in self._cols.items()}

    def rows(self):
        return [self.row(i) for i in range(len(self))]

    def to_csv(self, path):
        """The CSV file pandas' to_csv(index=False) writes: the shortest
        repr of each float, NaN as an empty field."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            for i in range(len(self)):
                w.writerow([_csv_text(v[i]) for v in self._cols.values()])

    def to_markdown(self, floatfmt=None):
        """A GitHub markdown table (numbers right-aligned)."""
        def text(v):
            if isinstance(v, (str, np.str_)):
                return str(v)
            if isinstance(v, (bool, np.bool_)):
                return str(bool(v))
            if isinstance(v, (int, np.integer)):
                return str(int(v))
            if np.isnan(v):
                return "nan"
            return format(float(v), floatfmt) if floatfmt else f"{v:g}"

        cells = [[text(v[i]) for v in self._cols.values()]
                 for i in range(len(self))]
        widths = [max([len(c)] + [len(r[j]) for r in cells])
                  for j, c in enumerate(self.columns)]
        numeric = [v.dtype.kind in "fiub" for v in self._cols.values()]
        pad = lambda s, w, right: s.rjust(w) if right else s.ljust(w)
        lines = ["| " + " | ".join(pad(c, w, r) for c, w, r in
                                   zip(self.columns, widths, numeric)) + " |",
                 "|" + "|".join("-" * (w + 1) + ":" if r
                                else ":" + "-" * (w + 1)
                                for w, r in zip(widths, numeric)) + "|"]
        lines += ["| " + " | ".join(pad(c, w, r) for c, w, r in
                                    zip(row, widths, numeric)) + " |"
                  for row in cells]
        return "\n".join(lines)


def _csv_text(v):
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def _parse_csv_column(texts):
    """A CSV column's strings -> int64, bool, float64 (empty = NaN) or
    str, the type pandas' read_csv infers."""
    full = [t for t in texts if t != ""]
    if full and len(full) == len(texts):
        try:
            return np.array([int(t) for t in texts], dtype=np.int64)
        except ValueError:
            pass
        if all(t in ("True", "False") for t in texts):
            return np.array([t == "True" for t in texts])
    try:
        return np.array([float(t) if t != "" else np.nan for t in texts],
                        dtype=np.float64)
    except ValueError:
        return np.array(texts, dtype=object)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    names, body = rows[0], rows[1:]
    return Table({n: _parse_csv_column([r[j] for r in body])
                  for j, n in enumerate(names)})


def concat(tables):
    """Rows of several tables, renumbered (pandas.concat(...,
    ignore_index=True)); a column missing from a table is NaN there."""
    tables = [t for t in tables]
    names = list(dict.fromkeys(c for t in tables for c in t.columns))
    out = {}
    for n in names:
        parts = [t[n] if n in t else np.full(len(t), np.nan)
                 for t in tables]
        out[n] = (np.concatenate(parts) if parts
                  else np.zeros(0, dtype=np.float64))
    return Table(out)


# -----------------------------------------------------------------------------
# Magnitudes, fluxes, colors, angles


def mag_to_flux(mags, band_index):
    b = ASINH_SOFTENING[band_index]
    return 1e9 * 2 * b * np.sinh(-np.log(10) / 2.5 * np.asarray(mags)
                                 - np.log(b))


def flux_to_mag(flux_nmgy, band_index):
    b = ASINH_SOFTENING[band_index]
    return -2.5 / np.log(10) * (np.arcsinh(np.asarray(flux_nmgy) * 1e-9
                                           / (2 * b)) + np.log(b))


def color_from_fluxes(flux1, flux2):
    flux1, flux2 = np.asarray(flux1, float), np.asarray(flux2, float)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log(flux2 / flux1)
    return np.where((flux1 > 0) & (flux2 > 0), out, np.nan)


def canonical_angle(gal_angle_deg):
    a = np.asarray(gal_angle_deg, float)
    return a - np.floor(a / 180.0) * 180.0


def degrees_to_diff(a, b):
    d = np.abs(np.asarray(a, float) - np.asarray(b, float)) % 180.0
    return np.minimum(d, 180.0 - d)


def fluxes_from_colors(flux_r_nmgy, colors):
    """(AccuracyBenchmark.jl:325-336)"""
    r = np.exp(np.asarray(colors, float))
    f = np.zeros(5)
    f[2] = flux_r_nmgy
    f[3] = f[2] * r[2]
    f[4] = f[3] * r[3]
    f[1] = f[2] / r[1]
    f[0] = f[1] / r[0]
    return f


def assert_columns_are_present(df, required):
    missing = set(required) - set(df.columns)
    if missing:
        raise ValueError(f"missing columns: {sorted(missing)}")


def read_catalog(csv_file):
    df = read_csv(csv_file)
    assert_columns_are_present(df, CATALOG_COLUMNS)
    return df


def write_catalog(filename, df):
    assert_columns_are_present(df, CATALOG_COLUMNS)
    df.to_csv(filename)


# -----------------------------------------------------------------------------
# Real-survey ground-truth loaders (AccuracyBenchmark.jl:164-335)

GALAXY_ONLY_COLUMNS = ["gal_frac_dev", "gal_axis_ratio", "gal_radius_px",
                       "gal_angle_deg"]

# known-bad Stripe 82 coadd objects excluded from scoring
# (AccuracyBenchmark.jl:63-78: blends, bright neighbors, quasars)
BAD_COADD_OBJID = {
    "8647474692482203853", "8647474692482203816",
    "8647474692482204612", "8647474692482204147",
}


def color_from_mags(mags1, band1, mags2, band2):
    return color_from_fluxes(mag_to_flux(mags1, band1),
                             mag_to_flux(mags2, band2))


def _objid_text(values):
    a = np.asarray(values)
    if a.dtype.kind == "S":
        a = np.char.decode(a, "ascii")
    return a.astype(str).astype(object)


def load_coadd_catalog(fits_filename):
    """Stripe 82 coadd ground truth -> catalog Table
    (AccuracyBenchmark.jl:198-263). `fits_filename` is a CasJobs Stripe82
    query result (e.g. the reference's test/data/coadd_for_*.fit fixtures,
    which round-trip through io/fits.py)."""
    from ..io.fits import open_fits

    tbl = open_fits(fits_filename)[1].data
    col = {k: np.asarray(v) for k, v in tbl.items()}

    usedev = col["fracdev_r"] > 0.5

    def dev_or_exp(dev_column, exp_column):
        return np.where(usedev, col[dev_column], col[exp_column])

    is_star = col["probpsf"] != 0

    def star_or_galaxy(star_column, dev_column, exp_column):
        return np.where(is_star, col[star_column],
                        dev_or_exp(dev_column, exp_column))

    mags = {c: star_or_galaxy(f"psfmag_{c}", f"devmag_{c}", f"expmag_{c}")
            for c in "ugriz"}

    flux_r = mag_to_flux(mags["r"], 2)
    result = Table({
        "objid": _objid_text(col["objid"]),
        "ra": col["ra"].astype(np.float64),
        "dec": col["dec"].astype(np.float64),
        "is_star": is_star.astype(float),
        "flux_r_nmgy": np.where(flux_r > 0, flux_r, np.nan),
        "color_ug": color_from_mags(mags["u"], 0, mags["g"], 1),
        "color_gr": color_from_mags(mags["g"], 1, mags["r"], 2),
        "color_ri": color_from_mags(mags["r"], 2, mags["i"], 3),
        "color_iz": color_from_mags(mags["i"], 3, mags["z"], 4),
        "gal_frac_dev": col["fracdev_r"].astype(np.float64),
        "gal_axis_ratio": dev_or_exp("devab_r", "expab_r"),
        "gal_radius_px": dev_or_exp("devrad_r", "exprad_r")
        / SDSS_ARCSEC_PER_PIXEL,
        "gal_angle_deg": canonical_angle(dev_or_exp("devphi_r", "expphi_r")),
    })
    keep = (col["is_saturated"] == 0) & ~np.isin(
        result["objid"].astype(str), list(BAD_COADD_OBJID))
    result = result[keep]
    # for stars, galaxy-only fields are undefined
    star_rows = result["is_star"] > 0.5
    for c in GALAXY_ONLY_COLUMNS:
        result[c] = np.where(star_rows, np.nan,
                             result[c].astype(np.float64))
    return result


def load_primary(dataset, rcf):
    """SDSS primary (photoObj) catalog -> catalog Table
    (AccuracyBenchmark.jl:272-335). `dataset`: io.sdss.SDSSDataSet;
    `rcf`: RunCamcolField."""
    from ..io.sdss import read_photoobj

    col = read_photoobj(dataset._open("photoObj", rcf))
    usedev = col["frac_dev"] > 0.5

    def dev_or_exp(dev_column, exp_column):
        return np.where(usedev, col[dev_column], col[exp_column])

    is_star = np.asarray(col["is_star"], bool)

    def star_or_galaxy(star_column, dev_column, exp_column):
        return np.where(is_star, col[star_column],
                        dev_or_exp(dev_column, exp_column))

    flux = {c: star_or_galaxy(f"psfflux_{c}", f"devflux_{c}", f"expflux_{c}")
            for c in "ugriz"}

    result = Table({
        "objid": _objid_text(col["objid"]),
        "ra": col["ra"], "dec": col["dec"],
        "is_star": is_star.astype(float),
        "flux_r_nmgy": flux["r"],
        "color_ug": color_from_fluxes(flux["u"], flux["g"]),
        "color_gr": color_from_fluxes(flux["g"], flux["r"]),
        "color_ri": color_from_fluxes(flux["r"], flux["i"]),
        "color_iz": color_from_fluxes(flux["i"], flux["z"]),
        "gal_frac_dev": col["frac_dev"],
        "gal_axis_ratio": dev_or_exp("ab_dev", "ab_exp"),
        "gal_radius_px": dev_or_exp("theta_dev", "theta_exp")
        / SDSS_ARCSEC_PER_PIXEL,
        "gal_angle_deg": canonical_angle(dev_or_exp("phi_dev", "phi_exp")),
    })
    # primary flags oversaturation better than coadd: drop psf mag_r < 16
    with np.errstate(invalid="ignore"):
        keep = ~(flux_to_mag(np.asarray(col["psfflux_r"], float), 2) < 16)
    return result[keep]


# -----------------------------------------------------------------------------
# Variational parameters -> catalog rows (AccuracyBenchmark.jl:337-393)


def get_median_fluxes(vs, source_type):
    return fluxes_from_colors(np.exp(vs[ids.flux_loc[source_type]]),
                              vs[ids.color_mean[:, source_type]])


def variational_params_to_row(vs):
    vs = np.asarray(vs)
    row = {
        "ra": vs[ids.pos[0]], "dec": vs[ids.pos[1]],
        "is_star": vs[ids.is_star[0]],
        "gal_frac_dev": vs[ids.gal_frac_dev],
        "gal_axis_ratio": vs[ids.gal_axis_ratio],
        # the catalog convention is the geometric-mean ("effective") radius
        "gal_radius_px": vs[ids.gal_radius_px]
        * np.sqrt(vs[ids.gal_axis_ratio]),
        "gal_angle_deg": canonical_angle(np.degrees(vs[ids.gal_angle])),
    }
    i = 0 if row["is_star"] > 0.5 else 1
    fluxes = get_median_fluxes(vs, i)
    row["flux_r_nmgy"] = fluxes[2]
    row["color_ug"] = color_from_fluxes(fluxes[0], fluxes[1])
    row["color_gr"] = color_from_fluxes(fluxes[1], fluxes[2])
    row["color_ri"] = color_from_fluxes(fluxes[2], fluxes[3])
    row["color_iz"] = color_from_fluxes(fluxes[3], fluxes[4])
    row["log_flux_r_stderr"] = np.sqrt(vs[ids.flux_scale[i]])
    for c, name in enumerate(COLOR_COLUMNS):
        row[f"{name}_stderr"] = np.sqrt(vs[ids.color_var[c, i]])
    return row


def celeste_to_df(results):
    """OptimizedSource list -> catalog Table, dropping bad-sky rows
    (AccuracyBenchmark.jl:378-393)."""
    return Table.from_rows(variational_params_to_row(r.vs) for r in results
                           if not r.is_sky_bad)


def catalog_entries_to_df(entries):
    """Ground-truth CatalogEntry list -> truth Table."""
    rows = []
    for ce in entries:
        fluxes = ce.star_fluxes if ce.is_star else ce.gal_fluxes
        rows.append({
            "ra": ce.pos[0], "dec": ce.pos[1],
            "is_star": 1.0 if ce.is_star else 0.0,
            "flux_r_nmgy": fluxes[2],
            "color_ug": color_from_fluxes(fluxes[0], fluxes[1]),
            "color_gr": color_from_fluxes(fluxes[1], fluxes[2]),
            "color_ri": color_from_fluxes(fluxes[2], fluxes[3]),
            "color_iz": color_from_fluxes(fluxes[3], fluxes[4]),
            "gal_frac_dev": np.nan if ce.is_star else ce.gal_frac_dev,
            "gal_axis_ratio": np.nan if ce.is_star else ce.gal_axis_ratio,
            "gal_radius_px": np.nan if ce.is_star
            else ce.gal_radius_px * np.sqrt(ce.gal_axis_ratio),
            "gal_angle_deg": np.nan if ce.is_star
            else canonical_angle(np.degrees(ce.gal_angle)),
        })
    return Table.from_rows(rows)


# -----------------------------------------------------------------------------
# Prior-draw catalog simulation (AccuracyBenchmark.jl:395-476)

PRIOR_PROBABILITY_OF_STAR = 0.28


def draw_source_params(rng, prior, pos):
    """One random CatalogEntry from the model prior."""
    is_star = rng.uniform() < PRIOR_PROBABILITY_OF_STAR
    i = 0 if is_star else 1
    lnr = rng.normal(prior.flux_mean[i], np.sqrt(prior.flux_var[i]))
    d = rng.choice(8, p=prior.k[:, i] / prior.k[:, i].sum())
    colors = rng.multivariate_normal(prior.color_mean[:, d, i],
                                     prior.color_cov[:, :, d, i])
    fluxes = fluxes_from_colors(np.exp(lnr), colors)
    gal_radius = float(np.exp(rng.normal(prior.gal_radius_px_mean,
                                         np.sqrt(prior.gal_radius_px_var))))
    return CatalogEntry(
        pos=np.asarray(pos, float), is_star=is_star,
        star_fluxes=np.maximum(fluxes, 1e-6),
        gal_fluxes=np.maximum(fluxes, 1e-6),
        gal_frac_dev=float(rng.uniform()),
        gal_axis_ratio=float(rng.uniform(0.2, 1.0)),
        gal_angle=float(rng.uniform(0.0, np.pi)),
        gal_radius_px=gal_radius)


def generate_catalog_from_prior(num_sources, extent=40.0, margin=10.0,
                                seed=0):
    from ..models.priors import prior
    rng = np.random.default_rng(seed)
    return [draw_source_params(
        rng, prior, rng.uniform(margin, extent - margin, size=2))
        for _ in range(num_sources)]


# -----------------------------------------------------------------------------
# Scoring (AccuracyBenchmark.jl:801-1026)


def match_catalogs(truth, predictions, tol=SDSS_ARCSEC_PER_PIXEL / 3600.0):
    """Subset rows so every truth row has a <tol-degree match in every
    prediction (AccuracyBenchmark.jl:934-963)."""
    matched = np.ones(len(truth), dtype=bool)
    idxs = []
    for pred in predictions:
        idx, dists = match_coordinates(truth["ra"], truth["dec"],
                                       pred["ra"], pred["dec"])
        matched &= dists < tol
        idxs.append(idx)
    return truth[matched], [pred.take(idx[matched])
                            for pred, idx in zip(predictions, idxs)]


def get_error_df(truth, predicted):
    """Per-row absolute errors (AccuracyBenchmark.jl:814-847)."""
    errors = Table()
    pred_gal = predicted["is_star"] < 0.5
    true_gal = truth["is_star"] < 0.5
    errors["missed_stars"] = np.where(~true_gal, pred_gal.astype(float),
                                      np.nan)
    errors["missed_galaxies"] = np.where(true_gal, (~pred_gal).astype(float),
                                         np.nan)
    errors["position"] = (ARCSEC_PER_DEGREE / SDSS_ARCSEC_PER_PIXEL) \
        * angular_separation(truth["ra"], truth["dec"],
                             predicted["ra"], predicted["dec"])
    errors["flux_r_mag"] = np.abs(flux_to_mag(truth["flux_r_nmgy"], 2)
                                  - flux_to_mag(predicted["flux_r_nmgy"], 2))
    errors["flux_r_nmgy"] = np.abs(truth["flux_r_nmgy"]
                                   - predicted["flux_r_nmgy"])
    errors["gal_angle_deg"] = degrees_to_diff(truth["gal_angle_deg"],
                                              predicted["gal_angle_deg"])
    for col in ABSOLUTE_ERROR_COLUMNS:
        errors[col] = np.abs(truth[col] - predicted[col])
    for col in COLOR_COLUMNS:
        errors[col] = errors[col] * (2.5 / np.log(10))  # Stripe82Score mags
    return errors


def _isnan(v):
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


def _is_good_row(truth_row, error, column):
    if _isnan(error):
        return False
    if not _isnan(truth_row["gal_radius_px"]) \
            and truth_row["gal_radius_px"] > 20:
        return False
    if column in ("gal_axis_ratio", "gal_radius_px", "gal_angle_deg",
                  "gal_frac_dev"):
        fd = truth_row["gal_frac_dev"]
        if not _isnan(fd) and 0.05 < fd < 0.95:
            return False
    if column == "gal_angle_deg":
        ar = truth_row["gal_axis_ratio"]
        if not _isnan(ar) and ar > 0.6:
            return False
    return True


def filter_rows(truth, errors, column):
    err = errors[column]
    return np.array([_is_good_row(truth.row(i), err[i], column)
                     for i in range(len(truth))], dtype=bool)


def get_scores_df(truth, first_errors, second_errors=None):
    rows = []
    for column in first_errors.columns:
        good = filter_rows(truth, first_errors, column)
        if second_errors is not None:
            good &= filter_rows(truth, second_errors, column)
        if good.sum() <= 1:
            continue
        row = {"field": column, "N": int(good.sum()),
               "first": float(first_errors[column][good].mean())}
        if second_errors is not None:
            row["second"] = float(second_errors[column][good].mean())
            diffs = first_errors[column][good] - second_errors[column][good]
            row["diff"] = float(diffs.mean())
            row["diff_sd"] = float(np.abs(diffs).std(ddof=1)
                                   / np.sqrt(len(diffs)))
        rows.append(row)
    return Table.from_rows(rows)


def score_predictions(truth, prediction_dfs,
                      tol=SDSS_ARCSEC_PER_PIXEL / 3600.0):
    """(AccuracyBenchmark.jl:967-976)"""
    assert len(prediction_dfs) <= 2
    matched_truth, matched = match_catalogs(truth, prediction_dfs, tol=tol)
    error_dfs = [get_error_df(matched_truth, p) for p in matched]
    return get_scores_df(matched_truth, error_dfs[0],
                         error_dfs[1] if len(error_dfs) > 1 else None)


# -----------------------------------------------------------------------------
# Uncertainty calibration (AccuracyBenchmark.jl:978-1026)


def get_uncertainty_df(truth, predictions,
                       tol=SDSS_ARCSEC_PER_PIXEL / 3600.0, aligned=False):
    """aligned=True: truth/prediction rows already correspond 1:1 (e.g. the
    objid-keyed GalSim suite output) — skip position matching entirely."""
    assert_columns_are_present(predictions, STDERR_COLUMNS)
    if aligned:
        assert len(truth) == len(predictions)
        matched_truth, pred = truth, predictions
    else:
        matched_truth, (pred,) = match_catalogs(truth, [predictions], tol=tol)
    valid = matched_truth["flux_r_nmgy"] > 0
    matched_truth = matched_truth[valid]
    pred = pred[valid]

    entries = []
    specs = [("log_flux_r_nmgy", "flux_r_nmgy", np.log, "log_flux_r_stderr")]
    specs += [(c, c, None, f"{c}_stderr") for c in COLOR_COLUMNS]
    for name, col, fn, stderr_col in specs:
        t = matched_truth[col].astype(float)
        p = pred[col].astype(float)
        err = (fn(p) - fn(t)) if fn else (p - t)
        entries.append(Table({
            "name": np.full(len(err), name, dtype=object), "error": err,
            "posterior_std_err": pred[stderr_col].astype(float)}))
    return concat(entries)


def score_uncertainty(uncertainty_df):
    """Fraction of errors within 1/2, 1, 2 posterior std errors; a
    calibrated posterior gives ~0.38 / 0.68 / 0.95. One row a name, in
    sorted order (pandas' groupby)."""
    rows = []
    names = uncertainty_df["name"]
    for name in sorted(set(names)):
        g = names == name
        z = np.abs(uncertainty_df["error"][g]
                   / uncertainty_df["posterior_std_err"][g])
        z = z[~np.isnan(z)]
        rows.append({"field": name,
                     "within_half_sd": float((z <= 0.5).mean()),
                     "within_1_sd": float((z <= 1.0).mean()),
                     "within_2_sd": float((z <= 2.0).mean()),
                     "within_3_sd": float((z <= 3.0).mean())})
    return Table.from_rows(rows)
