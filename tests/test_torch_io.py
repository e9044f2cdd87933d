"""The port's survey I/O (io/fits, io/wcs, io/sdss, io/decals) against the
JAX package's, on the same files, f64 on the CPU:

- write_fits: the same bytes for the same HDUs; open_fits round trips of
  images, bintables, gzip, bz2 and in-memory bytes;
- TanWCS, LinearWCS and wcs_from_header: within 1e-12;
- SDSSDataSet on tests/sdss_fixtures.make_sdss_field's files: pixels, NaN
  mask positions, calibration, sky, nelec_per_nmgy and psfmap stamps within
  1e-12; the field-center PSF fits against JAX's within 1e-6 relative
  (squared error 1e-8) where the fit is well posed (an elliptical psField);
  on the fixture's round PSF the fit walks a flat ridge (the angle of a
  round component is free) where a 1e-15 change of the stamp moves JAX's
  own fit by ~7e-5, so there both fits are held to the stamp and to each
  other's rendered density (ROADMAP queue 3);
- photoobj_to_catalog and the overlap query: equal; the http strategy over
  a local http.server: the plain strategy's images;
- DECALSDataSet on tests/test_decals.py's generated CCDs: equal images;
- tests/test_sdss_golden.py's hand-derived golden values on the port.
"""

import bz2
import functools
import gzip
import http.server
import threading

import numpy as np
import pytest
import torch

import test_decals as jax_decals_tests
from celeste_jl_tpu.io import fits as jfits
from celeste_jl_tpu.io import wcs as jwcs
from celeste_jl_tpu.io.dataset import BoundingBox as JaxBox
from celeste_jl_tpu.io.decals import DECALSDataSet as JaxDECALS
from celeste_jl_tpu.io.sdss import SDSSDataSet as JaxSDSS
from celeste_jl_tpu.io.sdss import read_photoobj as jax_read_photoobj
from celeste_jl_tpu.models.psf import make_psf, render_psf
from celeste_jl_tpu_torch.io import fits, wcs
from celeste_jl_tpu_torch.io.dataset import BoundingBox
from celeste_jl_tpu_torch.io.decals import DECALSDataSet
from celeste_jl_tpu_torch.io.sdss import (RunCamcolField, SDSSDataSet,
                                          SDSSPSFMap, interpolate_sky,
                                          photoobj_to_catalog, read_mask,
                                          read_photoobj, read_sky)
from sdss_fixtures import H, PSF_STAMP, W, make_sdss_field

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _hdus():
    rng = np.random.default_rng(0)
    return [
        (rng.normal(size=(5, 7)).astype(np.float32),
         [("RUN", 94, "sdss run"), ("OBJECT", "M31 o'clock", "target"),
          ("FLAG", True), ("SCALE", 0.396)]),
        (np.arange(12, dtype=np.int16).reshape(3, 4), None),
        (rng.normal(size=(2, 3, 4)), [("BUNIT", "nMgy")]),
        ({"ra": rng.normal(size=3), "flags": np.array([3, 7, 9], np.int32),
          "name": np.array(["abc", "de", "f"]),
          "is_star": np.array([True, False, True]),
          "fluxes": rng.normal(size=(3, 5)).astype(np.float32),
          "stamp": rng.normal(size=(3, 2, 4))}, [("EXTNAME", "CATALOG")]),
    ]


def test_write_fits_bytes_equal_jax(tmp_path):
    for name, hdus in (("images", _hdus()),
                       ("primary_table", [_hdus()[3]])):
        fits.write_fits(str(tmp_path / f"{name}-p.fits"), hdus)
        jfits.write_fits(str(tmp_path / f"{name}-j.fits"), hdus)
        assert ((tmp_path / f"{name}-p.fits").read_bytes()
                == (tmp_path / f"{name}-j.fits").read_bytes()), name


@pytest.mark.parametrize("wrap", ["path", "gzip", "bz2", "bytes",
                                  "gzip_bytes", "bz2_bytes"])
def test_open_fits_round_trips(tmp_path, wrap):
    path = str(tmp_path / "x.fits")
    hdus = _hdus()
    fits.write_fits(path, hdus)
    raw = open(path, "rb").read()
    if wrap in ("gzip", "bz2"):
        path += ".gz" if wrap == "gzip" else ".bz2"
        with open(path, "wb") as f:
            f.write((gzip if wrap == "gzip" else bz2).compress(raw))
    src = {"path": path, "gzip": path, "bz2": path, "bytes": raw,
           "gzip_bytes": gzip.compress(raw), "bz2_bytes": bz2.compress(raw)
           }[wrap]
    got, want = fits.open_fits(src), jfits.open_fits(src)
    assert len(got) == len(hdus) == len(want)
    for i, (data, extra) in enumerate(hdus[:3]):
        np.testing.assert_array_equal(got[i].data, data)
        assert got[i].data.dtype.isnative
        assert dict(got[i].header) == dict(want[i].header)
        for card in extra or []:
            assert got[i].header[card[0]] == card[1]
    tab, jtab = got[3].data, want[3].data
    for k, v in hdus[3][0].items():
        np.testing.assert_array_equal(tab[k], v, err_msg=k)
        np.testing.assert_array_equal(tab[k], jtab[k], err_msg=k)
    torch.as_tensor(tab["fluxes"])      # native order: torch takes it


def test_wcs_matches_jax():
    rng = np.random.default_rng(1)
    cd = np.array([[1.1e-4, 2e-6], [-3e-6, 1.05e-4]])
    hdr = {"CTYPE1": "RA---TAN", "CRPIX1": 48.0, "CRPIX2": 32.0,
           "CRVAL1": 150.0, "CRVAL2": 1.0, "CD1_1": cd[0, 0],
           "CD1_2": cd[0, 1], "CD2_1": cd[1, 0], "CD2_2": cd[1, 1]}
    pix = rng.uniform(-50, 150, (7, 2))
    pairs = [(wcs.TanWCS([48.0, 32.0], [150.0, 1.0], cd),
              jwcs.TanWCS([48.0, 32.0], [150.0, 1.0], cd)),
             (wcs.LinearWCS([3.0, 4.0], [10.0, 20.0], cd * 1e4),
              jwcs.LinearWCS([3.0, 4.0], [10.0, 20.0], cd * 1e4)),
             (wcs.wcs_from_header(hdr), jwcs.wcs_from_header(hdr)),
             (wcs.wcs_from_header({**hdr, "CTYPE1": "RA"}),
              jwcs.wcs_from_header({**hdr, "CTYPE1": "RA"}))]
    for p, j in pairs:
        assert type(p).__name__ == type(j).__name__
        world = j.pix_to_world(pix)
        for got, want in ((p.pix_to_world(pix), world),
                          (p.world_to_pix(world), j.world_to_pix(world)),
                          (p.pixel_world_jacobian(pix),
                           j.pixel_world_jacobian(pix)),
                          (p.pixel_world_jacobian(pix[0]),
                           j.pixel_world_jacobian(pix[0]))):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    base = tmp_path_factory.mktemp("sdss")
    rcf, truth, fwcs = make_sdss_field(base)
    return str(base), RunCamcolField(rcf.run, rcf.camcol, rcf.field), rcf


def _loaded(field):
    base, prcf, jrcf = field
    return (SDSSDataSet(base, **CPU).load_field_images(prcf),
            JaxSDSS(base).load_field_images(jrcf))


def _assert_images_equal(got, want):
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.band == b.band
        np.testing.assert_array_equal(np.isnan(a.pixels), np.isnan(b.pixels))
        for name in ("pixels", "sky", "nelec_per_nmgy"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=1e-12, atol=0, err_msg=name)
        assert type(a.wcs).__name__ == type(b.wcs).__name__
        np.testing.assert_array_equal(a.wcs.cd, b.wcs.cd)
        xs, ys = np.array([1.0, 40.0, 96.0]), np.array([1.0, 33.5, 64.0])
        np.testing.assert_allclose(a.meta["psfmap"].at(xs, ys),
                                   b.meta["psfmap"].at(xs, ys), rtol=1e-12,
                                   atol=0)
        assert a.meta["rcf"] == RunCamcolField(*(getattr(b.meta["rcf"], k)
                                                 for k in ("run", "camcol",
                                                           "field")))


def test_load_field_images_matches_jax(field):
    got, want = _loaded(field)
    _assert_images_equal(got, want)
    # the r band's fpM box, in (axis1, axis2) as the JAX package reads it
    assert np.all(np.isnan(got[2].pixels[5:9, 5:9]))
    np.testing.assert_allclose(got[2].nelec_per_nmgy, 800.0)  # f32 file
    # the fixture's round PSF: a flat ridge, both fits held to the stamp
    # and to each other's density (module docstring)
    for a, b in zip(got, want):
        stamp = a.meta["psfmap"](H / 2.0, W / 2.0)
        ra = np.asarray(render_psf(a.psf, size=PSF_STAMP))
        rb = np.asarray(render_psf(b.psf, size=PSF_STAMP))
        assert np.max(np.abs(ra - stamp)) / stamp.max() < 0.05
        assert np.max(np.abs(ra - rb)) / rb.max() < 1e-5


def _elliptical_psfield(base, jrcf):
    """Replace the fixture's psField with one of an elliptical PSF (the
    same layout: 2 eigenimages, a 3 x 3 polynomial, column-major)."""
    import os

    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    psf = make_psf([0.7, 0.3], [[0.2, -0.1], [0.0, 0.1]],
                   [R @ np.diag([2.2, 1.4]) @ R.T,
                    R @ np.diag([7.0, 4.5]) @ R.T])
    eigen0 = np.asarray(render_psf(psf, size=PSF_STAMP))
    cmat = np.zeros((2, 9))
    cmat[0, 0], cmat[1, 1] = 1.0, 1e-4
    hdus = [(None, None)] + [({
        "nrow_b": np.array([3, 3], np.int32),
        "ncol_b": np.array([3, 3], np.int32),
        "rnrow": np.array([PSF_STAMP] * 2, np.int32),
        "rncol": np.array([PSF_STAMP] * 2, np.int32),
        "c": cmat.astype(np.float32),
        "rrows": np.stack([eigen0.ravel(order="F"),
                           0.01 * eigen0.ravel(order="F")]
                          ).astype(np.float32)}, None)] * 5
    jfits.write_fits(os.path.join(
        base, str(jrcf.run), str(jrcf.camcol), str(jrcf.field),
        f"psField-{jrcf.run:06d}-{jrcf.camcol}-{jrcf.field:04d}.fit"), hdus)


def test_field_psf_fits_match_jax_on_an_elliptical_psfield(tmp_path):
    from celeste_jl_tpu.models.psf_fit import fit_raw_psf as jax_fit
    from celeste_jl_tpu.models.psf_fit import trim_psf
    from celeste_jl_tpu_torch.models.psf_fit import fit_raw_psf

    base = str(tmp_path)
    jrcf = make_sdss_field(base)[0]
    _elliptical_psfield(base, jrcf)
    prcf = RunCamcolField(jrcf.run, jrcf.camcol, jrcf.field)
    got = SDSSDataSet(base, **CPU).load_field_images(prcf)
    want = JaxSDSS(base).load_field_images(jrcf)
    _assert_images_equal(got, want)
    stamp = trim_psf(got[0].meta["psfmap"](H / 2.0, W / 2.0))
    _, err_p = fit_raw_psf(stamp, **CPU)
    _, err_j = jax_fit(stamp)
    assert abs(err_p - err_j) <= 1e-8 * abs(err_j)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.psf, b.psf, rtol=0,
                                   atol=1e-6 * np.abs(b.psf).max())


def test_catalog_and_overlap_query_match_jax(field):
    base, prcf, jrcf = field
    ds, jds = SDSSDataSet(base, **CPU), JaxSDSS(base)
    got, want = ds.load_field_catalog(prcf), jds.load_field_catalog(jrcf)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k, v in b.__dict__.items():
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
    raw = jfits.open_fits(ds._path("photoObj", prcf))
    pcat, jcat = read_photoobj(raw), jax_read_photoobj(raw)
    assert pcat.keys() == jcat.keys()
    for k in jcat:
        np.testing.assert_array_equal(pcat[k], jcat[k], err_msg=k)
    assert len(photoobj_to_catalog(pcat)) == len(want)
    tbl = ds.field_extents()
    for box in ((tbl["ramin"][0] + 1e-4, tbl["ramax"][0] - 1e-4,
                 tbl["decmin"][0] + 1e-4, tbl["decmax"][0] - 1e-4),
                (10.0, 11.0, -5.0, -4.0)):
        g = ds.get_overlapping_fields(BoundingBox(*box))
        w = jds.get_overlapping_fields(JaxBox(*box))
        assert [(r.run, r.camcol, r.field) for r in g] == \
            [(r.run, r.camcol, r.field) for r in w]
    assert len(ds.load_images(BoundingBox(*(tbl[k][0] for k in (
        "ramin", "ramax", "decmin", "decmax"))))) == 5


@pytest.fixture(scope="module")
def http_base(field):
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=field[0])
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    thread.join(timeout=10)


def test_http_strategy_matches_plain(field, http_base):
    base, prcf, _ = field
    ds = SDSSDataSet(http_base, **CPU)
    assert ds.iostrategy == "http"
    assert SDSSDataSet(base, **CPU).iostrategy == "plain"
    got = ds.load_field_images(prcf)
    plain = SDSSDataSet(base, **CPU).load_field_images(prcf)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a.pixels, b.pixels)
        np.testing.assert_array_equal(a.psf, b.psf)
    assert len(ds.load_field_catalog(prcf)) == 2


def test_datasets_refuse_a_missing_card(field):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        SDSSDataSet(field[0])


def test_decals_matches_jax(tmp_path):
    jax_decals_tests._write_decals_fixture(tmp_path)
    box = (149.99, 150.01, 1.99, 2.01)
    got = DECALSDataSet(tmp_path).load_images(BoundingBox(*box))
    want = JaxDECALS(tmp_path).load_images(JaxBox(*box))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.band == b.band and a.meta == b.meta
        for name in ("pixels", "sky", "nelec_per_nmgy", "psf"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=1e-12, atol=0, err_msg=name)
        np.testing.assert_array_equal(a.wcs.cd, b.wcs.cd)
    idx = DECALSDataSet(tmp_path).get_overlapping_ccds(
        BoundingBox(140.0, 152.0, -31.0, 3.0))
    assert list(idx) == [0, 1, 2]


# tests/test_sdss_golden.py's hand-derived values, on the port


class _HDU:
    def __init__(self, data):
        self.data = data


def test_golden_psfmap_polynomial():
    rrows = np.stack([np.array([1.0, 2.0, 3.0, 4.0]),
                      np.array([10.0, 20.0, 30.0, 40.0])], axis=1)
    cmat = np.zeros((2, 2, 2))
    cmat[0, 0, 0], cmat[0, 1, 1], cmat[1, 0, 1] = 1.0, 1.0, 2.0
    psf = SDSSPSFMap(rrows, 2, 2, cmat)
    expected = np.array([[14.0, 42.0], [28.0, 56.0]])
    np.testing.assert_allclose(psf(501.0, 301.0), expected, rtol=1e-14)
    stamps = psf.at([501.0, 11.0], [301.0, 21.0])
    np.testing.assert_allclose(stamps[0], expected, rtol=1e-14)
    w1 = cmat[0, 1, 1] * 0.02 + cmat[1, 0, 1] * 0.01
    flat = rrows[:, 0] + rrows[:, 1] * w1
    np.testing.assert_allclose(stamps[1], flat.reshape(2, 2, order="F"),
                               rtol=1e-14)


def test_golden_fpm_mask_extents():
    key = {"Value": np.array([3, 4, 7]),
           "defName": np.array(["S_MASKTYPE"] * 3),
           "attributeName": np.array(["S_MASK_INTERP", "S_MASK_SATUR",
                                      "S_MASK_GHOST"])}
    hdus = [None] * 12
    hdus[11] = _HDU(key)
    hdus[4] = _HDU({"cmin": np.array([5, 100]), "cmax": np.array([9, 100]),
                    "rmin": np.array([0, 7]), "rmax": np.array([2, 7])})
    hdus[5] = _HDU({"cmin": np.array([20]), "cmax": np.array([21]),
                    "rmin": np.array([30]), "rmax": np.array([33])})
    hdus[8] = _HDU({"cmin": np.array([0]), "cmax": np.array([0]),
                    "rmin": np.array([0]), "rmax": np.array([0])})
    planes = {"S_MASK_INTERP", "S_MASK_SATUR"}
    assert read_mask(hdus, planes) == ([(5, 9), (100, 100), (20, 21)],
                                       [(0, 2), (7, 7), (30, 33)])
    hdus[5] = _HDU(None)
    assert read_mask(hdus, planes)[0] == [(5, 9), (100, 100)]


def test_golden_sky_interpolation_and_read_sky():
    out = interpolate_sky(np.array([[1.0, 3.0], [5.0, 7.0]]),
                          np.array([1.0, 1.5, 2.0, 2.75]),
                          np.array([0.5, 1.25]),
                          np.array([1.0, 1.0, 2.0, 1.0]))
    np.testing.assert_allclose(out, [[1.0, 1.5], [3.0, 3.5], [10.0, 11.0],
                                     [5.0, 5.5]], rtol=1e-14)
    allsky = np.array([[1.0, 5.0], [3.0, 7.0]])
    sky_small, sky_x, sky_y = read_sky(_HDU({
        "ALLSKY": allsky, "XINTERP": np.array([0.0, 0.5, 1.0]),
        "YINTERP": np.array([0.0, 1.0])}))
    np.testing.assert_array_equal(sky_small, allsky.T)
    np.testing.assert_array_equal(sky_x, [1.0, 1.5, 2.0])
    np.testing.assert_array_equal(sky_y, [1.0, 2.0])
