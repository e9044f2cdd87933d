"""SDSS survey reader (port of celeste_jl_tpu/io/sdss.py; SDSSIO.jl).

Reads the SDSS file kinds per run/camcol/field: frame (calibrated image,
calibration vector, binned sky), fpM (pixel masks), psField (eigenimage PSF
map), photoField (gains), photoObj (catalog). It assembles five `Image`s
per field in raw electron counts, each with a K=2 Gaussian-mixture PSF
fitted to the psField stamp at the image center. The files are parsed with
numpy on the host; the PSF fits run on the dataset's device
(models/psf_fit, K3 on a CUDA device).

Axis convention: arrays are (axis1, axis2) like the reference (pixels[x, y],
calibration per axis-1 index), i.e. the transpose of the raw row-major FITS
read. All vectorized; the lazily-interpolated SDSSBackground becomes a
materialized (H, W) numpy array (a few MB per field).
"""

import os
from dataclasses import dataclass

import numpy as np

from ..models.image import CatalogEntry, Image
from ..models.psf_fit import fit_psfs_batched, trim_psf
from ..utils import log as Log
from ..utils.device import resolve
from .dataset import BoundingBox, SurveyDataSet
from .fits import open_fits
from .wcs import wcs_from_header

BAND_CHARS = "ugriz"
BAND_CHAR_TO_NUM = {c: i for i, c in enumerate(BAND_CHARS)}

DEFAULT_MASK_PLANES = ("S_MASK_INTERP", "S_MASK_SATUR", "S_MASK_CR",
                       "S_MASK_GHOST")

SDSS_ARCSEC_PER_PIXEL = 0.396


@dataclass(frozen=True, order=True)
class RunCamcolField:
    run: int
    camcol: int
    field: int

    def __str__(self):
        return f"({self.run}, {self.camcol}, {self.field})"


# -----------------------------------------------------------------------------
# Frame files


def interpolate_sky(sky_small, sky_x, sky_y, calibration):
    """Materialized SDSSBackground (SDSSIO.jl:56-99): bilinear interpolation
    of the binned sky onto the full frame, times per-row calibration ->
    (H, W) sky in nMgy. sky_x/sky_y are 1-based fractional coordinates into
    sky_small, constant-extrapolated at the borders."""
    sky_small = np.asarray(sky_small, dtype=np.float64)
    nx, ny = sky_small.shape

    def interp_1d(coords, n):
        c0 = np.floor(coords).astype(int)
        w = coords - c0
        lo = np.clip(c0 - 1, 0, n - 1)      # to 0-based
        hi = np.clip(c0, 0, n - 1)
        return lo, hi, w

    x0, x1, xw = interp_1d(np.asarray(sky_x, dtype=np.float64), nx)
    y0, y1, yw = interp_1d(np.asarray(sky_y, dtype=np.float64), ny)
    s00 = sky_small[np.ix_(x0, y0)]
    s10 = sky_small[np.ix_(x1, y0)]
    s01 = sky_small[np.ix_(x0, y1)]
    s11 = sky_small[np.ix_(x1, y1)]
    xw = xw[:, None]
    yw = yw[None, :]
    sky_dns = ((1 - xw) * (1 - yw) * s00 + xw * (1 - yw) * s10
               + (1 - xw) * yw * s01 + xw * yw * s11)
    return sky_dns * np.asarray(calibration, dtype=np.float64)[:, None]


def read_sky(hdu):
    """Binned sky + interpolation coords from a frame file's sky HDU
    (SDSSIO.jl:100-124). Returns (sky_small (nx, ny), sky_x, sky_y),
    1-based coordinates."""
    allsky = np.asarray(hdu.data["ALLSKY"], dtype=np.float64)
    if allsky.ndim == 3:            # one table row holding a 2-d image
        allsky = allsky[0]
    sky_x = np.ravel(np.asarray(hdu.data["XINTERP"], np.float64)) + 1.0
    sky_y = np.ravel(np.asarray(hdu.data["YINTERP"], np.float64)) + 1.0
    # ALLSKY rows are stored FITS-row-major; transpose to (axis1, axis2)
    if allsky.ndim == 2:
        sky_small = allsky.T
    else:
        raise ValueError(f"unexpected ALLSKY shape {allsky.shape}")
    assert np.all(sky_small > 1e-12), "sky must be positive for the ELBO"
    return sky_small, sky_x, sky_y


def read_frame(hdus):
    """Parse an SDSS frame file (SDSSIO.jl:127-148). Returns
    (image_nmgy (H, W), calibration (H,), sky_nmgy (H, W), wcs)."""
    image = np.asarray(hdus[0].data, dtype=np.float64).T  # (axis1, axis2)
    calibration = np.ravel(np.asarray(hdus[1].data, dtype=np.float64))
    sky_small, sky_x, sky_y = read_sky(hdus[2])
    sky = interpolate_sky(sky_small, sky_x, sky_y, calibration)
    wcs = wcs_from_header(hdus[0].header)
    return image, calibration, sky, wcs


def read_field_gains(hdus, fieldnum):
    """Per-band gains for one field from a photoField file
    (SDSSIO.jl:152-170)."""
    tbl = hdus[1].data
    fields = np.ravel(np.asarray(tbl["FIELD"]))
    gains = np.asarray(tbl["GAIN"], dtype=np.float64)
    for i, f in enumerate(fields):
        if int(f) == int(fieldnum):
            return {c: float(gains[i, b]) for c, b in BAND_CHAR_TO_NUM.items()}
    raise KeyError(f"field {fieldnum} not found in photoField file")


def read_mask(hdus, mask_planes=DEFAULT_MASK_PLANES):
    """Masked pixel ranges from an fpM file (SDSSIO.jl:173-224). Returns
    (xranges, yranges): lists of (lo, hi) inclusive 0-based index pairs in
    the (axis1, axis2) convention."""
    key = hdus[11].data
    values = np.ravel(np.asarray(key["Value"]))
    defnames = [str(s).strip() for s in np.ravel(key["defName"])]
    attrs = [str(s).strip() for s in np.ravel(key["attributeName"])]

    xranges, yranges = [], []
    for value, defname, attr in zip(values, defnames, attrs):
        if defname == "S_MASKTYPE" and attr in mask_planes:
            hdu = hdus[int(value) + 1]
            if hdu.data is None:
                continue
            cmin = np.ravel(np.asarray(hdu.data["cmin"]))
            cmax = np.ravel(np.asarray(hdu.data["cmax"]))
            rmin = np.ravel(np.asarray(hdu.data["rmin"]))
            rmax = np.ravel(np.asarray(hdu.data["rmax"]))
            for j in range(len(cmin)):
                xranges.append((int(cmin[j]), int(cmax[j])))
                yranges.append((int(rmin[j]), int(rmax[j])))
    return xranges, yranges


# -----------------------------------------------------------------------------
# psField PSF map


class SDSSPSFMap:
    """Spatially-varying PSF: weighted sum of eigenimages with polynomial
    weights (SDSSIO.jl:239-298). Callable at 1-based (x, y); vectorized over
    eigenimages."""

    RCS = 0.001

    def __init__(self, rrows, rnrow, rncol, cmat):
        rrows = np.asarray(rrows, dtype=np.float64)
        assert rrows.shape[0] == rnrow * rncol
        assert rrows.shape[1] == cmat.shape[2]
        self.rrows = rrows
        self.rnrow = int(rnrow)
        self.rncol = int(rncol)
        self.cmat = np.asarray(cmat, dtype=np.float64)

    def __call__(self, x, y):
        ni, nj, nk = self.cmat.shape
        xt = (self.RCS * (x - 1.0)) ** np.arange(ni)
        yt = (self.RCS * (y - 1.0)) ** np.arange(nj)
        w = np.einsum("i,j,ijk->k", xt, yt, self.cmat)
        stamp = self.rrows @ w
        # flattened eigenimages are stored FITS-order; reshape column-major
        return stamp.reshape(self.rnrow, self.rncol, order="F")

    def at(self, xs, ys):
        """Vectorized evaluation at (S,) 1-based positions -> (S, rnrow,
        rncol) stamps: one einsum for a whole catalog's patch centers
        (SDSSIO.jl:239-298 evaluates per patch)."""
        xs = np.atleast_1d(np.asarray(xs, dtype=np.float64))
        ys = np.atleast_1d(np.asarray(ys, dtype=np.float64))
        ni, nj, nk = self.cmat.shape
        xt = (self.RCS * (xs[:, None] - 1.0)) ** np.arange(ni)  # (S, ni)
        yt = (self.RCS * (ys[:, None] - 1.0)) ** np.arange(nj)  # (S, nj)
        w = np.einsum("si,sj,ijk->sk", xt, yt, self.cmat)       # (S, nk)
        stamps = w @ self.rrows.T                                # (S, npix)
        return stamps.reshape(-1, self.rncol, self.rnrow,
                              ).transpose(0, 2, 1)


def read_psfmap(hdus, band):
    """psField -> SDSSPSFMap for one band (SDSSIO.jl:310-338)."""
    hdu = hdus[1 + BAND_CHAR_TO_NUM[band]]
    tbl = hdu.data
    nrow_b = int(np.ravel(tbl["nrow_b"])[0])
    ncol_b = int(np.ravel(tbl["ncol_b"])[0])
    rnrow = int(np.ravel(tbl["rnrow"])[0])
    rncol = int(np.ravel(tbl["rncol"])[0])
    c_raw = np.asarray(tbl["c"], dtype=np.float64)  # (nrows, ...) flattened
    rrows_raw = np.asarray(tbl["rrows"], dtype=np.float64)  # (nk, npix)
    nk = rrows_raw.shape[0]
    # per-row flat 'c' of length >= nrow_b*ncol_b stored column-major
    cmat = np.zeros((nrow_b, ncol_b, nk))
    for k in range(nk):
        ck = np.ravel(c_raw[k])
        cmat[:, :, k] = ck[:nrow_b * ncol_b].reshape(nrow_b, ncol_b,
                                                     order="F")
    return SDSSPSFMap(rrows_raw.T, rnrow, rncol, cmat)


# -----------------------------------------------------------------------------
# photoObj catalogs

# objc_flags: bright | saturated | large
_BAD_FLAGS1 = np.uint32(2 ** 1 + 2 ** 18 + 2 ** 24)
# objc_flags2: nopeak | deblend_degenerate | saturated center
_BAD_FLAGS2 = np.uint32(2 ** 14 + 2 ** 18 + 2 ** 11)


def read_photoobj(hdus, band="r"):
    """photoObj file -> dict of filtered catalog columns
    (SDSSIO.jl:353-474)."""
    empty = {
        "objid": np.array([], dtype=str), "ra": np.array([]),
        "dec": np.array([]), "is_star": np.array([], bool),
        "is_gal": np.array([], bool), "frac_dev": np.array([]),
        "ab_exp": np.array([]), "theta_exp": np.array([]),
        "phi_exp": np.array([]), "ab_dev": np.array([]),
        "theta_dev": np.array([]), "phi_dev": np.array([]),
        "phi_offset": np.array([]),
    }
    for c in BAND_CHARS:
        for kind in ("psfflux", "compflux", "expflux", "devflux"):
            empty[f"{kind}_{c}"] = np.array([])
    if len(hdus) < 2 or hdus[1].data is None or "objid" not in hdus[1].data:
        return empty

    b = BAND_CHAR_TO_NUM[band]
    tbl = hdus[1].data
    objc_flags = np.asarray(tbl["objc_flags"]).astype(np.uint32)
    objc_flags2 = np.asarray(tbl["objc_flags2"]).astype(np.uint32)
    bad1 = (objc_flags & _BAD_FLAGS1) != 0
    bad2 = (objc_flags2 & _BAD_FLAGS2) != 0
    has_child = np.asarray(tbl["nchild"]) > 0
    objc_type = np.asarray(tbl["objc_type"])
    is_star = objc_type == 6
    is_gal = objc_type == 3
    bad_type = ~(is_star | is_gal)
    fracdev = np.asarray(tbl["fracdev"], dtype=np.float64)[:, b]
    bad_fracdev = (fracdev < 0) | (fracdev > 1)
    mask = ~(bad_fracdev | bad_type | bad1 | bad2 | has_child)

    def col(name):
        return np.asarray(tbl[name])[mask]

    out = {
        "objid": np.asarray(tbl["objid"]).astype(str)[mask],
        "ra": col("ra").astype(np.float64),
        "dec": col("dec").astype(np.float64),
        "is_star": is_star[mask], "is_gal": is_gal[mask],
        "frac_dev": fracdev[mask],
        "ab_exp": np.asarray(tbl["ab_exp"], np.float64)[mask, b],
        "theta_exp": np.asarray(tbl["theta_exp"], np.float64)[mask, b],
        "phi_exp": np.asarray(tbl["phi_exp_deg"], np.float64)[mask, b],
        "ab_dev": np.asarray(tbl["ab_dev"], np.float64)[mask, b],
        "theta_dev": np.asarray(tbl["theta_dev"], np.float64)[mask, b],
        "phi_dev": np.asarray(tbl["phi_dev_deg"], np.float64)[mask, b],
        "phi_offset": np.asarray(tbl["phi_offset"], np.float64)[mask, b],
    }
    for c, n in BAND_CHAR_TO_NUM.items():
        out[f"psfflux_{c}"] = np.asarray(tbl["psfflux"], np.float64)[mask, n]
        out[f"compflux_{c}"] = np.asarray(tbl["cmodelflux"],
                                          np.float64)[mask, n]
        out[f"expflux_{c}"] = np.asarray(tbl["expflux"], np.float64)[mask, n]
        out[f"devflux_{c}"] = np.asarray(tbl["devflux"], np.float64)[mask, n]
    return out


def photoobj_to_catalog(cat):
    """dict-of-columns -> list[CatalogEntry] (SDSSIO.jl:479-527)."""
    out = []
    for i in range(len(cat["objid"])):
        frac_dev = float(cat["frac_dev"][i])
        star_fluxes = np.zeros(5)
        gal_fluxes = np.zeros(5)
        for j, c in enumerate(BAND_CHARS):
            psfflux = max(cat[f"psfflux_{c}"][i], 1e-6)
            devflux = max(cat[f"devflux_{c}"][i], 1e-6)
            expflux = max(cat[f"expflux_{c}"][i], 1e-6)
            star_fluxes[j] = psfflux
            gal_fluxes[j] = frac_dev * devflux + (1 - frac_dev) * expflux
        usedev = frac_dev > 0.5
        which = "dev" if usedev else "exp"
        ab = float(cat[f"ab_{which}"][i])
        phi = float(cat[f"phi_{which}"][i]) - float(cat["phi_offset"][i])
        theta = float(cat[f"theta_{which}"][i])
        re_pixel = max(theta, 1.0 / 30) / SDSS_ARCSEC_PER_PIXEL
        out.append(CatalogEntry(
            pos=np.array([cat["ra"][i], cat["dec"][i]]),
            is_star=bool(cat["is_star"][i]),
            star_fluxes=star_fluxes, gal_fluxes=gal_fluxes,
            gal_frac_dev=frac_dev, gal_axis_ratio=ab,
            gal_angle=phi * np.pi / 180.0, gal_radius_px=re_pixel,
            objid=str(cat["objid"][i])))
    return out


# -----------------------------------------------------------------------------
# Dataset: file layout + assembly


class SDSSDataSet(SurveyDataSet):
    """SDSS data rooted at `basedir` (SDSSIO.jl:548-566). dirlayout:
    'celeste' (basedir/run/camcol[/field]/file) or 'sdss' (the survey file
    server layout). compressed: frames .bz2, masks .gz.

    iostrategy: 'plain' reads the local filesystem; 'http' fetches raw FITS
    bytes from a file server at `basedir` (an http(s):// URL), the
    distributed-I/O replacement for the reference's masterrpc
    remotecall_fetch (SDSSIO.jl:677-692) and nginx HTTPStrategy
    (contrib/http/httpio.jl): workers on many hosts read one shared
    server instead of a shared filesystem. Auto-selected when basedir is a
    URL.

    device: where the field-center PSF fits run (the card unless the
    caller asks for the CPU)."""

    def __init__(self, basedir, dirlayout="celeste", compressed=False,
                 slurp=False, iostrategy=None, *, device="cuda"):
        self.device = resolve(device)
        if dirlayout not in ("celeste", "sdss"):
            raise ValueError(f"unknown dirlayout {dirlayout!r}")
        self.basedir = str(basedir)
        if iostrategy is None:
            iostrategy = ("http" if self.basedir.startswith(("http://",
                                                             "https://"))
                          else "plain")
        if iostrategy not in ("plain", "http"):
            raise ValueError(f"unknown iostrategy {iostrategy!r}")
        self.iostrategy = iostrategy
        self.dirlayout = dirlayout
        self.compressed = compressed
        self.slurp = slurp  # open_fits always slurps; kept for API parity

    def _fetch(self, path):
        """Raw file bytes via the configured I/O strategy."""
        if self.iostrategy == "http":
            from urllib.request import urlopen
            url = path.replace(os.sep, "/")
            with urlopen(url) as resp:
                return resp.read()
        with open(path, "rb") as f:
            return f.read()

    # -- filenames (SDSSIO.jl:615-649)

    def _path(self, kind, rcf, band=None):
        run, camcol, field = rcf.run, rcf.camcol, rcf.field
        names = {
            "photoObj": f"photoObj-{run:06d}-{camcol}-{field:04d}.fits",
            "photoField": f"photoField-{run:06d}-{camcol}.fits",
            "psField": f"psField-{run:06d}-{camcol}-{field:04d}.fit",
            "frame": f"frame-{band}-{run:06d}-{camcol}-{field:04d}.fits",
            "fpM": f"fpM-{run:06d}-{band}{camcol}-{field:04d}.fit",
        }
        fname = names[kind]
        if self.dirlayout == "celeste":
            sub = os.path.join(self.basedir, str(run), str(camcol))
            if kind != "photoField":
                sub = os.path.join(sub, str(field))
        else:
            if kind in ("fpM", "psField"):
                sub = os.path.join(self.basedir, "boss/photo/redux/301",
                                   str(run), "objcs", str(camcol))
            elif kind == "photoField":
                sub = os.path.join(self.basedir, "boss/photoObj/301",
                                   str(run))
            elif kind == "photoObj":
                sub = os.path.join(self.basedir, "boss/photoObj/301",
                                   str(run), str(camcol))
            else:
                sub = os.path.join(self.basedir,
                                   "boss/photoObj/frames/301",
                                   str(run), str(camcol))
        path = os.path.join(sub, fname)
        if self.compressed and kind == "frame":
            path += ".bz2"
        if self.compressed and kind == "fpM":
            path += ".gz"
        return path

    def _open(self, kind, rcf, band=None):
        return open_fits(self._fetch(self._path(kind, rcf, band)))

    # -- loading (SDSSIO.jl:738-821)

    def load_field_images(self, rcfs, mask_planes=DEFAULT_MASK_PLANES):
        """Five Images per field. The field-center PSF of each band is a
        one-stamp fit (SDSSIO.jl:738-821); the five bands of a field go in
        one launch, a lane each (one launch per trimmed stamp size), which
        gives each lane the result of its own fit."""
        if isinstance(rcfs, RunCamcolField):
            rcfs = [rcfs]
        images = []
        for rcf in rcfs:
            gains = read_field_gains(self._open("photoField", rcf),
                                     rcf.field)
            psf_hdus = self._open("psField", rcf)
            bands, stamps = [], []
            for band in BAND_CHARS:
                pixels, calibration, sky, wcs = read_frame(
                    self._open("frame", rcf, band))
                xr, yr = read_mask(self._open("fpM", rcf, band),
                                   mask_planes)
                for (x0, x1), (y0, y1) in zip(xr, yr):
                    pixels[x0:x1 + 1, y0:y1 + 1] = np.nan

                psfmap = read_psfmap(psf_hdus, band)
                stamps.append(trim_psf(psfmap(pixels.shape[0] / 2.0,
                                              pixels.shape[1] / 2.0)))
                nelec_per_nmgy = gains[band] / calibration
                electrons = nelec_per_nmgy[:, None] * (pixels + sky)
                bands.append(Image(
                    pixels=electrons, band=BAND_CHAR_TO_NUM[band], psf=None,
                    sky=sky, nelec_per_nmgy=nelec_per_nmgy, wcs=wcs,
                    meta={"rcf": rcf, "psfmap": psfmap}))
            by_shape = {}
            for b, st in enumerate(stamps):
                by_shape.setdefault(st.shape, []).append(b)
            for members in by_shape.values():
                packed, _ = fit_psfs_batched(
                    np.stack([stamps[b] for b in members]), K=2,
                    device=self.device)
                for b, psf in zip(members, packed):
                    bands[b].psf = psf
            images.extend(bands)
            Log.info(f"loaded field {rcf}")
        return images

    def load_field_catalog(self, rcf):
        return photoobj_to_catalog(
            read_photoobj(self._open("photoObj", rcf)))

    def field_extents(self):
        path = os.path.join(self.basedir, "field_extents.fits")
        tbl = open_fits(self._fetch(path))[1].data
        return tbl

    def get_overlapping_fields(self, box: BoundingBox):
        """(SDSSIO.jl:698-729)"""
        tbl = self.field_extents()
        out = []
        for i in range(len(np.ravel(tbl["run"]))):
            if (tbl["ramax"][i] > box.ramin and tbl["ramin"][i] < box.ramax
                    and tbl["decmax"][i] > box.decmin
                    and tbl["decmin"][i] < box.decmax):
                out.append(RunCamcolField(int(tbl["run"][i]),
                                          int(tbl["camcol"][i]),
                                          int(tbl["field"][i])))
        return out

    def load_images(self, box: BoundingBox):
        return self.load_field_images(self.get_overlapping_fields(box))
