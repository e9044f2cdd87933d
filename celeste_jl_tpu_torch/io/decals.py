"""DECaLS survey dataset (port of celeste_jl_tpu/io/decals.py;
DECALSIO.jl, completed).

The reference implements only the CCD overlap query against the survey-ccds
metadata table (incl. the RA=0 wraparound handling, DECALSIO.jl:26-108);
its `load_images` raises "Not yet implemented" with a TODO list
(DECALSIO.jl:111-149). This module implements that TODO, on the host
(numpy; no device work):

  * per-CCD calibrated images (legacypipe convention: sky-subtracted
    nanomaggies) are read from `image_filename`/`image_hdu` in the table;
  * DECaLS supplies no background, so the sky is estimated with the
    package's own SEP-equivalent background mesh (detection/background),
    the reference's "calculate the background with SEP" plan;
  * calibration: nelec_per_nmgy = exptime * 10^((ccdzpt - 22.5) / 2.5)
    from the CCD zero point (legacypipe zeropoint convention);
  * PSF: a K=2 Gaussian mixture from the CCD `fwhm` column (PsfEx model
    fitting can substitute when psfex files are present);
  * WCS: TAN projection from the crval/crpix/cd columns.
"""

import os

import numpy as np

from .dataset import BoundingBox, SurveyDataSet
from .fits import open_fits

# DECam grz filters -> SDSS-style band indices (ugriz)
FILTER_TO_BAND = {"u": 0, "g": 1, "r": 2, "i": 3, "z": 4}


class DECALSDataSet(SurveyDataSet):
    def __init__(self, basedir, metadatafile="survey-ccds-decals.fits"):
        self.basedir = str(basedir)
        self.metadatafile = metadatafile

    def get_overlapping_ccds(self, box: BoundingBox):
        """Indices of CCDs whose linear-WCS corner extents overlap `box`
        (DECALSIO.jl:26-108)."""
        tbl = open_fits(os.path.join(self.basedir, self.metadatafile))[1].data
        crpix1 = np.asarray(tbl["crpix1"], np.float64)
        crpix2 = np.asarray(tbl["crpix2"], np.float64)
        crval1 = np.asarray(tbl["crval1"], np.float64)
        crval2 = np.asarray(tbl["crval2"], np.float64)
        cd11 = np.asarray(tbl["cd1_1"], np.float64)
        cd12 = np.asarray(tbl["cd1_2"], np.float64)
        cd21 = np.asarray(tbl["cd2_1"], np.float64)
        cd22 = np.asarray(tbl["cd2_2"], np.float64)
        width = np.asarray(tbl["width"], np.float64)
        height = np.asarray(tbl["height"], np.float64)

        def pix_to_world(x, y):
            dx, dy = x - crpix1, y - crpix2
            return (crval1 + cd11 * dx + cd12 * dy,
                    crval2 + cd21 * dx + cd22 * dy)

        corners = [pix_to_world(1.0, 1.0), pix_to_world(width, 1.0),
                   pix_to_world(1.0, height), pix_to_world(width, height)]
        ras = np.stack([c[0] for c in corners])
        decs = np.stack([c[1] for c in corners])
        ramin, ramax = ras.min(0), ras.max(0)
        decmin, decmax = decs.min(0), decs.max(0)

        # rotate everything away from the RA=0 discontinuity: center the
        # box at RA=180 and rotate CCD extents by the same offset
        offset = 180.0 - (box.ramax + box.ramin) / 2.0
        box_lo, box_hi = box.ramin + offset, box.ramax + offset
        ramin = (ramin + offset) % 360.0
        ramax = (ramax + offset) % 360.0

        mask = ((ramax > box_lo) & (ramin < box_hi)
                & (decmax > box.decmin) & (decmin < box.decmax))
        return np.flatnonzero(mask)

    def _table(self):
        return open_fits(os.path.join(self.basedir, self.metadatafile))[1].data

    def load_ccd_image(self, tbl, i):
        """One CCD row -> Image (electrons incl. estimated sky)."""
        from ..detection.background import Background
        from ..models.image import Image
        from ..models.psf import gaussian_psf
        from .wcs import TanWCS

        def col(name):
            v = tbl[name][i]
            return v.decode() if isinstance(v, bytes) else v

        path = os.path.join(self.basedir, str(col("image_filename")).strip())
        hdu = int(col("image_hdu")) if "image_hdu" in tbl else 0
        hdus = open_fits(path)
        nmgy = np.asarray(hdus[hdu].data, np.float64)
        # dq mask: NaN-out flagged pixels when a dq HDU follows the image
        if len(hdus) > hdu + 1 and hdus[hdu + 1].data is not None \
                and hdus[hdu + 1].data.shape == nmgy.shape:
            nmgy = np.where(np.asarray(hdus[hdu + 1].data) == 0, nmgy,
                            np.nan)

        band = FILTER_TO_BAND[str(col("filter")).strip().lower()[0]]
        exptime = float(col("exptime"))
        zpt = float(col("ccdzpt"))
        nelec_per_nmgy = exptime * 10.0 ** ((zpt - 22.5) / 2.5)

        # legacypipe images are sky-subtracted; reconstruct the sky level
        # the detector actually saw so the Poisson model gets physical
        # counts (reference TODO: "calculate the background with SEP",
        # DECALSIO.jl:129-135). For Poisson noise the pixel variance of the
        # subtracted image IS the sky in electrons, so: residual mesh
        # background (should be ~0) + clipped rms^2.
        bkg = Background(nmgy * nelec_per_nmgy,
                         boxsize=(min(256, nmgy.shape[0]),
                                  min(256, nmgy.shape[1])))
        sky_e = np.maximum(bkg.back(), 0.0) + bkg.rms() ** 2
        sky_nmgy = np.maximum(sky_e / nelec_per_nmgy, 1e-6)

        wcs = TanWCS(
            crpix=[float(col("crpix1")), float(col("crpix2"))],
            crval=[float(col("crval1")), float(col("crval2"))],
            cd=np.array([[float(col("cd1_1")), float(col("cd1_2"))],
                         [float(col("cd2_1")), float(col("cd2_2"))]],
                        np.float64))

        fwhm_px = float(col("fwhm")) if "fwhm" in tbl else 4.0
        psf = gaussian_psf(sigma=max(fwhm_px, 1.5) / 2.355, K=2)

        electrons = (nmgy + sky_nmgy) * nelec_per_nmgy
        return Image(pixels=electrons, band=band, psf=psf, sky=sky_nmgy,
                     nelec_per_nmgy=nelec_per_nmgy, wcs=wcs,
                     meta={"ccd_index": int(i)})

    def load_images(self, box: BoundingBox):
        """All CCD images overlapping `box` (completes DECALSIO.jl:111-149,
        which the reference leaves unimplemented)."""
        tbl = self._table()
        return [self.load_ccd_image(tbl, i)
                for i in self.get_overlapping_ccds(box)]
