"""Multi-extension FITS image bundles with header-embedded PSF and truth
(the port's copy of celeste_jl_tpu/benchmark/bundle.py: the same files,
so each package reads the other's bundles).

Rebuilds the reference's benchmark image interchange format
(AccuracyBenchmark.jl:478-585 write, :694-799 read; GalsimBenchmark.jl:26-52
truth-from-headers): one image HDU per band, the fitted Gaussian-mixture PSF
serialized into header cards, per-band calibration/sky, and ground-truth
source parameters in CL* keys so an image file is self-describing for
accuracy scoring.

Header schema (per HDU):
  CLBAND   band index 0..4 (ugriz)
  CLIOTA   nelec_per_nmgy (scalar; per-row vectors are stored as the mean)
  CLSKY    sky level in nMgy (scalar; spatial skies stored as the median)
  CLPSFK   number of PSF mixture components
  CLP<k><f>    component k field f in {W (weight), X1, X2 (mean),
               V11, V12, V22 (covariance)}
  CLNSRC   number of truth sources (primary HDU only)
  CL<i><p> truth source i parameter p in {RA, DC, STR (is_star), FL<b>
           (flux band b), FDV, AXR, ANG, RAD (galaxy shape)}
  plus standard WCS cards (CRPIX/CRVAL/CD).
"""

import numpy as np

from ..io.fits import open_fits, write_fits
from ..io.wcs import LinearWCS, TanWCS
from ..models.image import CatalogEntry, Image
from ..models.psf import make_psf


def _psf_cards(psf):
    # packed rows [alpha, mu1, mu2, sigma11, sigma12, sigma22]
    psf = np.asarray(psf, dtype=np.float64)
    cards = {"CLPSFK": int(psf.shape[0])}
    for k in range(psf.shape[0]):
        for j, f in enumerate(("W", "X1", "X2", "V11", "V12", "V22")):
            cards[f"CLP{k}{f}"] = float(psf[k, j])
    return cards


def _psf_from_cards(hdr):
    K = int(hdr["CLPSFK"])
    alphas, mus, covs = [], [], []
    for k in range(K):
        alphas.append(float(hdr[f"CLP{k}W"]))
        mus.append([float(hdr[f"CLP{k}X1"]), float(hdr[f"CLP{k}X2"])])
        covs.append([[float(hdr[f"CLP{k}V11"]),
                      float(hdr[f"CLP{k}V12"])],
                     [float(hdr[f"CLP{k}V12"]),
                      float(hdr[f"CLP{k}V22"])]])
    return make_psf(alphas, np.asarray(mus), np.asarray(covs))


def _wcs_cards(wcs, tan):
    return {"CRPIX1": float(wcs.crpix[0]), "CRPIX2": float(wcs.crpix[1]),
            "CRVAL1": float(wcs.crval[0]), "CRVAL2": float(wcs.crval[1]),
            "CD1_1": float(wcs.cd[0, 0]), "CD1_2": float(wcs.cd[0, 1]),
            "CD2_1": float(wcs.cd[1, 0]), "CD2_2": float(wcs.cd[1, 1]),
            "CLWCSTAN": bool(tan)}


def _truth_cards(truth):
    cards = {"CLNSRC": len(truth)}
    for i, ce in enumerate(truth):
        cards[f"CL{i}RA"] = float(ce.pos[0])
        cards[f"CL{i}DC"] = float(ce.pos[1])
        cards[f"CL{i}STR"] = bool(ce.is_star)
        fluxes = ce.star_fluxes if ce.is_star else ce.gal_fluxes
        for b in range(5):
            cards[f"CL{i}FL{b}"] = float(fluxes[b])
        cards[f"CL{i}FDV"] = float(ce.gal_frac_dev)
        cards[f"CL{i}AXR"] = float(ce.gal_axis_ratio)
        cards[f"CL{i}ANG"] = float(ce.gal_angle)
        cards[f"CL{i}RAD"] = float(ce.gal_radius_px)
    return cards


def _truth_from_cards(hdr):
    n = int(hdr.get("CLNSRC", 0))
    out = []
    for i in range(n):
        fluxes = np.array([float(hdr[f"CL{i}FL{b}"]) for b in range(5)])
        out.append(CatalogEntry(
            pos=np.array([float(hdr[f"CL{i}RA"]), float(hdr[f"CL{i}DC"])]),
            is_star=bool(hdr[f"CL{i}STR"]),
            star_fluxes=fluxes, gal_fluxes=fluxes,
            gal_frac_dev=float(hdr[f"CL{i}FDV"]),
            gal_axis_ratio=float(hdr[f"CL{i}AXR"]),
            gal_angle=float(hdr[f"CL{i}ANG"]),
            gal_radius_px=float(hdr[f"CL{i}RAD"])))
    return out


def write_image_bundle(path, images, truth=()):
    """Write one HDU per Image with PSF/calibration/WCS headers and the
    ground-truth catalog in the primary HDU's CL* cards."""
    hdus = []
    for n, img in enumerate(images):
        cards = {"CLBAND": int(img.band),
                 "CLIOTA": float(np.mean(np.asarray(img.nelec_per_nmgy))),
                 "CLSKY": float(np.median(np.asarray(img.sky)))}
        cards.update(_psf_cards(img.psf))
        wcs = img.wcs if img.wcs is not None else LinearWCS()
        cards.update(_wcs_cards(wcs, isinstance(wcs, TanWCS)))
        if n == 0:
            cards.update(_truth_cards(list(truth)))
        hdus.append((np.asarray(img.pixels, np.float32),
                     list(cards.items())))
    write_fits(path, hdus)


def read_image_bundle(path):
    """Read a bundle back: (images, truth)."""
    hdus = open_fits(path)
    images, truth = [], []
    for n, hdu in enumerate(hdus):
        hdr = hdu.header
        if hdu.data is None or "CLBAND" not in hdr:
            continue
        wcs_cls = TanWCS if hdr.get("CLWCSTAN") else LinearWCS
        wcs = wcs_cls(
            crpix=[hdr["CRPIX1"], hdr["CRPIX2"]],
            crval=[hdr["CRVAL1"], hdr["CRVAL2"]],
            cd=np.array([[hdr["CD1_1"], hdr["CD1_2"]],
                         [hdr["CD2_1"], hdr["CD2_2"]]]))
        images.append(Image(
            pixels=np.asarray(hdu.data, np.float64), band=int(hdr["CLBAND"]),
            psf=_psf_from_cards(hdr), sky=float(hdr["CLSKY"]),
            nelec_per_nmgy=float(hdr["CLIOTA"]), wcs=wcs))
        if "CLNSRC" in hdr:
            truth = _truth_from_cards(hdr)
    return images, truth
