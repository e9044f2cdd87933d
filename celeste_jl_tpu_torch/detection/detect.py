"""Multi-image source detection (the port's copy of
celeste_jl_tpu/detection/detect.py, detection.jl:39-171).

Per image: background RMS estimate -> extract at 1.3 sigma. Across images:
union detections by 1-arcsec world-coordinate matching; initialize a
CatalogEntry from the best (most-pixels) detection per band.
"""

import numpy as np

from ..models.image import CatalogEntry, Image
from ..utils.coordinates import match_coordinates
from .background import Background
from .extract import extract


def calibrated_pixels(img: Image):
    """Sky-subtracted pixels in nMgy (image_model.jl:56 equivalent)."""
    io_ = img.nelec_per_nmgy
    iota = (np.asarray(io_)[:, None] if np.ndim(io_) == 1
            else np.asarray(io_))
    sky = img.sky if np.ndim(img.sky) == 2 else np.full(img.pixels.shape,
                                                        img.sky)
    return img.pixels / iota - sky


def _x_vs_n_angle(img: Image):
    """Angle of the +axis1 direction CCW from North (detection.jl:23-29)."""
    if img.wcs is None:
        return 0.0
    cd = img.wcs.cd
    sgn = np.sign(np.linalg.det(cd))
    n_vs_y_rot = np.arctan2(sgn * cd[0, 1], sgn * cd[0, 0])
    return -(n_vs_y_rot + np.pi / 2.0)


def detect_sources(images, thresh=1.3, boxsize=(256, 256), minarea=5,
                   match_arcsec=1.0, match_radius_deg=None):
    """Returns (catalog: list[CatalogEntry], detection boxes per source per
    image: list of dicts image_index -> (xmin, xmax, ymin, ymax)).

    Cross-image detections within 1 arcsec are merged (detection.jl:87).
    For identity-WCS test images pass match_radius_deg explicitly (world
    units are pixels there)."""
    if match_radius_deg is None:
        match_radius_deg = match_arcsec / 3600.0
    catalogs = []
    for img in images:
        cal = calibrated_pixels(img)
        bkg = Background(cal, boxsize=boxsize, filtersize=(3, 3))
        catalogs.append(extract(cal, thresh, noise=bkg.global_rms(),
                                minarea=minarea))

    worldcoords = []
    for img, cat in zip(images, catalogs):
        wc = np.array([img.pix_to_world([x, y])
                       for x, y in zip(cat.x, cat.y)]).reshape(-1, 2)
        worldcoords.append(wc)

    # union by world-coordinate matching
    joined = list(worldcoords[0]) if images else []
    detections = [[(0, j)] for j in range(len(catalogs[0].x))] if images else []
    for i in range(1, len(images)):
        wc = worldcoords[i]
        if len(wc) == 0:
            continue
        if joined:
            ja = np.array(joined)
            idx, dist = match_coordinates(wc[:, 0], wc[:, 1],
                                          ja[:, 0], ja[:, 1])
        else:
            idx, dist = np.zeros(len(wc), int), np.full(len(wc), np.inf)
        for j in range(len(wc)):
            if dist[j] < match_radius_deg:
                detections[idx[j]].append((i, j))
            else:
                joined.append(wc[j])
                detections.append([(i, j)])

    n_bands = max((img.band for img in images), default=-1) + 1
    x_vs_n = [_x_vs_n_angle(img) for img in images]
    result = []
    boxes = []
    for i, world_center in enumerate(joined):
        best = [(-1, -1)] * n_bands
        npix = [0] * n_bands
        for (j, catidx) in detections[i]:
            b = images[j].band
            np_ = int(catalogs[j].npix[catidx])
            if np_ > npix[b]:
                best[b] = (j, catidx)
                npix[b] = np_
        gal_fluxes = np.array(
            [catalogs[j].flux[catidx] if j >= 0 else 0.0
             for (j, catidx) in best])
        star_fluxes = gal_fluxes.copy()

        j, catidx = best[int(np.argmax(npix))]
        gal_axis_ratio = float(catalogs[j].b[catidx] / catalogs[j].a[catidx])
        gal_angle = float(catalogs[j].theta[catidx]) + x_vs_n[j]
        sigma = np.sqrt(catalogs[j].a[catidx] * catalogs[j].b[catidx])
        gal_radius_px = float(sigma * np.sqrt(2.0 * np.log(2.0)))

        result.append(CatalogEntry(
            pos=np.asarray(world_center, dtype=np.float64), is_star=False,
            star_fluxes=star_fluxes, gal_fluxes=gal_fluxes,
            gal_frac_dev=0.5, gal_axis_ratio=gal_axis_ratio,
            gal_angle=gal_angle, gal_radius_px=gal_radius_px))

        bx = {}
        for (j, catidx) in detections[i]:
            bx[j] = (int(catalogs[j].xmin[catidx]),
                     int(catalogs[j].xmax[catidx]),
                     int(catalogs[j].ymin[catidx]),
                     int(catalogs[j].ymax[catidx]))
        boxes.append(bx)
    return result, boxes
