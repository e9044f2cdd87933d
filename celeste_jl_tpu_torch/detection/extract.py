"""Source extraction: thresholded segmentation + ellipse moments (the
port's copy of celeste_jl_tpu/detection/extract.py).

SEP.extract equivalent (SEP.jl:341, 261-286): threshold at k*noise,
8-connected components, flux-weighted first/second moments -> x, y, a, b,
theta, flux, npix, bounding box. Coordinates are 1-based (axis1, axis2),
matching the model's pixel convention.
"""

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from . import _native


@dataclass
class Catalog:
    x: np.ndarray        # (N,) 1-based centroid along axis 1
    y: np.ndarray        # (N,) 1-based centroid along axis 2
    a: np.ndarray        # semi-major axis (px)
    b: np.ndarray        # semi-minor axis (px)
    theta: np.ndarray    # CCW angle from +axis1, in [-pi/2, pi/2]
    flux: np.ndarray
    npix: np.ndarray
    xmin: np.ndarray
    xmax: np.ndarray
    ymin: np.ndarray
    ymax: np.ndarray

    def __len__(self):
        return len(self.x)


DEFAULT_KERNEL = np.array([[1.0, 2.0, 1.0],
                           [2.0, 4.0, 2.0],
                           [1.0, 2.0, 1.0]])


def extract(data, thresh, noise=None, minarea=5, deblend=True,
            deblend_nthresh=32, deblend_cont=0.005, filter_kernel="default",
            use_native=None):
    """Extract sources from `data` at threshold thresh*noise.

    If `noise` is None, thresh is an absolute threshold. Detection runs on a
    matched-filtered image (SEP's default 3x3 kernel) with the noise scaled
    accordingly; moments/fluxes use the unfiltered data.
    `deblend`: split saddle-connected blends via multi-threshold re-labeling
    (scoped version of SExtractor deblending).
    """
    data = np.asarray(data, dtype=np.float64)
    t = thresh * noise if noise is not None else thresh

    if filter_kernel is not None:
        k = DEFAULT_KERNEL if isinstance(filter_kernel, str) else \
            np.asarray(filter_kernel, dtype=np.float64)
        det_img = ndimage.convolve(np.nan_to_num(data), k / k.sum(),
                                   mode="constant")
        # matched filtering reduces pixel noise by |k|_2 / |k|_1
        det_t = t * np.sqrt((k ** 2).sum()) / k.sum()
    else:
        det_img, det_t = data, t
    above = np.isfinite(data) & (det_img > det_t)

    if use_native is None:
        use_native = _native.available()
    if use_native:
        labels, nlab = _native.label(above)
    else:
        structure = np.ones((3, 3), dtype=int)  # 8-connectivity
        labels, nlab = ndimage.label(above, structure=structure)
    if nlab == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return Catalog(z, z, z, z, z, z, zi, zi, zi, zi, zi)

    # Work per-object on bounding-box crops (as SEP does on its extracted
    # pixel lists): the multi-threshold deblender re-labels a segment up to
    # nthresh times, and doing that on full-frame arrays is O(HW) per level
    # per object — measured 56 s of ndimage.label on a 512x512 128-source
    # field vs <1 s on crops.
    rows = []
    for sl, lab in zip(ndimage.find_objects(labels), range(1, nlab + 1)):
        if sl is None:
            continue
        mask_c = labels[sl] == lab
        if mask_c.sum() < minarea:
            continue
        data_c = data[sl]
        off = (sl[0].start, sl[1].start)
        if deblend:
            segs = _deblend(data_c, mask_c, t, deblend_nthresh,
                            deblend_cont, minarea)
        else:
            segs = [mask_c]
        rows.extend(_moments(data_c, m, off) for m in segs)
    if not rows:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return Catalog(z, z, z, z, z, z, zi, zi, zi, zi, zi)
    cols = list(zip(*rows))
    return Catalog(
        x=np.array(cols[0]), y=np.array(cols[1]), a=np.array(cols[2]),
        b=np.array(cols[3]), theta=np.array(cols[4]), flux=np.array(cols[5]),
        npix=np.array(cols[6], dtype=np.int64),
        xmin=np.array(cols[7], dtype=np.int64),
        xmax=np.array(cols[8], dtype=np.int64),
        ymin=np.array(cols[9], dtype=np.int64),
        ymax=np.array(cols[10], dtype=np.int64))


def _deblend(data, mask, t, nthresh, cont, minarea):
    """Multi-threshold deblending of one segment: raise the threshold
    exponentially; if the segment splits into >=2 children each holding at
    least `cont` of the total flux, recurse into the children.

    Exact pruning that removes the per-level relabeling for most segments:
    when the ladder splits a segment at level L, each child component's
    peak pixel is >= all its 8-neighbors (out-of-child neighbors are below
    L by construction) — i.e. a LOCAL MAX of the crop above L. So a
    segment with a single local max above t can never split (return
    immediately, no label calls — the common isolated-source case,
    measured ~20k ndimage.label calls -> ~1k on the 128-source field), and
    no level at or above the second-highest local max can split either
    (cap the ladder there)."""
    total = data[mask].sum()
    peak = data[mask].max()
    if peak <= t or total <= 0:
        return [mask]
    locmax = mask & (data > t) & (
        data >= ndimage.maximum_filter(np.nan_to_num(data, nan=-np.inf),
                                       size=3, mode="constant", cval=-np.inf))
    n_max = int(locmax.sum())
    if n_max < 2:
        return [mask]
    second = np.partition(data[locmax], n_max - 2)[n_max - 2]
    structure = np.ones((3, 3), dtype=int)
    levels = t * (peak / t) ** (np.arange(1, nthresh) / nthresh)
    levels = levels[levels < second]
    for lev in levels:
        sub = mask & (data > lev)
        labels, n = ndimage.label(sub, structure=structure)
        if n >= 2:
            kids = []
            for lab in range(1, n + 1):
                km = labels == lab
                if km.sum() >= minarea and data[km].sum() >= cont * total:
                    kids.append(km)
            if len(kids) >= 2:
                # assign every original pixel to the nearest child peak
                out = []
                assigned = np.zeros(data.shape, dtype=np.int32)
                for ki, km in enumerate(kids, start=1):
                    assigned[km] = ki
                # grow children over the remaining segment pixels
                rest = mask & (assigned == 0)
                if rest.any():
                    idx = ndimage.distance_transform_edt(
                        assigned == 0, return_distances=False,
                        return_indices=True)
                    assigned = np.where(mask, assigned[tuple(idx)], 0)
                for ki in range(1, len(kids) + 1):
                    out.extend(_deblend(data, assigned == ki, lev, nthresh,
                                        cont, minarea))
                return out
    return [mask]


def _moments(data, mask, offset=(0, 0)):
    """Ellipse moments of one segment. `data`/`mask` may be bounding-box
    crops; `offset` is the crop origin in the full frame."""
    ii0, jj0 = np.nonzero(mask)
    vals = np.maximum(data[ii0, jj0], 0.0)
    ii = ii0 + offset[0]
    jj = jj0 + offset[1]
    flux = vals.sum()
    w = vals / flux if flux > 0 else np.full(vals.shape, 1.0 / len(vals))
    x = (w * (ii + 1.0)).sum()   # 1-based
    y = (w * (jj + 1.0)).sum()
    dx = ii + 1.0 - x
    dy = jj + 1.0 - y
    x2 = (w * dx * dx).sum() + 1.0 / 12.0   # pixelization variance
    y2 = (w * dy * dy).sum() + 1.0 / 12.0
    xy = (w * dx * dy).sum()
    half = 0.5 * (x2 + y2)
    root = np.sqrt(max(0.25 * (x2 - y2) ** 2 + xy ** 2, 0.0))
    a = np.sqrt(max(half + root, 1e-12))
    b = np.sqrt(max(half - root, 1e-12))
    theta = 0.5 * np.arctan2(2.0 * xy, x2 - y2)
    return (x, y, a, b, theta, flux, len(ii),
            ii.min() + 1, ii.max() + 1, jj.min() + 1, jj.max() + 1)
