"""World Coordinate System transforms: linear and TAN (gnomonic); the
port's copy of celeste_jl_tpu/io/wcs.py.

Replaces the wcslib C dependency. The reference only ever needs pix<->world
plus the local 2x2 Jacobian (model/wcs_utils.jl); SDSS frames use RA---TAN /
DEC--TAN with a CD matrix, which this implements exactly in numpy.

Conventions: `pix` is 1-based (FITS), ordered (axis1, axis2); `world` is
(ra, dec) in degrees. Every transform is shape-polymorphic over a trailing
axis of 2: a (S, 2) batch of coordinates transforms in one call (the host
staging path feeds whole catalogs at once; see models/patches.py).
"""

import numpy as np

D2R = np.pi / 180.0
R2D = 180.0 / np.pi


class LinearWCS:
    """world = crval + cd @ (pix - crpix); identity-like test WCS."""

    def __init__(self, crpix=(0.0, 0.0), crval=(0.0, 0.0), cd=None):
        self.crpix = np.asarray(crpix, dtype=np.float64)
        self.crval = np.asarray(crval, dtype=np.float64)
        self.cd = np.asarray(cd if cd is not None else np.eye(2),
                             dtype=np.float64)
        self._cd_inv = np.linalg.inv(self.cd)

    def pix_to_world(self, pix):
        pix = np.asarray(pix, dtype=np.float64)
        return self.crval + (pix - self.crpix) @ self.cd.T

    def world_to_pix(self, world):
        world = np.asarray(world, dtype=np.float64)
        return self.crpix + (world - self.crval) @ self._cd_inv.T

    def pixel_world_jacobian(self, pix):
        pix = np.asarray(pix)
        if pix.ndim == 1:
            return self._cd_inv.copy()
        return np.broadcast_to(self._cd_inv,
                               pix.shape[:-1] + (2, 2)).copy()


class TanWCS:
    """Gnomonic projection with a CD matrix (RA---TAN / DEC--TAN)."""

    def __init__(self, crpix, crval, cd):
        self.crpix = np.asarray(crpix, dtype=np.float64)   # (x, y) 1-based
        self.crval = np.asarray(crval, dtype=np.float64)   # (ra, dec) deg
        self.cd = np.asarray(cd, dtype=np.float64)         # deg / pixel
        self._cd_inv = np.linalg.inv(self.cd)

    @classmethod
    def from_header(cls, hdr):
        cd = np.array([[hdr.get("CD1_1", 1.0), hdr.get("CD1_2", 0.0)],
                       [hdr.get("CD2_1", 0.0), hdr.get("CD2_2", 1.0)]])
        return cls(crpix=[hdr.get("CRPIX1", 0.0), hdr.get("CRPIX2", 0.0)],
                   crval=[hdr.get("CRVAL1", 0.0), hdr.get("CRVAL2", 0.0)],
                   cd=cd)

    def pix_to_world(self, pix):
        pix = np.asarray(pix, dtype=np.float64)
        uv = (pix - self.crpix) @ self.cd.T     # intermediate coords, deg
        xi, eta = uv[..., 0] * D2R, uv[..., 1] * D2R   # radians
        ra0, dec0 = self.crval * D2R
        denom = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, denom)
        dec = np.arctan2(np.sin(dec0) + eta * np.cos(dec0),
                         np.sqrt(xi ** 2 + denom ** 2))
        return np.stack([np.mod(ra * R2D, 360.0), dec * R2D], axis=-1)

    def world_to_pix(self, world):
        world = np.asarray(world, dtype=np.float64)
        ra, dec = world[..., 0] * D2R, world[..., 1] * D2R
        ra0, dec0 = self.crval * D2R
        dra = ra - ra0
        d = (np.sin(dec) * np.sin(dec0)
             + np.cos(dec) * np.cos(dec0) * np.cos(dra))
        xi = np.cos(dec) * np.sin(dra) / d
        eta = (np.sin(dec) * np.cos(dec0)
               - np.cos(dec) * np.sin(dec0) * np.cos(dra)) / d
        uv = np.stack([xi, eta], axis=-1) * R2D
        return self.crpix + uv @ self._cd_inv.T

    def pixel_world_jacobian(self, pix, pixel_delt=0.5):
        """Jacobian d(pixel)/d(world) by central differences at `pix`
        (matches pixel_world_jacobian, model/wcs_utils.jl:36-51).
        Shape-polymorphic: (..., 2) pix -> (..., 2, 2)."""
        pix = np.asarray(pix, dtype=np.float64)
        world = self.pix_to_world(pix)
        step = self.pix_to_world(pix + pixel_delt) - world
        wd = np.max(np.abs(step), axis=-1, keepdims=True)
        e1 = np.concatenate([wd, np.zeros_like(wd)], axis=-1)
        e2 = np.concatenate([np.zeros_like(wd), wd], axis=-1)
        col1 = (self.world_to_pix(world + e1) - pix) / wd
        col2 = (self.world_to_pix(world + e2) - pix) / wd
        return np.stack([col1, col2], axis=-1)


def wcs_from_header(hdr):
    ctype1 = str(hdr.get("CTYPE1", "")).strip()
    if "TAN" in ctype1:
        return TanWCS.from_header(hdr)
    return LinearWCS(crpix=[hdr.get("CRPIX1", 0.0), hdr.get("CRPIX2", 0.0)],
                     crval=[hdr.get("CRVAL1", 0.0), hdr.get("CRVAL2", 0.0)],
                     cd=np.array([[hdr.get("CD1_1", 1.0), hdr.get("CD1_2", 0.0)],
                                  [hdr.get("CD2_1", 0.0), hdr.get("CD2_2", 1.0)]]))
