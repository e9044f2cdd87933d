"""Survey image container + catalog entry (host-side, numpy; the port's
copy of celeste_jl_tpu/models/image.py).

Counterpart of model/image_model.jl (Image) and
model/light_source_model.jl:10-19 (CatalogEntry).
"""

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class Image:
    pixels: np.ndarray                 # (H, W) raw electron counts
    band: int                          # 0..4 (u g r i z)
    psf: np.ndarray                    # (K, 6) packed PSF mixture
    sky: Any = 0.0                     # scalar or (H, W), nMgy
    nelec_per_nmgy: Any = 1.0          # scalar or (H,) per-row calibration
    wcs: Optional[Any] = None          # None = identity WCS
    # optional provenance (SDSS run/camcol/field)
    meta: dict = field(default_factory=dict)

    @property
    def H(self):
        return self.pixels.shape[0]

    @property
    def W(self):
        return self.pixels.shape[1]

    def sky_at(self, i, j):
        s = self.sky
        return s[i, j] if np.ndim(s) == 2 else s

    def iota_at(self, i):
        io = self.nelec_per_nmgy
        return io[i] if np.ndim(io) == 1 else io

    def world_to_pix(self, world):
        if self.wcs is None:
            return np.asarray(world, dtype=np.float64)
        return self.wcs.world_to_pix(world)

    def pix_to_world(self, pix):
        if self.wcs is None:
            return np.asarray(pix, dtype=np.float64)
        return self.wcs.pix_to_world(pix)

    def wcs_jacobian(self, pix):
        if self.wcs is None:
            return np.eye(2)
        return self.wcs.pixel_world_jacobian(pix)


@dataclass
class CatalogEntry:
    pos: np.ndarray                    # (2,) world coords
    is_star: bool
    star_fluxes: np.ndarray            # (5,) nMgy
    gal_fluxes: np.ndarray             # (5,) nMgy
    gal_frac_dev: float = 0.5
    gal_axis_ratio: float = 0.7
    gal_angle: float = 0.0
    gal_radius_px: float = 1.0
    objid: str = ""
