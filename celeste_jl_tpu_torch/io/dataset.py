"""Survey dataset abstraction and sky bounding boxes (the port's copy of
celeste_jl_tpu/io/dataset.py, dataset.jl)."""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoundingBox:
    """An RA/Dec box on the sky, degrees (dataset.jl:1-22)."""
    ramin: float
    ramax: float
    decmin: float
    decmax: float

    @classmethod
    def from_strings(cls, ramin, ramax, decmin, decmax):
        return cls(float(ramin), float(ramax), float(decmin), float(decmax))

    def contains(self, ra, dec):
        return ((self.ramin < np.asarray(ra)) & (np.asarray(ra) < self.ramax)
                & (self.decmin < np.asarray(dec))
                & (np.asarray(dec) < self.decmax))


class SurveyDataSet:
    """Abstract survey dataset: knows how to load calibrated images covering
    a BoundingBox (dataset.jl:35-39). Concrete: SDSSDataSet (io/sdss.py),
    DECALSDataSet (io/decals.py)."""

    def load_images(self, box: BoundingBox):
        raise NotImplementedError
