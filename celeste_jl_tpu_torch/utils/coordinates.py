"""Sky coordinate utilities (the port's copy of
celeste_jl_tpu/utils/coordinates.py, Coordinates.jl)."""

import numpy as np
from scipy.spatial import cKDTree

D2R = np.pi / 180.0


def angular_separation(ra1, dec1, ra2, dec2):
    """Great-circle separation in degrees (Vincenty formula,
    Coordinates.jl:15-26)."""
    l1, b1 = np.asarray(ra1) * D2R, np.asarray(dec1) * D2R
    l2, b2 = np.asarray(ra2) * D2R, np.asarray(dec2) * D2R
    dl = l2 - l1
    num = np.hypot(np.cos(b2) * np.sin(dl),
                   np.cos(b1) * np.sin(b2)
                   - np.sin(b1) * np.cos(b2) * np.cos(dl))
    den = np.sin(b1) * np.sin(b2) + np.cos(b1) * np.cos(b2) * np.cos(dl)
    return np.arctan2(num, den) / D2R


def _unit_vectors(ra, dec):
    ra = np.atleast_1d(np.asarray(ra, dtype=np.float64)) * D2R
    dec = np.atleast_1d(np.asarray(dec, dtype=np.float64)) * D2R
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=1)


def match_coordinates(ra1, dec1, ra2, dec2):
    """For each (ra1, dec1), the index of the nearest (ra2, dec2) and its
    angular distance in degrees — via a 3-D unit-vector KD-tree
    (Coordinates.jl:71-86)."""
    xyz1 = _unit_vectors(ra1, dec1)
    xyz2 = _unit_vectors(ra2, dec2)
    tree = cKDTree(xyz2)
    chord, idx = tree.query(xyz1, k=1)
    dist = 2.0 * np.arcsin(np.clip(chord / 2.0, 0.0, 1.0)) / D2R
    return idx, dist
