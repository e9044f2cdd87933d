"""Patch radii and the neighbor graph of a catalog (port of
celeste_jl_tpu/parallel/state.py:37-94, host-side numpy)."""

import math

import numpy as np

from ..models.image import CatalogEntry
from ..models.psf import get_psf_width
from ..utils.config import Config
from .common import MAX_PATCH_RADIUS


def choose_patch_radius(ce: CatalogEntry, img, width_scale=1.0,
                        max_radius=MAX_PATCH_RADIUS):
    """Radius (px) capturing ~90% of the source light or reaching 5% of sky
    noise, whichever is larger (imaged_sources.jl:197-223 semantics)."""
    psf_width = get_psf_width(img.psf, width_scale=width_scale)
    obj_width = (0.0 if ce.is_star
                 else width_scale * ce.gal_radius_px / 0.67) + psf_width
    flux = (ce.star_fluxes if ce.is_star else ce.gal_fluxes)[img.band]
    flux = max(float(flux), 1e-6)
    eps = float(img.sky_at(img.H // 2, img.W // 2))
    pdf_90 = math.exp(-0.5 * 1.64 ** 2) / (math.sqrt(2 * math.pi) * obj_width)
    pdf_target = min(pdf_90, eps / (20.0 * flux))
    rhs = math.log(pdf_target) + 0.5 * math.log(2 * math.pi) \
        + math.log(obj_width)
    radius_req = math.sqrt(max(-2.0 * obj_width ** 2 * rhs, 0.0))
    return min(radius_req, max_radius)


def patch_radii(catalog, images, config: Config):
    """Per-source radius: max over images, floored at config.min_radius_pix."""
    return np.array([
        max(config.min_radius_pix,
            max(choose_patch_radius(ce, img) for img in images))
        for ce in catalog])


def find_neighbors(catalog, radii, images):
    """neighbor_map: source index -> indices whose patch boxes overlap in any
    image (imaged_sources.jl:232-244). Candidate pairs come from a
    Chebyshev-metric KDTree ball query at the maximal radius sum, then each
    candidate is checked with its own per-pair radius sum."""
    from scipy.spatial import cKDTree

    S = len(catalog)
    radii = np.asarray(radii, dtype=np.float64)
    nb = {s: [] for s in range(S)}
    if S < 2:
        return nb
    pairs = set()
    r_max2 = 2.0 * radii.max()
    for img in images:
        centers = np.stack([np.asarray(img.world_to_pix(ce.pos), np.float64)
                            for ce in catalog])  # (S, 2)
        tree = cKDTree(centers)
        for i, j in tree.query_pairs(r=r_max2, p=np.inf):
            if (i, j) in pairs:
                continue
            if np.all(np.abs(centers[i] - centers[j]) <= radii[i] + radii[j]):
                pairs.add((i, j))
    for i, j in pairs:
        nb[i].append(j)
        nb[j].append(i)
    for s in nb:
        nb[s].sort()
    return nb
