"""Synthetic patch batches for benchmarks and smoke runs (port of
celeste_jl_tpu/synthetic.synthetic_patch_batch).

The truth and the Poisson noise are drawn from numpy's default_rng(seed)
in the JAX package's order, so both packages make the same batch; the
expected tiles are rendered with torch on the caller's device.
"""

import numpy as np
import torch

from celeste_jl_tpu.models.image import CatalogEntry
from celeste_jl_tpu.vi.init import generic_init_source

from .models.fsm import galaxy_density_grid, star_density_grid
from .models.patches import SkyPatch
from .models.psf import gaussian_psf


def flux_from_colors(r_flux, colors):
    """5-band fluxes from an r-band flux and 4 log color ratios
    (Synthetic.jl:66-77)."""
    l = np.zeros(5)
    l[2] = r_flux
    l[3] = l[2] * np.exp(colors[2])
    l[4] = l[3] * np.exp(colors[3])
    l[1] = l[2] / np.exp(colors[1])
    l[0] = l[1] / np.exp(colors[0])
    return l


def synthetic_patch_batch(n_sources, tile=32, radius=None, sky_nmgy=0.1,
                          nelec_per_nmgy=1000.0, seed=0, n_bands=5, psf=None,
                          star_fraction=0.5, dtype=np.float32, *, device):
    """(catalog, vp0s (S, 44) numpy, SkyPatch of tensors on `device`) for
    `n_sources` independent sources, each centered on its own
    (n_bands, tile, tile) patch. Truth per source: r-band flux log-uniform
    in [10, 80] nMgy, colors near zero, galaxy shape from broad ranges."""
    rng = np.random.default_rng(seed)
    radius = radius if radius is not None else tile // 2 - 2
    psf = np.asarray(psf if psf is not None else gaussian_psf(), dtype=dtype)
    K = psf.shape[0]
    ctr = (tile + 1) / 2.0

    pos = ctr + rng.uniform(-0.5, 0.5, size=(n_sources, 2))
    is_star = rng.uniform(size=n_sources) < star_fraction
    r_flux = np.exp(rng.uniform(np.log(10.0), np.log(80.0), size=n_sources))
    colors = rng.normal(0.0, 0.2, size=(n_sources, 4))
    frac_dev = rng.uniform(0.1, 0.9, size=n_sources)
    axis_ratio = rng.uniform(0.3, 0.95, size=n_sources)
    angle = rng.uniform(0.0, np.pi, size=n_sources)
    radius_px = np.exp(rng.uniform(np.log(0.7), np.log(3.0), size=n_sources))

    catalog = []
    for s in range(n_sources):
        fluxes = flux_from_colors(r_flux[s], colors[s])
        catalog.append(CatalogEntry(
            pos=pos[s], is_star=bool(is_star[s]),
            star_fluxes=fluxes if is_star[s] else np.maximum(fluxes, 0.1),
            gal_fluxes=np.maximum(fluxes, 0.1) if is_star[s] else fluxes,
            gal_frac_dev=frac_dev[s], gal_axis_ratio=axis_ratio[s],
            gal_angle=angle[s], gal_radius_px=radius_px[s]))

    # patch metadata: identity WCS, tile corner at 0
    B, S = n_bands, n_sources
    zeros = np.zeros((S, B, 2), dtype=np.int32)
    jac = np.broadcast_to(np.eye(2, dtype=dtype), (S, B, 2, 2))
    wc = np.broadcast_to(pos[:, None, :].astype(dtype), (S, B, 2))
    psf_b = np.broadcast_to(psf, (S, B, K, 6))
    sky = np.full((S, B, tile, tile), sky_nmgy, dtype=dtype)
    iota = np.full((S, B, tile, tile), nelec_per_nmgy, dtype=dtype)
    ii = np.arange(1, tile + 1, dtype=dtype)
    inbox = ((np.abs(ii[:, None] - ctr) <= radius)
             & (np.abs(ii[None, :] - ctr) <= radius))
    mask = np.broadcast_to(inbox, (S, B, tile, tile))

    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    shapes = t(np.stack([frac_dev, axis_ratio, angle, radius_px],
                        axis=1).astype(dtype))[:, None]          # (S, 1, 4)
    fluxes = t(np.stack([ce.star_fluxes if ce.is_star else ce.gal_fluxes
                         for ce in catalog]).astype(dtype))      # (S, B)
    pos_t = t(pos.astype(dtype))[:, None]                        # (S, 1, 2)
    eye = torch.eye(2, dtype=tdtype, device=device)
    off = torch.zeros(2, dtype=torch.int32, device=device)
    args = (t(psf_b), eye, pos_t, pos_t, off, tile)
    fs0 = star_density_grid(pos_t, *args)
    fs1 = galaxy_density_grid(pos_t, shapes[..., 0], shapes[..., 1],
                              shapes[..., 2], shapes[..., 3], *args)
    star = t(is_star)[:, None, None, None]
    nmgy = fluxes[..., None, None] * torch.where(star, fs0, fs1)
    electrons = (nmgy.cpu().numpy() + sky_nmgy) * nelec_per_nmgy
    pixels = rng.poisson(np.maximum(electrons, 0.0)).astype(dtype)

    patches = SkyPatch(pixels=t(pixels), mask=t(mask), sky=t(sky),
                       iota=t(iota), offset=t(zeros), wcs_jacobian=t(jac),
                       world_center=t(wc), pixel_center=t(wc), psf=t(psf_b))
    vp0s = np.stack([generic_init_source(ce.pos) for ce in catalog])
    return catalog, vp0s.astype(dtype), patches
