"""Synthetic scenes for benchmarks and smoke runs (port of
celeste_jl_tpu/synthetic.py: render_source_nmgy, gen_image, gen_images,
synthetic_patch_batch, make_blank_images, sample_star, sample_galaxy,
gen_images_fast; ais_bench_scene is the scene of benchmark/bench_mcmc.py).

The truth and the Poisson noise are drawn from numpy's default_rng(seed)
in the JAX package's order, so both packages make the same scene; the
expected tiles are rendered with torch on the caller's device.
"""

import numpy as np
import torch

from .models.fsm import galaxy_density_grid, star_density_grid
from .models.image import CatalogEntry, Image
from .models.patches import (SkyPatch, make_patch_for_source,
                             make_patches_batched)
from .models.psf import gaussian_psf
from .utils.device import resolve
from .vi.init import generic_init_source


def render_source_nmgy(img: Image, ce: CatalogEntry, tile_size=None,
                       radius=25, *, device="cuda"):
    """Expected nMgy image contribution of one source (whole image), a
    float64 numpy (H, W) array: the source's unit-flux tile (P = tile_size,
    default 2 radius + 8) rendered in f64 on `device` with the model's own
    density grids, times its flux, scattered into the image."""
    dev = resolve(device)
    H, W = img.H, img.W
    P = tile_size or int(2 * radius + 8)
    patch = make_patch_for_source([img], ce.pos, radius, P)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a[0]), device=dev)
    args = (t(patch.psf), t(patch.wcs_jacobian), t(patch.world_center),
            t(patch.pixel_center), t(patch.offset), P)
    pos = torch.as_tensor(np.asarray(ce.pos, np.float64), device=dev)
    if ce.is_star:
        dens = star_density_grid(pos, *args)
        flux = ce.star_fluxes[img.band]
    else:
        shape = [torch.tensor(float(v), dtype=torch.float64, device=dev)
                 for v in (ce.gal_frac_dev, ce.gal_axis_ratio, ce.gal_angle,
                           ce.gal_radius_px)]
        dens = galaxy_density_grid(pos, *shape, *args)
        flux = ce.gal_fluxes[img.band]
    tile = dens.cpu().numpy() * float(flux)

    out = np.zeros((H, W))
    off = np.asarray(patch.offset[0])
    i0, i1 = max(0, off[0]), min(H, off[0] + P)
    j0, j1 = max(0, off[1]), min(W, off[1] + P)
    if i0 < i1 and j0 < j1:
        out[i0:i1, j0:j1] = tile[i0 - off[0]:i1 - off[0],
                                 j0 - off[1]:j1 - off[1]]
    return out


def gen_image(img: Image, bodies, expectation=False, rng=None, *,
              device="cuda"):
    """Overwrite img.pixels with a synthetic render of `bodies`: each
    source's render_source_nmgy on `device`, the sky added, Poisson counts
    drawn from `rng` (default numpy's default_rng(42)), as the JAX
    package draws them."""
    rng = rng or np.random.default_rng(42)
    s = img.sky
    nmgy = (np.array(s, dtype=np.float64) * np.ones((img.H, img.W))
            if np.ndim(s) != 2 else np.array(s, dtype=np.float64))
    for ce in bodies:
        nmgy += render_source_nmgy(img, ce, device=device)
    io_ = img.nelec_per_nmgy
    electrons = nmgy * (np.asarray(io_)[:, None] if np.ndim(io_) == 1 else io_)
    img.pixels = electrons if expectation else rng.poisson(
        electrons).astype(np.float64)
    return img


def gen_images(images, bodies, expectation=False, seed=42, *,
               device="cuda"):
    """gen_image on each image in turn, all drawing from one
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    for img in images:
        gen_image(img, bodies, expectation=expectation, rng=rng,
                  device=device)
    return images


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


def make_blank_images(H=40, W=40, sky_nmgy=0.1, nelec_per_nmgy=1000.0,
                      psf=None, n_bands=5):
    psf = psf if psf is not None else gaussian_psf()
    return [Image(pixels=np.zeros((H, W)), band=b, psf=psf, sky=sky_nmgy,
                  nelec_per_nmgy=nelec_per_nmgy) for b in range(n_bands)]


def sample_star(pos=(20.0, 20.0), r_flux=10.0):
    """A star catalog entry with colors at zero."""
    fluxes = flux_from_colors(r_flux, np.zeros(4))
    return CatalogEntry(pos=np.asarray(pos, dtype=np.float64), is_star=True,
                        star_fluxes=fluxes, gal_fluxes=np.maximum(fluxes, 0.1))


def sample_galaxy(pos=(20.0, 20.0), r_flux=10.0, gal_frac_dev=0.3,
                  gal_axis_ratio=0.7, gal_angle=0.5, gal_radius_px=2.0):
    fluxes = flux_from_colors(r_flux, np.zeros(4))
    return CatalogEntry(pos=np.asarray(pos, dtype=np.float64), is_star=False,
                        star_fluxes=np.maximum(fluxes, 0.1),
                        gal_fluxes=fluxes, gal_frac_dev=gal_frac_dev,
                        gal_axis_ratio=gal_axis_ratio, gal_angle=gal_angle,
                        gal_radius_px=gal_radius_px)


def gen_images_fast(images, bodies, expectation=False, seed=42, radius=25,
                    *, device, psfs=None):
    """Overwrite each image's pixels with a render of `bodies` plus its sky,
    Poisson-sampled (Synthetic.jl:30-47): per band, every source's unit-flux
    tile (P = 2 radius + 8) is rendered in f64 on `device` in one batched
    call per source type, the tiles are added host-side in `bodies` order,
    and numpy's default_rng(seed) draws the counts image by image, as the
    JAX package does. psfs: optional (S, B, K, 6) PSF of each source in
    each band (a spatially varying PSF); default each image's PSF."""
    rng = np.random.default_rng(seed)
    S = len(bodies)
    P = int(2 * radius + 8)
    is_star = np.array([ce.is_star for ce in bodies], dtype=bool)
    if S:
        positions = np.array([np.asarray(ce.pos, np.float64) for ce in bodies])
        patches = make_patches_batched(images, positions,
                                       np.full(S, float(radius)), P,
                                       psfs=psfs)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        field = lambda f: np.stack([getattr(p, f) for p in patches])
        psf, jac, wc, pc, off = (t(field(f)) for f in (
            "psf", "wcs_jacobian", "world_center", "pixel_center", "offset"))
        shape = t(np.array([[ce.gal_frac_dev, ce.gal_axis_ratio, ce.gal_angle,
                             ce.gal_radius_px] for ce in bodies],
                           dtype=np.float64))[:, None]            # (S, 1, 4)
        pos = t(positions)[:, None]                                # (S, 1, 2)
        args = (psf, jac, wc, pc, off, P)
        star = t(is_star)[:, None, None, None]
        tiles = torch.where(
            star, star_density_grid(pos, *args),
            galaxy_density_grid(pos, shape[..., 0], shape[..., 1],
                                shape[..., 2], shape[..., 3], *args)
        ).cpu().numpy()                                            # (S, B, P, P)
        offs = field("offset")

    for b, img in enumerate(images):
        H, W = img.H, img.W
        s = img.sky
        nmgy = (np.array(s, dtype=np.float64) * np.ones((H, W))
                if np.ndim(s) != 2 else np.array(s, dtype=np.float64))
        for si, ce in enumerate(bodies):
            flux = (ce.star_fluxes if ce.is_star else ce.gal_fluxes)[img.band]
            o = offs[si, b]
            i0, i1 = max(0, o[0]), min(H, o[0] + P)
            j0, j1 = max(0, o[1]), min(W, o[1] + P)
            if i0 < i1 and j0 < j1:
                nmgy[i0:i1, j0:j1] += float(flux) * tiles[
                    si, b, i0 - o[0]:i1 - o[0], j0 - o[1]:j1 - o[1]]
        io_ = img.nelec_per_nmgy
        electrons = nmgy * (np.asarray(io_)[:, None] if np.ndim(io_) == 1
                            else io_)
        img.pixels = electrons if expectation else rng.poisson(
            electrons).astype(np.float64)
    return images


def ais_bench_scene(n_sources=64, *, device):
    """The scene benchmark/bench_mcmc.py infers: n_sources alternating stars
    (r-flux 10-40 nMgy) and galaxies (15-50 nMgy, radius 1.5-3 px) on a
    48-pixel grid, jittered by +-2 px, rendered by gen_images_fast(seed=11).
    Returns (images, catalog)."""
    rng = np.random.default_rng(3)
    grid = int(np.ceil(np.sqrt(n_sources)))
    size = grid * 48 + 32
    images = make_blank_images(H=size, W=size, sky_nmgy=0.1,
                               nelec_per_nmgy=1000.0)
    catalog = []
    for i in range(n_sources):
        pos = (24.0 + 48.0 * (i // grid) + rng.uniform(-2, 2),
               24.0 + 48.0 * (i % grid) + rng.uniform(-2, 2))
        if i % 2 == 0:
            catalog.append(sample_star(pos=pos, r_flux=rng.uniform(10, 40)))
        else:
            catalog.append(sample_galaxy(
                pos=pos, r_flux=rng.uniform(15, 50),
                gal_radius_px=rng.uniform(1.5, 3.0)))
    gen_images_fast(images, catalog, seed=11, device=device)
    return images, catalog


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
