"""Ground-truth scene suite + runner (the port's copy of
celeste_jl_tpu/benchmark/galsim.py; GalsimBenchmark.jl and
benchmark/galsim/galsim_benchmarks.py rebuilt).

The reference renders 5-band truth scenes with GalSim and asserts inference
recovers the truth. GalSim is not available here; scenes are rendered with
the package's own forward model (Synthetic) — the same substitution the
reference itself uses for prior-draw benchmarks (AccuracyBenchmark.jl:694+).
Case names and parameters mirror galsim_benchmarks.py:23-166.

Scene geometry matches the reference: 96x96 px, 0.396 arcsec/px linear WCS,
1000 electrons/nMgy, Gaussian PSF sigma 4 px, sky 0.01 nMgy, noise off
unless the case says otherwise.

The tables are accuracy.Table (no pandas). run_benchmarks runs the fits on
the card unless the caller asks for the CPU, in float64 by default.
"""

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from ..io.wcs import LinearWCS
from ..models.image import CatalogEntry, Image
from ..models.psf import make_psf
from .accuracy import Table, catalog_entries_to_df, concat, fluxes_from_colors

ARCSEC_PER_DEGREE = 3600.0
ARCSEC_PER_PIXEL = 0.396
DEG_PER_PIXEL = ARCSEC_PER_PIXEL / ARCSEC_PER_DEGREE
IMAGE_SIZE_PX = 96
NELEC_PER_NMGY = 1000.0

# dominant prior component's band intensities relative to r
# (generate_test_image.py:20-34)
STAR_RELATIVE_INTENSITIES = [0.1330, 0.5308, 1.0, 1.3179, 1.5417]
GALAXY_RELATIVE_INTENSITIES = [0.4013, 0.4990, 1.0, 1.4031, 1.7750]


@dataclass
class SceneSource:
    is_star: bool
    offset_arcsec: tuple = (0.0, 0.0)      # (ra, dec) from image center
    flux_r_nmgy: Optional[float] = None    # default: star 40, galaxy 10
    relative_fluxes: Optional[list] = None
    gal_angle_deg: float = 0.0
    gal_axis_ratio: float = 0.4
    half_light_radius_arcsec: float = 1.5
    gal_frac_dev: float = 0.0


def star(**kw):
    return SceneSource(is_star=True, **kw)


def galaxy(**kw):
    return SceneSource(is_star=False, **kw)


@dataclass
class SceneSpec:
    name: str
    sources: List[SceneSource]
    psf_sigma_pixels: float = 4.0
    sky_nmgy: float = 0.01
    include_noise: bool = False
    # Distinct per-scene world origin (ra, dec) in degrees, assigned below.
    # Each GalSim FITS file in the reference is an independent sky footprint;
    # giving every scene its own patch of sky keeps KDTree catalog matching
    # (accuracy.match_catalogs) from ever pairing a truth row with another
    # scene's prediction.
    world_origin: tuple = (0.0, 0.0)


_GWA = dict(offset_arcsec=(0.3, -0.7), gal_angle_deg=15, gal_axis_ratio=0.4,
            half_light_radius_arcsec=2.5, flux_r_nmgy=15, gal_frac_dev=0.4,
            relative_fluxes=[0.6, 0.2, 1, 1.1, 2])

SCENES = [
    SceneSpec("simple_star", [star()]),
    SceneSpec("star_position_1", [star(offset_arcsec=(-2, 0))]),
    SceneSpec("star_position_2", [star(offset_arcsec=(0, 2))]),
    SceneSpec("dim_star", [star(flux_r_nmgy=20)]),
    SceneSpec("bright_star", [star(flux_r_nmgy=80)]),
    SceneSpec("different_color_star",
              [star(relative_fluxes=[0.2, 0.8, 1, 1.6, 1.3])]),
    SceneSpec("star_with_noise",
              [star(offset_arcsec=(-1, 1), flux_r_nmgy=20)],
              include_noise=True),
    SceneSpec("angle_and_axis_ratio_1",
              [galaxy(gal_angle_deg=15, gal_axis_ratio=0.2)]),
    SceneSpec("angle_and_axis_ratio_2",
              [galaxy(gal_angle_deg=160, gal_axis_ratio=0.4)]),
    SceneSpec("round_galaxy", [galaxy(gal_axis_ratio=1.0)]),
    SceneSpec("small_galaxy", [galaxy(half_light_radius_arcsec=0.75)]),
    SceneSpec("large_galaxy", [galaxy(half_light_radius_arcsec=2.5)]),
    SceneSpec("dim_galaxy", [galaxy(flux_r_nmgy=5)]),
    SceneSpec("bright_galaxy", [galaxy(flux_r_nmgy=20)]),
    SceneSpec("de_vaucouleurs_galaxy", [galaxy(gal_frac_dev=1.0)]),
    SceneSpec("exp_dev_mixture_galaxy", [galaxy(gal_frac_dev=0.4)]),
    SceneSpec("different_color_galaxy",
              [galaxy(relative_fluxes=[0.6, 0.2, 1, 1.1, 2])]),
    SceneSpec("galaxy_with_all", [galaxy(**_GWA)]),
    SceneSpec("galaxy_with_noise", [galaxy(**_GWA)], include_noise=True),
    SceneSpec("galaxy_with_low_background", [galaxy(**_GWA)],
              include_noise=True, sky_nmgy=0.1),
    SceneSpec("galaxy_with_high_background", [galaxy(**_GWA)],
              include_noise=True, sky_nmgy=0.3),
    SceneSpec("overlapping_stars", [star(offset_arcsec=(-3, 0)),
                                    star(offset_arcsec=(3, 0))]),
    SceneSpec("overlapping_galaxies",
              [galaxy(offset_arcsec=(-2, -2), gal_angle_deg=135,
                      gal_axis_ratio=0.2),
               galaxy(offset_arcsec=(3, 3), gal_angle_deg=35,
                      gal_axis_ratio=0.5)]),
    SceneSpec("overlapping_star_and_galaxy",
              [star(offset_arcsec=(-5, 0)),
               galaxy(offset_arcsec=(2, 2), gal_angle_deg=35,
                      gal_axis_ratio=0.5)]),
    SceneSpec("three_sources_two_overlap",
              [star(offset_arcsec=(-5, 5)),
               galaxy(offset_arcsec=(2, 5), gal_angle_deg=35,
                      gal_axis_ratio=0.2),
               star(offset_arcsec=(10, -10))]),
    SceneSpec("three_sources_all_overlap",
              [star(offset_arcsec=(-5, 0)),
               galaxy(offset_arcsec=(2, 2), gal_angle_deg=35,
                      gal_axis_ratio=0.5),
               star(offset_arcsec=(8, -1))]),
    SceneSpec("smaller_psf", [star()], psf_sigma_pixels=2.0),
    SceneSpec("larger_psf", [star()], psf_sigma_pixels=6.0),
]

# Scene footprints are ~0.011 deg wide (96 px * 0.396"); space origins 0.1
# deg apart along RA so no two scenes' sources can ever be within the 1-px
# match tolerance of each other.
for _i, _s in enumerate(SCENES):
    _s.world_origin = (0.1 * _i, 0.0)

SCENES_BY_NAME = {s.name: s for s in SCENES}

# long-running CI subset (disabled_test_galsim_benchmarks.jl:13-26)
CI_CASES = ("simple_star", "star_with_noise", "angle_and_axis_ratio_1",
            "galaxy_with_all", "galaxy_with_noise")


def scene_truth(spec: SceneSpec):
    """SceneSource list -> CatalogEntry truth list (world coords, deg)."""
    center = (np.asarray(spec.world_origin, float)
              + np.array([IMAGE_SIZE_PX / 2.0 * DEG_PER_PIXEL,
                          IMAGE_SIZE_PX / 2.0 * DEG_PER_PIXEL]))
    entries = []
    for src in spec.sources:
        pos = center + np.asarray(src.offset_arcsec) / ARCSEC_PER_DEGREE
        flux_r = src.flux_r_nmgy if src.flux_r_nmgy is not None \
            else (40.0 if src.is_star else 10.0)
        rel = src.relative_fluxes if src.relative_fluxes is not None \
            else (STAR_RELATIVE_INTENSITIES if src.is_star
                  else GALAXY_RELATIVE_INTENSITIES)
        fluxes = flux_r * np.asarray(rel, float)
        entries.append(CatalogEntry(
            pos=pos, is_star=src.is_star,
            star_fluxes=np.maximum(fluxes, 1e-6),
            gal_fluxes=np.maximum(fluxes, 1e-6),
            gal_frac_dev=src.gal_frac_dev,
            gal_axis_ratio=src.gal_axis_ratio,
            gal_angle=np.radians(src.gal_angle_deg),
            gal_radius_px=src.half_light_radius_arcsec / ARCSEC_PER_PIXEL))
    return entries


def render_scene(spec: SceneSpec, seed=1234):
    """Render the 5-band truth images for one scene.

    Truth pixels come from the INDEPENDENT dense renderer
    (benchmark/independent_render.py) rather than the model's own forward
    path, mirroring the reference's use of GalSim as an external truth
    renderer (benchmark/galsim/generate_test_image.py) — so a shared
    normalization or convolution bug in models/fsm.py shows up in the suite
    scores instead of cancelling."""
    from .independent_render import render_scene_nmgy

    wcs = LinearWCS(crpix=(0.0, 0.0), crval=spec.world_origin,
                    cd=np.eye(2) * DEG_PER_PIXEL)
    psf = make_psf([1.0], np.zeros((1, 2)),
                   [np.eye(2) * spec.psf_sigma_pixels ** 2])
    images = [Image(pixels=np.zeros((IMAGE_SIZE_PX, IMAGE_SIZE_PX)),
                    band=b, psf=psf, sky=spec.sky_nmgy,
                    nelec_per_nmgy=NELEC_PER_NMGY, wcs=wcs)
              for b in range(5)]
    truth = scene_truth(spec)
    rng = np.random.default_rng(seed)
    for img, nmgy in zip(images, render_scene_nmgy(images, truth)):
        electrons = (nmgy + spec.sky_nmgy) * NELEC_PER_NMGY
        img.pixels = (electrons if not spec.include_noise
                      else rng.poisson(electrons).astype(np.float64))
    return images, truth


def make_initialization_catalog(truth, use_full_initialization=False):
    """Initialization entries: truth-position-with-typical-params, offset by
    one pixel unless full initialization (AccuracyBenchmark.jl:642-666)."""
    from ..models.priors import prior

    def typical_fluxes(is_star):
        i = 0 if is_star else 1
        flux_r = np.exp(prior.flux_mean[i] - prior.flux_var[i])
        d = int(np.argmax(prior.k[:, i]))
        colors = (prior.color_mean[:, d, i]
                  - np.diag(prior.color_cov[:, :, d, i]))
        return np.maximum(fluxes_from_colors(flux_r, colors), 1e-6)

    out = []
    for ce in truth:
        if use_full_initialization:
            out.append(ce)
        else:
            pos = np.asarray(ce.pos) + np.array([DEG_PER_PIXEL,
                                                 -0.5 * DEG_PER_PIXEL])
            out.append(CatalogEntry(
                pos=pos, is_star=False,
                star_fluxes=typical_fluxes(True),
                gal_fluxes=typical_fluxes(False),
                gal_frac_dev=0.1, gal_axis_ratio=0.7,
                gal_angle=np.pi / 4, gal_radius_px=4.0))
    return out


COMPARISON_COLUMNS = ["is_star", "flux_r_nmgy", "color_ug", "color_gr",
                      "color_ri", "color_iz", "gal_frac_dev",
                      "gal_axis_ratio", "gal_radius_px", "gal_angle_deg"]


def truth_comparison_df(truth_df, pred_df):
    """Long-format (objid, variable, truth, estimate) table
    (GalsimBenchmark.jl truth_comparison_df). Rows are objid-aligned —
    no position matching, so scoring cannot cross scenes."""
    assert list(truth_df["objid"]) == list(pred_df["objid"])
    rows = []
    for i in range(len(truth_df)):
        t, p = truth_df.row(i), pred_df.row(i)
        for col in COMPARISON_COLUMNS:
            truth_val = t[col]
            # a near-round galaxy's angle is unidentifiable — the reference
            # excludes gal_angle rows with axis ratio > 0.6 from scoring
            # (AccuracyBenchmark.jl:862-866 _is_good_row)
            if col == "gal_angle_deg" and t["gal_axis_ratio"] > 0.6:
                truth_val = np.nan
            rows.append({"objid": t["objid"], "variable": col,
                         "truth": truth_val, "estimate": p[col]})
    return Table.from_rows(rows)


def max_error_for(variable, truth_value):
    """Per-variable tolerance (disabled_test_galsim_benchmarks.jl:29-47)."""
    if variable == "is_star":
        return 0.1
    if variable == "gal_frac_dev":
        return 0.2
    if variable == "gal_angle_deg":
        return 5.0
    return 0.2 * abs(truth_value)


def estimate_violations(comparison_df):
    """Rows of the comparison table outside the reference's tolerances.
    Empty list == the suite passes the reference's accuracy gate."""
    bad = []
    for row in comparison_df.rows():
        t = row["truth"]
        if t is None or (isinstance(t, float) and np.isnan(t)):
            continue
        err = abs(row["estimate"] - t)
        if row["variable"] == "gal_angle_deg":
            err = min(err % 180.0, 180.0 - (err % 180.0))
        if err > max_error_for(row["variable"], t):
            bad.append((row["objid"], row["variable"], float(t),
                        float(row["estimate"]), float(err)))
    return bad


def run_benchmarks(names=None, joint_inference=False, seed=1234,
                   use_full_initialization=False, config=None,
                   newton_config=None, min_radius_pix=16.0,
                   force_noise=False, force_noise_free=False, *,
                   device="cuda", dtype=torch.float64, plain=False):
    """Run inference on each scene; returns (truth_df, prediction_df) with
    aligned rows (GalsimBenchmark.jl:78-125).

    min_radius_pix: the reference forces 40px active radii
    (ACTIVE_PIXELS_MIN_RADIUS_PX, GalsimBenchmark.jl:13); smaller values
    trade a little accuracy for much smaller patch tiles. The frac_dev of a
    truncated de Vaucouleurs profile is identified by its WINGS: at 16px
    the noise-free high-background scene fits frac_dev 0.24 vs truth 0.40
    (gate violation), at 40px 0.28 (inside the gate) — the artifact suite
    runs at 40 for reference parity.
    force_noise: render EVERY scene with Poisson noise (the calibration
    study needs per-seed error realizations; most scenes default noise-free
    to match the reference's deterministic cases).
    force_noise_free: render every scene WITHOUT noise — the deterministic
    accuracy gate (estimate_violations == 0 must hold here; the handful of
    noisy-by-design scenes add seed scatter on top of it).
    device, dtype, plain: passed to the inference (the card, float64 and
    the kernels unless the caller asks otherwise).
    The prediction table has the JAX package's columns and, last, each
    fit's ELBO (`elbo`).
    """
    from ..ops.newton import NewtonConfig
    from ..parallel.run import one_node_joint_infer, one_node_single_infer
    from ..utils.config import Config
    from .accuracy import celeste_to_df

    names = list(names) if names is not None else [s.name for s in SCENES]
    config = config or Config(min_radius_pix=min_radius_pix)
    newton_config = newton_config or NewtonConfig()

    truth_dfs, pred_dfs = [], []
    for name in names:
        spec = SCENES_BY_NAME[name]
        if force_noise and not spec.include_noise:
            spec = replace(spec, include_noise=True)
        if force_noise_free and spec.include_noise:
            spec = replace(spec, include_noise=False)
        images, truth = render_scene(spec, seed=seed)
        init = make_initialization_catalog(
            truth, use_full_initialization=use_full_initialization)
        infer = one_node_joint_infer if joint_inference \
            else one_node_single_infer
        results = infer(init, images, config=config,
                        newton_config=newton_config, device=device,
                        dtype=dtype, plain=plain)
        tdf = catalog_entries_to_df(truth)
        pdf = celeste_to_df(results)
        pdf["elbo"] = [r.elbo for r in results if not r.is_sky_bad]
        tdf.insert(0, "objid", [f"{name}_{i:03d}" for i in range(len(tdf))])
        pdf.insert(0, "objid", [f"{name}_{i:03d}" for i in range(len(pdf))])
        truth_dfs.append(tdf)
        pred_dfs.append(pdf)
    return concat(truth_dfs), concat(pred_dfs)
