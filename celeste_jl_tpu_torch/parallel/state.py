"""Host-side box state (port of celeste_jl_tpu/parallel/state.py):
OptimizedSource records, patch radii and the neighbor graph, detection
active boxes, and InferenceState, the per-box staging object (bucketed
patches, variational parameters, launch dispatch and finish).
"""

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..models.image import CatalogEntry
from ..models.patches import make_patches_batched, stack_patches
from ..models.psf import get_psf_width
from ..models.psf_fit import fit_patch_psfs
from ..ops.newton import NewtonConfig
from ..utils import log as Log
from ..utils import telemetry
from ..utils.config import Config
from ..utils.device import resolve
from ..vi.init import generic_init_source, init_sources
from ..vi.optimize import fit_sources, fit_sources_compacted
from .common import (MAX_PATCH_RADIUS, _beats, _elbo_values, _next_pow2,
                     _render_neighbor_bg, _tile_for_radius,
                     is_production_run)


@dataclass
class OptimizedSource:
    """Result record for one fitted source (ParallelRun.jl:425-430)."""
    init_pos: np.ndarray       # (2,) world coords at initialization
    vs: np.ndarray             # (44,) optimized variational params
    elbo: float
    converged: bool
    is_sky_bad: bool


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


def detection_active_boxes(catalog, det_boxes, images, dilate=0.2,
                           min_half=5.0):
    """Per-source per-image active boxes from the detection bounding boxes:
    dilate each box 20% and enclose a ±5 px minimum box around the source
    center (detection.jl:152-167 dilate_box + box_around_point +
    enclose_boxes). Returns ((S, B, 4) 1-based inclusive bounds,
    (S,) required active radius = max distance from center to a box edge).

    Images with no detection for a source get the minimum box — the
    reference's no-detection fallback (detection.jl:163-167)."""
    S, B = len(catalog), len(images)
    out = np.zeros((S, B, 4))
    req = np.zeros(S)
    centers = np.stack([
        np.asarray(img.world_to_pix(
            np.stack([np.asarray(ce.pos, np.float64) for ce in catalog])))
        for img in images], axis=1)      # (S, B, 2)
    for i in range(S):
        for j in range(B):
            ctr = centers[i, j]
            xlo, xhi = ctr[0] - min_half, ctr[0] + min_half
            ylo, yhi = ctr[1] - min_half, ctr[1] + min_half
            bx = det_boxes[i].get(j) if det_boxes is not None else None
            if bx is not None:
                xmin, xmax, ymin, ymax = bx
                dx = round(dilate * (xmax - xmin + 1) / 2.0)
                dy = round(dilate * (ymax - ymin + 1) / 2.0)
                xlo, xhi = min(xlo, xmin - dx), max(xhi, xmax + dx)
                ylo, yhi = min(ylo, ymin - dy), max(yhi, ymax + dy)
            out[i, j] = (xlo, xhi, ylo, yhi)
            req[i] = max(req[i], xhi - ctr[0], ctr[0] - xlo,
                         yhi - ctr[1], ctr[1] - ylo)
    return out, req


def fit_for_width(pad):
    """The fit of a launch `pad` lanes wide: wide launches finish their
    unconverged lanes in a smaller bucket (per lane the same result,
    vi/optimize.fit_sources_compacted); narrow ones stay one launch."""
    if pad < 256:
        return fit_sources
    return partial(fit_sources_compacted, stage1_refreshes=10)


def read_fit(res, n):
    """A fit's first n lanes on the host, (vp, elbo, converged, iters) as
    float64 numpy, and every lane's f_calls."""
    host = lambda t: t.cpu().numpy()
    return (host(res.vp.double())[:n], host(res.elbo.double())[:n],
            host(res.converged)[:n], host(res.iters)[:n], host(res.f_calls))


class InferenceState:
    """Host-side state for one sky box: catalog, per-source patches (bucketed
    by tile size), variational params, neighbor map. Fits run on `device`
    in `dtype`; the variational params stay float64 numpy on the host."""

    def __init__(self, catalog, images, config: Config,
                 target_sources=None, max_neighbors=8, active_boxes=None,
                 *, device="cuda", dtype=torch.float32, plain=False):
        self.catalog = catalog
        self.images = images
        self.config = config
        self.device = resolve(device)
        self.dtype = dtype
        # plain: the per-source PSF fits run K3's plain twin (the
        # comparison route)
        self.plain = plain
        S = len(catalog)
        self.targets = (list(range(S)) if target_sources is None
                        else list(target_sources))
        # active_boxes: detection-footprint masks, either the
        # ((S, B, 4) boxes, (S,) required radius) pair returned by
        # detection_active_boxes, or just the boxes (the radius then falls
        # back to half the box extent). None = flux-based radius boxes.
        if active_boxes is not None:
            if isinstance(active_boxes, tuple):
                self.active_boxes, req = active_boxes
            else:
                self.active_boxes = np.asarray(active_boxes, float)
                req = np.maximum(
                    (self.active_boxes[:, :, 1]
                     - self.active_boxes[:, :, 0]) / 2.0,
                    (self.active_boxes[:, :, 3]
                     - self.active_boxes[:, :, 2]) / 2.0).max(axis=1)
            # tile/conflict radius must cover the active box
            self.radii = np.maximum(np.asarray(req, float),
                                    config.min_radius_pix)
        else:
            self.active_boxes = None
            self.radii = patch_radii(catalog, images, config)
        self.neighbor_map = find_neighbors(catalog, self.radii, images)
        self.max_neighbors = max_neighbors

        self.tile = np.array([_tile_for_radius(r) for r in self.radii])
        # patches are built lazily, only for sources that get fitted;
        # _stacked caches the device-stacked group tensors across sweeps
        # (they are immutable)
        self._patches = {}
        self._pixel_counts = {}
        self._stacked = {}
        self._has_psfmap = any(img.meta and img.meta.get("psfmap") is not None
                               for img in images)
        self._patch_psfs = None

        # catalog init everywhere, generic re-init for optimization targets
        # (DeterministicVI.jl:94-103)
        self.vps = init_sources(self.targets, catalog)

        # fixed-shape neighbor tables: keep the up-to-max_neighbors nearest
        self.nb_idx = np.zeros((S, max_neighbors), dtype=np.int64)
        self.nb_mask = np.zeros((S, max_neighbors))
        for s in range(S):
            nbs = self.neighbor_map[s]
            if len(nbs) > max_neighbors:
                d = [np.linalg.norm(np.asarray(catalog[s].pos)
                                    - np.asarray(catalog[n].pos))
                     for n in nbs]
                nbs = [nbs[k] for k in np.argsort(d)[:max_neighbors]]
            for k, n in enumerate(nbs):
                self.nb_idx[s, k] = n
                self.nb_mask[s, k] = 1.0

        self.elbos = np.full(S, -np.inf)
        self.converged = np.zeros(S, dtype=bool)
        self.iters = np.zeros(S, dtype=np.int64)

    def patch_psf(self, s):
        """(B, K, 6) local PSF of source s, or None when no image has a
        psfmap (model/imaged_sources.jl:97-107). All targets' PSFs are
        fitted on first use, one batched launch per band on the state's
        device (models/psf_fit.fit_patch_psfs)."""
        if not self._has_psfmap:
            return None
        if self._patch_psfs is None:
            positions = [self.catalog[t].pos for t in self.targets]
            table = fit_patch_psfs(self.images, positions,
                                   device=self.device, plain=self.plain)
            self._patch_psfs = {t: table[i]
                                for i, t in enumerate(self.targets)}
        return self._patch_psfs.get(s)

    def build_patches(self, sources, tile=None):
        """Batch-build any missing patches for `sources`: one vectorized
        gather per (tile, band) via make_patches_batched."""
        groups = {}
        for s in dict.fromkeys(sources):
            t = int(self.tile[s]) if tile is None else int(tile)
            if (s, t) not in self._patches:
                groups.setdefault(t, []).append(s)
        for t, ss in groups.items():
            psfs = (np.stack([self.patch_psf(s) for s in ss])
                    if self._has_psfmap else None)
            boxes = (self.active_boxes[np.asarray(ss)]
                     if self.active_boxes is not None else None)
            plist = make_patches_batched(
                self.images, [self.catalog[s].pos for s in ss],
                self.radii[np.asarray(ss)], t, psfs=psfs,
                active_boxes=boxes)
            for s, p in zip(ss, plist):
                self._patches[(s, t)] = p
                self._pixel_counts[(s, t)] = int(p.mask.sum())

    def patch(self, s, tile=None):
        """Per-source numpy SkyPatch, built on first use and cached."""
        tile = int(self.tile[s]) if tile is None else int(tile)
        key = (s, tile)
        if key not in self._patches:
            self.build_patches([s], tile=tile)
        return self._patches[key]

    def stacked_patches(self, idx_p):
        """SkyPatch of a padded group on the state's device, cached across
        sweeps, with the lanes' active-pixel counts (host-side, so no mask
        is read back for telemetry)."""
        key = tuple(idx_p)
        if key not in self._stacked:
            self.build_patches(idx_p)
            patches = stack_patches([self.patch(s) for s in idx_p],
                                    self.device, self.dtype)
            counts = np.array([self._pixel_counts[(s, int(self.tile[s]))]
                               for s in idx_p])
            self._stacked[key] = (patches, counts)
        return self._stacked[key]

    def tensor(self, a):
        """A host array on the state's device, floats in its dtype."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- mid-box checkpointing (finer than the reference's box-level
    #    resume, main.jl:50-56): the mutable fit state round-trips through
    #    one npz; catalog and patches are rebuilt deterministically.

    def save(self, path, cursor=0):
        import os
        tmp = f"{path}.tmp.npz"  # np.savez appends .npz unless present
        np.savez(tmp, vps=self.vps, elbos=self.elbos,
                 converged=self.converged, iters=self.iters,
                 cursor=np.int64(cursor))
        os.replace(tmp, path)

    def restore(self, path):
        """Load fit state; returns the stored cursor (resume position)."""
        d = np.load(path)
        if d["vps"].shape != self.vps.shape:
            raise ValueError(f"checkpoint {path} holds {d['vps'].shape[0]} "
                             f"sources, the catalog {self.vps.shape[0]}")
        self.vps = d["vps"]
        self.elbos = d["elbos"]
        self.converged = d["converged"]
        self.iters = d["iters"]
        return int(d["cursor"])

    def dispatch_group(self, idx, newton_config: NewtonConfig, use_bg=True,
                       bg_vps=None, fresh_init=False, keep_better=False,
                       dual_init=False, width=None, plain=False):
        """Fit sources `idx` (one tile size) in one batched launch padded to
        a power of two; returns a pending record for finish_group, or None.
        Neighbor background is rendered from `bg_vps` (default: the live
        self.vps).

        fresh_init: fit from generic_init_source instead of the warm vps.
        keep_better: only accept lanes whose new ELBO beats the incumbent's,
        re-evaluated against this launch's own neighbor background.
        dual_init: each source rides two lanes, lane i from the warm vps
        and lane n+i from generic_init_source; finish_group keeps the
        better basin.
        width: minimum lane width (the joint schedule's per-bucket width,
        packing.fused_bucket_widths).
        plain: run every kernel's plain twin (the comparison route).
        """
        n = len(idx)
        if n == 0:
            return None
        n_lanes = 2 * n if dual_init else n
        pad = max(_next_pow2(n_lanes), width or 1)
        idx_p = list(idx) * (2 if dual_init else 1) \
            + [idx[0]] * (pad - n_lanes)
        t0 = telemetry.now()
        patches, pixel_counts = self.stacked_patches(idx_p)
        if fresh_init:
            vp0 = np.stack([generic_init_source(self.catalog[s].pos)
                            for s in idx_p])
        elif dual_init:
            vp0 = self.vps[idx_p]  # fancy indexing: a copy, safe to edit
            vp0[n:n_lanes] = np.stack(
                [generic_init_source(self.catalog[s].pos) for s in idx])
        else:
            vp0 = self.vps[idx_p]
        fit = fit_for_width(pad)
        inc = bg_E = bg_V = None
        try:
            if use_bg:
                src = self.vps if bg_vps is None else bg_vps
                bg_E, bg_V = _render_neighbor_bg(
                    self.tensor(src[self.nb_idx[idx_p]]),
                    self.tensor(self.nb_mask[idx_p]), patches)
            res = fit(self.tensor(vp0), patches, bg_E, bg_V,
                      config=newton_config, plain=plain)
            if keep_better:
                # incumbent ELBOs against the same background: the
                # keep_better comparison in finish_group is exact
                inc = _elbo_values(self.tensor(self.vps[idx_p]), patches,
                                   bg_E, bg_V)
        except Exception as exc:
            # production: log the failed launch and keep the sources at
            # their previous state (ParallelRun.jl:390-396, :589-595);
            # otherwise raise
            if not is_production_run():
                raise
            Log.exception(exc)
            telemetry.counters.failures += len(idx)
            return None
        return dict(idx=idx, n=n, n_lanes=n_lanes, pad=pad, res=res, t0=t0,
                    inc=inc, pixel_counts=pixel_counts,
                    keep_better=keep_better,
                    pixels_per_lane_total=int(np.prod(patches.mask.shape[1:])),
                    tile=int(patches.pixels.shape[-1]),
                    bands=int(patches.pixels.shape[-3]),
                    hess_every=newton_config.hess_every,
                    label=f"n={n} pad={pad} P{patches.pixels.shape[-1]}")

    def finish_group(self, pending):
        """Apply a dispatched launch's results to the host state."""
        if pending is None:
            return
        idx, n, res = pending["idx"], pending["n"], pending["res"]
        nl = pending["n_lanes"]
        try:
            vp, elbo, conv, iters, f_calls = read_fit(res, nl)
        except Exception as exc:
            # a failure of the launch's device work surfaces at the read
            if not is_production_run():
                raise
            Log.exception(exc)
            telemetry.counters.failures += len(idx)
            return
        telemetry.record_launch_wall(pending["t0"], pending["label"])
        if nl != n:
            # dual_init: lane i (warm) against lane n+i (generic init) of
            # the same source; keep the better basin by the rounding margin
            fresh = _beats(elbo[n:nl], elbo[:n])
            vp = np.where(fresh[:, None], vp[n:nl], vp[:n])
            elbo = np.where(fresh, elbo[n:nl], elbo[:n])
            conv = np.where(fresh, conv[n:nl], conv[:n])
            iters = iters[:n] + iters[n:nl]
        idxa = np.asarray(idx)
        if pending["keep_better"]:
            # against the incumbent's ELBO under this launch's background;
            # a rejected lane's stored ELBO becomes that re-evaluation
            ref = pending["inc"].double().cpu().numpy()[:n]
            take = _beats(elbo, ref)
            self.elbos[idxa[~take]] = ref[~take]
            idxa = idxa[take]
            vp, elbo, conv = vp[take], elbo[take], conv[take]
        self.vps[idxa] = vp
        self.elbos[idxa] = elbo
        self.converged[idxa] = conv
        self.iters[np.asarray(idx)] += iters
        telemetry.record_fit_launch(
            nl, pending["pad"] - nl,
            pixels_per_lane_real=pending["pixel_counts"][:nl],
            pixels_per_lane_total=pending["pixels_per_lane_total"],
            f_calls=f_calls, tile=pending["tile"], bands=pending["bands"],
            hess_every=pending["hess_every"])

    def fit_group(self, idx, newton_config: NewtonConfig, use_bg=True,
                  bg_vps=None, fresh_init=False, keep_better=False,
                  plain=False):
        """Dispatch one group and apply it (see dispatch_group)."""
        self.finish_group(self.dispatch_group(
            idx, newton_config, use_bg=use_bg, bg_vps=bg_vps,
            fresh_init=fresh_init, keep_better=keep_better, plain=plain))
