"""MCMC-facing log densities on patch tiles (port of
celeste_jl_tpu/mcmc/log_prob.py; model/log_prob.jl, mcmc_functions.jl).

Every function is written over an explicit lane axis: `th` is (L, D) and
lane l scores source src[l] of a SourceTarget whose fields carry a leading
source axis S (src=None: L == S, lane l is source l). The AIS runs
S sources x samples lanes per model, and one K4 launch
(ops/render.mixture_poisson_ll_ragged, through `blocks_loglike`) scores
all the lanes of both models and all their bands, the rows of one source
sharing its tiles.

Parameter vectors (flat; slice sampling needs no bijectors):
  star   th (7,)  = [lnfluxes(5), u(2)]
  galaxy th (11,) = [lnfluxes(5), u(2), gal_frac_dev, gal_axis_ratio,
                     gal_angle, gal_radius_px]
u in [0,1]^2 maps linearly to a world-coordinate box of +-pos_delta/2
pixels around the catalog position (mcmc_functions.jl:324-369).

Synthetic scenes have pixel-sized world coordinates, so f32 is enough
there; real-sky coordinates (RA ~150 degrees) need f64 for the position
box, as in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.bvn import get_bvn_cov
from ..models.fsm import (galaxy_density_grid, galaxy_prototypes,
                          linear_world_to_pix, star_density_grid)
from ..models.params import GAL_ETA
from ..models.priors import prior as _prior_params
from ..models.psf import psf_alphas, psf_covs, psf_mus
from ..ops import render
from ..ops.render import pack_mixture
from ..vi.elbo import PriorConstants, default_prior

LN2PI = float(np.log(2.0 * np.pi))
NUM_STAR_PARAMS = 7
NUM_GAL_PARAMS = 11
PRIOR_GAL_RADIUS_MEAN = float(_prior_params.gal_radius_px_mean)
PRIOR_GAL_RADIUS_VAR = float(_prior_params.gal_radius_px_var)


class SourceTarget(NamedTuple):
    """One source's MCMC data (numpy leaves, from make_source_target) or S
    sources' (tensors with a leading S axis, from stack_targets): its patch
    tiles, the fixed background (sky + rendered neighbors, nMgy), and the
    world box the position prior is uniform over."""
    pixels: torch.Tensor        # (S, B, P, P)
    mask: torch.Tensor          # (S, B, P, P) bool
    iota: torch.Tensor          # (S, B, P, P)
    bg_nmgy: torch.Tensor       # (S, B, P, P) sky + neighbors
    psf: torch.Tensor           # (S, B, K, 6)
    wcs_jacobian: torch.Tensor  # (S, B, 2, 2)
    world_center: torch.Tensor  # (S, B, 2)
    pixel_center: torch.Tensor  # (S, B, 2)
    offset: torch.Tensor        # (S, B, 2) int
    world_lo: torch.Tensor      # (S, 2) position box lower corner (world)
    world_hi: torch.Tensor      # (S, 2)


def make_source_target(patch, bg_nmgy=None, pos_delta=(2.0, 2.0), image=None,
                       entry_pos=None):
    """A SourceTarget of numpy leaves from a single-source numpy SkyPatch.
    The position box is +-pos_delta/2 *pixels* around the patch world
    center, mapped to world coordinates by the image WCS (or the patch
    Jacobian)."""
    pos0 = np.asarray(entry_pos if entry_pos is not None
                      else patch.world_center[0])
    delta = np.asarray(pos_delta, dtype=np.float64)
    if image is not None:
        pc = np.asarray(image.world_to_pix(pos0))
        lo = np.asarray(image.pix_to_world(pc - 0.5 * delta))
        hi = np.asarray(image.pix_to_world(pc + 0.5 * delta))
    else:
        jac_inv = np.linalg.inv(np.asarray(patch.wcs_jacobian[0]))
        lo = pos0 - np.abs(jac_inv) @ (0.5 * delta)
        hi = pos0 + np.abs(jac_inv) @ (0.5 * delta)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    if bg_nmgy is None:
        bg_nmgy = patch.sky
    return SourceTarget(
        pixels=patch.pixels, mask=patch.mask, iota=patch.iota,
        bg_nmgy=bg_nmgy, psf=patch.psf, wcs_jacobian=patch.wcs_jacobian,
        world_center=patch.world_center, pixel_center=patch.pixel_center,
        offset=patch.offset, world_lo=lo, world_hi=hi)


def stack_targets(targets, device, dtype):
    """Single-source SourceTargets (numpy or tensor leaves) -> one of
    tensors with a leading S axis on `device`; float fields in `dtype`."""
    out = []
    for f in SourceTarget._fields:
        a = torch.as_tensor(np.stack([np.asarray(getattr(t, f))
                                      for t in targets]), device=device)
        out.append(a.to(dtype) if a.is_floating_point() else a)
    return SourceTarget(*out)


def _lanes(tgt, src, x):
    """Lane l's value of the per-source field x."""
    return x if src is None else x[src]


def uniform_to_world(u, tgt: SourceTarget, src=None):
    lo, hi = _lanes(tgt, src, tgt.world_lo), _lanes(tgt, src, tgt.world_hi)
    return lo + (hi - lo) * u


def world_to_uniform(pos, tgt: SourceTarget, src=None):
    lo, hi = _lanes(tgt, src, tgt.world_lo), _lanes(tgt, src, tgt.world_hi)
    return (pos - lo) / (hi - lo)


# ---------------------------------------------------------------------------
# Likelihood
# ---------------------------------------------------------------------------

def _poisson_ll(tgt: SourceTarget, source_nmgy, src=None):
    """Masked Poisson log-likelihood (lgamma included, rate clamped at
    1e-30) of per-lane expected source images (L, B, P, P), (L,)."""
    mask = _lanes(tgt, src, tgt.mask)
    rate = torch.clamp(_lanes(tgt, src, tgt.iota)
                       * (source_nmgy + _lanes(tgt, src, tgt.bg_nmgy)),
                       min=1e-30)
    x = torch.where(mask, _lanes(tgt, src, tgt.pixels), 0.0)
    ll = x * torch.log(rate) - rate - torch.lgamma(x + 1.0)
    return torch.sum(torch.where(mask, ll, 0.0), dim=(-3, -2, -1))


def _render(tgt: SourceTarget, pos_world, fluxes, shape=None, src=None):
    """(L, B, P, P) expected source nMgy: unit-flux density x per-band flux
    (L, B), at world positions (L, 2); shape (L, 4) renders a galaxy."""
    P = tuple(tgt.pixels.shape[-2:])
    args = tuple(_lanes(tgt, src, f) for f in (
        tgt.psf, tgt.wcs_jacobian, tgt.world_center, tgt.pixel_center,
        tgt.offset)) + (P,)
    pos = pos_world[:, None, :]
    if shape is None:
        dens = star_density_grid(pos, *args)
    else:
        sh = shape[:, None, :]
        dens = galaxy_density_grid(pos, sh[..., 0], sh[..., 1], sh[..., 2],
                                   sh[..., 3], *args)
    return fluxes[..., None, None] * dens


class FusedTiles(NamedTuple):
    """K4's per-source inputs, made once per target: the tiles (S*B, P, P)
    with their active-pixel lists (ops/render.ActiveTiles; the masks are
    fixed for a whole AIS run) and the parameter-free lgamma(x + 1) sum
    per source (S,)."""
    k4: render.ActiveTiles
    lgam: torch.Tensor


def fused_tiles(tgt: SourceTarget):
    mask = tgt.mask
    x = torch.where(mask, tgt.pixels, 0.0)
    lgam = torch.sum(torch.where(mask, torch.lgamma(x + 1.0), 0.0),
                     dim=(-3, -2, -1))
    flat = lambda t: t.reshape((-1,) + t.shape[-2:]).contiguous()
    bg = torch.broadcast_to(tgt.bg_nmgy, tgt.pixels.shape)
    return FusedTiles(render.active_tiles(
        flat(x), flat(mask.to(tgt.pixels.dtype)), flat(tgt.iota), flat(bg)),
        lgam)


class Lanes(NamedTuple):
    """What the log densities of a set of lanes need from their target,
    gathered once per set (the samplers score the same lanes thousands of
    times): the position box, each band's PSF mixture and WCS, the star
    mixture's packed precision and weight columns, K4's 1-based row
    offsets and row -> tile index, the lgamma sums and the shared tiles."""
    lo: torch.Tensor          # (L, 2) world_lo
    span: torch.Tensor        # (L, 2) world_hi - world_lo
    log_area: torch.Tensor    # (L,)
    psf_a: torch.Tensor       # (L, B, K)
    psf_mu: torch.Tensor      # (L, B, K, 2)
    psf_cov: torch.Tensor     # (L, B, K, 2, 2)
    star_prec: torch.Tensor   # (L, B, K, 4) [p11, p12, p22, logw]
    jac: torch.Tensor         # (L, B, 2, 2)
    wc: torch.Tensor          # (L, B, 2)
    pc: torch.Tensor          # (L, B, 2)
    off1: torch.Tensor        # (L, B, 2) tile corner + 1
    tile_index: torch.Tensor  # (L B,)
    lgam: torch.Tensor        # (L,)
    tiles: FusedTiles


def lanes(tgt: SourceTarget, src=None, tiles=None):
    """The Lanes of sources src (L,) of tgt (src=None: one lane per
    source); `tiles`, fused_tiles(tgt), may be passed to share it."""
    tiles = tiles if tiles is not None else fused_tiles(tgt)
    g = lambda x: _lanes(tgt, src, x)
    psf = g(tgt.psf)                                            # (L, B, K, 6)
    a, mu, cv = psf_alphas(psf), psf_mus(psf), psf_covs(psf)
    L, B = psf.shape[:2]
    dev = psf.device
    lane_src = torch.arange(L, device=dev) if src is None else src
    lo, hi = g(tgt.world_lo), g(tgt.world_hi)
    return Lanes(
        lo, hi - lo, torch.log(torch.prod(hi - lo, dim=-1)), a, mu, cv,
        pack_mixture(mu, cv, a)[..., 2:], g(tgt.wcs_jacobian),
        g(tgt.world_center), g(tgt.pixel_center),
        # pixel_coord_grids is 1-based: K4's row/col indices are 0-based
        g(tgt.offset).to(psf.dtype) + 1.0,
        (lane_src[:, None] * B + torch.arange(B, device=dev)).reshape(-1),
        tiles.lgam[lane_src], tiles)


def _pack_comps(ln: Lanes, pos_world, shape=None):
    """Per-lane, per-band packed mixture rows for K4, (L, B, C, 6).
    C = psf_K for a star, psf_K * 14 for a galaxy (PSF x profile GMM,
    fsm_util.jl:111-169 semantics)."""
    m_pos = linear_world_to_pix(ln.jac, ln.wc, ln.pc,
                                pos_world[:, None, :])          # (L, B, 2)
    means = ln.psf_mu + m_pos[..., None, :]                     # (L, B, K, 2)
    if shape is None:
        return torch.cat([means, ln.star_prec], dim=-1)
    a, cv = ln.psf_a, ln.psf_cov
    L, B, K = a.shape
    XiXi = get_bvn_cov(shape[:, 1], shape[:, 2], shape[:, 3])  # (L, 2, 2)
    eta, nu, is_dev = galaxy_prototypes(XiXi)
    G = eta.shape[0]
    fd = shape[:, 0, None]
    frac = is_dev * fd + (1.0 - is_dev) * (1.0 - fd)            # (L, 14)
    w = (a[..., :, None] * (eta * frac)[:, None, None, :]).reshape(L, B, K * G)
    covs = (cv[..., :, None, :, :]
            + nu[:, None, None] * XiXi[:, None, None, None]
            ).reshape(L, B, K * G, 2, 2)
    means = means[..., :, None, :].expand(L, B, K, G, 2).reshape(L, B, K * G,
                                                                  2)
    return pack_mixture(means, covs, w)


def n_components(ln: Lanes, is_star):
    """K4's components per row of a model: the PSF's K for a star, K times
    the 14 profile components for a galaxy."""
    K = ln.psf_a.shape[-1]
    return K if is_star else K * len(GAL_ETA)


def row_inputs(ln: Lanes, th, is_star):
    """K4's per-row inputs of the lanes th (L, D) of one model: comps
    (L B, C, 6) and meta (L B, 4)."""
    fluxes = torch.exp(torch.clamp(th[:, :5], max=80.0))
    pos = ln.lo + ln.span * th[:, 5:7]
    comps = _pack_comps(ln, pos, None if is_star else th[:, 7:11])
    L, B, C, _ = comps.shape
    meta = torch.cat([ln.off1, fluxes[..., None],
                      torch.zeros_like(fluxes)[..., None]], dim=-1)
    return comps.reshape(L * B, C, 6), meta.reshape(L * B, 4)


def fused_rows(ln: Lanes, th, is_star):
    """The dense entry's arguments for the lanes th (L, D) of one model:
    the shared tiles, comps (L B, C, 6), meta (L B, 4) and the row -> tile
    index (L B,), in the order `mixture_poisson_ll` takes them (for tests
    and chip_smoke.py; the log densities go through `blocks_loglike`)."""
    t = ln.tiles.k4
    return (t.pixels, t.mask, t.iota, t.bg, *row_inputs(ln, th, is_star),
            ln.tile_index)


class LaneBlocks(NamedTuple):
    """Blocks of lanes, one model each, that one K4 launch scores: each
    block's Lanes, and the launch's row plan (ops/render.RowPlan) over the
    blocks' (lane, band) rows in block order."""
    is_star: tuple
    lanes: tuple
    plan: render.RowPlan


def lane_blocks(tgt: SourceTarget, blocks, tiles=None):
    """The LaneBlocks of `blocks`, a list of (is_star, src (L_k,)) of tgt;
    `tiles`, fused_tiles(tgt), may be passed to share it."""
    tiles = tiles if tiles is not None else fused_tiles(tgt)
    is_star = tuple(bool(s) for s, _ in blocks)
    lns = tuple(lanes(tgt, src, tiles) for _, src in blocks)
    plan = render.row_plan(
        tiles.k4, torch.cat([ln.tile_index for ln in lns]),
        tuple((ln.tile_index.numel(), n_components(ln, s))
              for ln, s in zip(lns, is_star)))
    return LaneBlocks(is_star, lns, plan)


def blocks_loglike(ths, lb: LaneBlocks, plain=False):
    """Render + Poisson score of every lane and band of every block in one
    K4 launch (its plain twin if `plain`, on any device: one call per
    block), lgamma terms subtracted: a (L_k,) per block, ths[k] (L_k, D_k)
    being block k's lanes."""
    rows = [row_inputs(ln, th, s)
            for th, s, ln in zip(ths, lb.is_star, lb.lanes)]
    comps = torch.cat([c.reshape(-1, 6) for c, _ in rows])
    meta = torch.cat([m for _, m in rows])
    score = (render.mixture_poisson_ll_ragged_plain if plain
             else render.mixture_poisson_ll_ragged)
    ll = score(lb.lanes[0].tiles.k4, lb.plan, comps, meta)
    return [torch.sum(part.reshape(th.shape[0], -1), dim=-1) - ln.lgam
            for th, ln, part in zip(ths, lb.lanes,
                                    ll.split([m.shape[0] for _, m in rows]))]


def star_loglike(th, tgt: SourceTarget, src=None, tiles=None):
    """(mcmc_functions.jl:109-185 semantics on a patch tile), (L,): one K4
    launch over every lane and band."""
    return blocks_loglike([th], lane_blocks(tgt, [(True, src)], tiles))[0]


def gal_loglike(th, tgt: SourceTarget, src=None, tiles=None):
    return blocks_loglike([th], lane_blocks(tgt, [(False, src)], tiles))[0]


# ---------------------------------------------------------------------------
# Priors (mcmc_functions.jl:324-420, 576-599; model/log_prob.jl:225-268)
# ---------------------------------------------------------------------------

def lnfluxes_to_colors(lnfluxes):
    """lnr (ref band) and 4 adjacent-band log ratios, (L,) and (L, 4)
    (mcmc_functions.jl:601-609)."""
    return lnfluxes[:, 2], lnfluxes[:, 1:] - lnfluxes[:, :-1]


def colors_to_lnfluxes(lnr, colors):
    return torch.stack([lnr - colors[:, 1] - colors[:, 0], lnr - colors[:, 1],
                        lnr, lnr + colors[:, 2],
                        lnr + colors[:, 2] + colors[:, 3]], dim=-1)


def _prior(prior, like):
    return prior if prior is not None else default_prior(like.device,
                                                         like.dtype)


def logflux_logprior(lnfluxes, is_star: bool, prior: PriorConstants = None):
    """Normal on lnr + color GMM marginal (mcmc_functions.jl:576-596), (L,)."""
    prior = _prior(prior, lnfluxes)
    i = 0 if is_star else 1
    lnr, colors = lnfluxes_to_colors(lnfluxes)
    llr = -0.5 * (LN2PI + torch.log(prior.flux_var[i])
                  + (lnr - prior.flux_mean[i]) ** 2 / prior.flux_var[i])
    dmu = colors[:, None, :] - prior.color_mean[:, :, i].T       # (L, 8, 4)
    inv = prior.color_cov_inv[:, :, :, i].permute(2, 0, 1)       # (8, 4, 4)
    maha = torch.sum(dmu * torch.einsum("dab,ldb->lda", inv, dmu), dim=-1)
    llk = -0.5 * (4.0 * LN2PI + prior.color_cov_logdet[:, i] + maha)
    llc = torch.logsumexp(llk + torch.log(prior.k[:, i]), dim=-1)
    return llr + llc


def _in01(u):
    return torch.all((u >= 0.0) & (u <= 1.0), dim=-1)


def _log_area(tgt, src):
    return torch.log(torch.prod(_lanes(tgt, src, tgt.world_hi)
                                - _lanes(tgt, src, tgt.world_lo), dim=-1))


def lane_logprior(th, is_star, log_area, prior: PriorConstants = None):
    """The star (is_star) or galaxy log prior of lanes th whose position
    boxes have log areas `log_area` (L,)."""
    ll = logflux_logprior(th[:, :5], is_star, prior) - log_area
    ok = _in01(th[:, 5:7])
    if is_star:
        return torch.where(ok, ll, -torch.inf)
    frac_dev, axis_ratio, angle, radius = th[:, 7:11].unbind(-1)
    ok = (ok & (frac_dev >= 0.0) & (frac_dev <= 1.0)
          & (axis_ratio >= 0.0) & (axis_ratio <= 1.0)
          & (angle >= 0.0) & (angle <= np.pi) & (radius > 1e-5))
    # uniform frac_dev/axis_ratio (Beta(1,1)), uniform angle, lognormal radius
    r = torch.clamp(radius, min=1e-5)
    ll_radius = (-torch.log(r) - 0.5 * (LN2PI + np.log(PRIOR_GAL_RADIUS_VAR))
                 - (torch.log(r) - PRIOR_GAL_RADIUS_MEAN) ** 2
                 / (2.0 * PRIOR_GAL_RADIUS_VAR))
    ll = ll - np.log(np.pi) + ll_radius
    return torch.where(ok, ll, -torch.inf)


def star_logprior(th, tgt: SourceTarget, src=None,
                  prior: PriorConstants = None):
    return lane_logprior(th, True, _log_area(tgt, src), prior)


def gal_logprior(th, tgt: SourceTarget, src=None,
                 prior: PriorConstants = None):
    return lane_logprior(th, False, _log_area(tgt, src), prior)


def logpost_from_terms(loglike, logprior):
    """log posterior from its two terms: -inf wherever the prior is not
    finite (there the likelihood is not looked at)."""
    return torch.where(torch.isfinite(logprior), loglike + logprior,
                       -torch.inf)


def star_logpost(th, tgt: SourceTarget, src=None, tiles=None):
    return logpost_from_terms(star_loglike(th, tgt, src, tiles),
                              star_logprior(th, tgt, src))


def gal_logpost(th, tgt: SourceTarget, src=None, tiles=None):
    return logpost_from_terms(gal_loglike(th, tgt, src, tiles),
                              gal_logprior(th, tgt, src))


# ---------------------------------------------------------------------------
# Prior sampling (mcmc_functions.jl:615-645, 413-420)
# ---------------------------------------------------------------------------

def sample_lnfluxes(gen, n, is_star: bool, prior: PriorConstants):
    """n draws of the 5 log-fluxes from the flux and color priors: a normal
    lnr, then a color GMM component and a Cholesky normal draw."""
    i = 0 if is_star else 1
    kw = dict(dtype=prior.k.dtype, device=prior.k.device)
    lnr = (prior.flux_mean[i] + torch.sqrt(prior.flux_var[i])
           * torch.randn(n, generator=gen, **kw))
    d = torch.multinomial(prior.k[:, i], n, replacement=True, generator=gen)
    cov = torch.linalg.inv(prior.color_cov_inv[:, :, :, i].permute(2, 0, 1))
    chol = torch.linalg.cholesky(cov)                              # (8, 4, 4)
    z = torch.randn(n, 4, generator=gen, **kw)
    colors = (prior.color_mean[:, d, i].T
              + torch.einsum("nab,nb->na", chol[d], z))
    return colors_to_lnfluxes(lnr, colors)


def sample_star_prior(gen, n, prior: PriorConstants):
    lnf = sample_lnfluxes(gen, n, True, prior)
    u = torch.rand(n, 2, generator=gen, dtype=lnf.dtype, device=lnf.device)
    return torch.cat([lnf, u], dim=-1)


def sample_gal_prior(gen, n, prior: PriorConstants):
    lnf = sample_lnfluxes(gen, n, False, prior)
    kw = dict(generator=gen, dtype=lnf.dtype, device=lnf.device)
    u = torch.rand(n, 2, **kw)
    shape_u = torch.rand(n, 3, **kw)
    radius = torch.exp(PRIOR_GAL_RADIUS_MEAN + np.sqrt(PRIOR_GAL_RADIUS_VAR)
                       * torch.randn(n, **kw))
    shape = torch.stack([shape_u[:, 0], shape_u[:, 1], shape_u[:, 2] * np.pi,
                         radius], dim=-1)
    return torch.cat([lnf, u, shape], dim=-1)


def star_params_from_catalog(ce, tgt):
    """Star parameter vector (7,) numpy at a catalog entry, for a
    single-source target of numpy leaves."""
    u = world_to_uniform(np.asarray(ce.pos), tgt)
    return np.concatenate([np.log(np.maximum(ce.star_fluxes, 1e-6)), u])


def gal_params_from_catalog(ce, tgt):
    u = world_to_uniform(np.asarray(ce.pos), tgt)
    shape = np.array([ce.gal_frac_dev, ce.gal_axis_ratio,
                      np.mod(ce.gal_angle, np.pi),
                      max(ce.gal_radius_px, 1e-3)])
    return np.concatenate([np.log(np.maximum(ce.gal_fluxes, 1e-6)), u, shape])
