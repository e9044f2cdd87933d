"""Batched per-source ELBO maximization (port of
celeste_jl_tpu/vi/optimize.py; ElboMaximize.jl).

Each source is a lane of one batched Newton trust-region fit over its 41
free parameters. (f, g) come from torch.autograd through the tile render
(vi/elbo.py): the gradient of the sum over lanes of the per-lane negative
ELBO is the per-lane gradient, because lanes are independent. The Hessian
is analytic (refresh pixel pass + moment assembly) plus the KL Hessian by
torch.func. Only hessian_mode="analytic" and grad_mode="ad" are ported.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from ..ops.bijectors import (BoxBounds, default_box_bounds, enforce,
                             to_bound, to_free)
from ..ops.newton import NewtonConfig, minimize_newton_tr
from ..ops.refresh import band_lik_terms_fused, pixel_terms, pixel_terms_plain
from .elbo import (brightness_coeffs, default_prior, moment_grids_from_fs,
                   pixel_log_likelihood, source_fs_grids, subtract_kl)


class FitResult(NamedTuple):
    vp: torch.Tensor         # (S, 44) optimized canonical params
    elbo: torch.Tensor       # (S,) final ELBO
    iters: torch.Tensor      # (S,) trust-region steps
    f_calls: torch.Tensor
    converged: torch.Tensor
    # warm-resume state for staged compaction: final radius and final FREE
    # vector (resuming from vp would need to_free(vp), ill-conditioned in
    # f32 at the position-box edges)
    delta: torch.Tensor
    free: torch.Tensor       # (S, 41)


def _make_bounds(pos, loc_width=1e-4, loc_scale=1.0):
    """Box bounds of each lane, position box centered on pos (S, 2)."""
    return default_box_bounds(pos, loc_width, loc_scale)


# C20 column indices per band: (cl0, cl1, cll0, cll1) -> flat C layout.
_C_COLS = np.array([[2 * b, 2 * b + 1, 10 + 2 * b, 10 + 2 * b + 1]
                    for b in range(5)])

# Constant permutation [theta6, band-major (cl0, cl1, cll0, cll1) blocks]
# -> [theta6, C20 layout].
_PERM26 = np.zeros((26, 26), np.float64)
for _t in range(6):
    _PERM26[_t, _t] = 1.0
for _b in range(5):
    for _j, _c in enumerate(_C_COLS[_b]):
        _PERM26[6 + _c, 6 + 4 * _b + _j] = 1.0


def _h26(free, lower, upper, scale):
    """The pixel-free map free (41,) -> [theta6, C20] (26,)."""
    v = to_bound(free, BoxBounds(lower, upper, scale))
    return torch.cat([v[..., 0:6], brightness_coeffs(v)], dim=-1)


def _analytic_lik_fgh(free, bounds, patch, bg_E_G=None, bg_var_G=None,
                      refresh_kernel="xla"):
    """Exact likelihood (value, gradient, Hessian) of each lane with
    respect to its free parameters: analytic per-band blocks in
    (theta6, C20) space from one refresh pixel pass, chained through the
    pixel-free map free -> (theta6, C20) with torch.func.

    free (S, 41); bounds (S, 26) each; patch (S, B, ...).
    refresh_kernel: "pallas" routes the pixel pass through
    ops/refresh.pixel_terms (the CUDA kernel on CUDA tensors), "xla"
    through its plain twin. Returns (lik (S,), g (S, 41), H (S, 41, 41)).
    """
    S = free.shape[0]
    B = patch.pixels.shape[1]
    dtype = free.dtype
    vp = to_bound(free, bounds)
    theta6 = vp[:, 0:6]
    C20 = brightness_coeffs(vp)
    cl = C20[:, :10].reshape(S, 5, 2)
    cll = C20[:, 10:].reshape(S, 5, 2)
    P = tuple(patch.pixels.shape[-2:])
    bg_E = bg_E_G if bg_E_G is not None else torch.zeros_like(patch.sky)
    bg_V = bg_var_G if bg_var_G is not None else torch.zeros_like(patch.sky)
    terms = pixel_terms if refresh_kernel == "pallas" else pixel_terms_plain

    lik_b, g_t_b, g_C_b, H_tt_b, H_tC_b, H_CC_b = band_lik_terms_fused(
        theta6[:, None, :].expand(S, B, 6), cl, cll, patch.psf,
        patch.wcs_jacobian, patch.world_center, patch.pixel_center,
        patch.offset, patch.pixels, patch.mask, patch.sky, patch.iota,
        bg_E, bg_V, P, terms=terms)

    # Band-ordered assembly (theta, then 4 coefficients per band), then the
    # constant permutation into the C20 layout.
    g_ord = torch.cat([g_t_b.sum(1), g_C_b.reshape(S, 4 * B)], dim=-1)
    H_tC_ord = H_tC_b.permute(0, 2, 1, 3).reshape(S, 6, 4 * B)
    HCC_ord = torch.zeros((S, 4 * B, 4 * B), dtype=dtype, device=free.device)
    for b in range(B):
        HCC_ord[:, 4 * b:4 * b + 4, 4 * b:4 * b + 4] = H_CC_b[:, b]
    H_ord = torch.cat([torch.cat([H_tt_b.sum(1), H_tC_ord], dim=-1),
                       torch.cat([H_tC_ord.mT, HCC_ord], dim=-1)], dim=-2)
    perm = torch.as_tensor(_PERM26, dtype=dtype, device=free.device)
    g26 = g_ord @ perm.T
    H26 = perm @ H_ord @ perm.T

    # (cast: forward-mode AD may return float64 for float32 inputs)
    J_h = vmap(jacfwd(_h26))(free, *bounds).to(dtype)        # (S, 26, 41)
    T_h = vmap(jacfwd(jacfwd(_h26)))(free, *bounds).to(dtype)
    g_free = (J_h.mT @ g26[..., None])[..., 0]
    H_free = J_h.mT @ H26 @ J_h + torch.einsum("sa,saij->sij", g26, T_h)
    return lik_b.sum(1), g_free, H_free


def fit_sources(vp0s, patches, bg_E_G=None, bg_var_G=None, include_kl=True,
                config: NewtonConfig = NewtonConfig(),
                hessian_mode="analytic", delta0=None, bounds_pos=None,
                free0=None, converged0=None, loc_width=1e-4, loc_scale=1.0,
                plain=False):
    """Fit every source of the batch: vp0s (S, 44), patches a SkyPatch with
    leading S axis, optional fixed neighbor images bg_E_G / bg_var_G
    (S, B, P, P). Returns a FitResult with leading S axis.

    delta0 (S,) / bounds_pos (S, 2) / free0 (S, 41) / converged0 (S,):
    warm-resume state of staged compaction — the previous stage's radius,
    the ORIGINAL position-box centers, the previous free vector (vp0s is
    then ignored) and the converged flags (those lanes stay frozen).
    plain=True runs every kernel's plain twin (the comparison route).
    """
    if hessian_mode != "analytic":
        raise NotImplementedError(f"hessian_mode={hessian_mode!r}")
    if config.grad_mode != "ad":
        raise NotImplementedError(f"grad_mode={config.grad_mode!r}")
    with torch.no_grad():
        return _fit(vp0s, patches, bg_E_G, bg_var_G, include_kl, config,
                    delta0, bounds_pos, free0, converged0, loc_width,
                    loc_scale, plain)


def _fit(vp0s, patches, bg_E_G, bg_var_G, include_kl, config, delta0,
         bounds_pos, free0, converged0, loc_width, loc_scale, plain):
    # Fit in world coordinates relative to each lane's position-box center:
    # the box is 2 loc_width wide (2e-4), float32's spacing is 1.2e-4 at
    # 1024 and 2.4e-4 at 2048, where the box would hold one or two
    # positions. Subtracting the origin from the patch's world
    # center and from vp0 is exact; the free vector does not depend on it.
    origin = (vp0s[:, 0:2] if bounds_pos is None else bounds_pos).to(
        vp0s.dtype)
    vp0s = torch.cat([vp0s[:, 0:2] - origin, vp0s[:, 2:]], dim=-1)
    patches = patches._replace(
        world_center=patches.world_center - origin[:, None, :])
    bounds = _make_bounds(torch.zeros_like(origin), loc_width, loc_scale)
    if free0 is None:
        free0 = to_free(enforce(vp0s, bounds), bounds)
    prior = default_prior(vp0s.device, vp0s.dtype)
    refresh = "xla" if plain else config.refresh_kernel

    def neg_elbo(free):
        vp = to_bound(free, bounds)
        fs0m, fs1m = source_fs_grids(vp, patches)
        E_G_s, var_G_s = moment_grids_from_fs(brightness_coeffs(vp), fs0m,
                                              fs1m)
        ll = pixel_log_likelihood(E_G_s, var_G_s, patches, bg_E_G, bg_var_G)
        if include_kl:
            ll = ll + subtract_kl(vp, prior)
        return -ll

    def kl_lane(fr, lo, up, sc):
        return subtract_kl(to_bound(fr, BoxBounds(lo, up, sc)), prior)

    def fg(free):
        with torch.enable_grad():
            fr = free.detach().requires_grad_(True)
            f = neg_elbo(fr)
            (g,) = torch.autograd.grad(f.sum(), fr)
        return f.detach(), g

    def fgh(free):
        f, g = fg(free)
        H = -_analytic_lik_fgh(free, bounds, patches, bg_E_G, bg_var_G,
                               refresh)[2]
        if include_kl:
            H = H - vmap(hessian(kl_lane))(free, *bounds).to(H.dtype)
        return f, g, H

    st = minimize_newton_tr(fgh, free0, config, fg=fg, delta0=delta0,
                            converged0=converged0, plain=plain)
    vp = to_bound(st.x, bounds)
    vp = torch.cat([vp[:, 0:2] + origin, vp[:, 2:]], dim=-1)
    return FitResult(vp=vp, elbo=-st.f, iters=st.iters,
                     f_calls=st.f_calls, converged=st.converged,
                     delta=st.delta, free=st.x)


def fit_sources_compacted(vp0s, patches, bg_E_G=None, bg_var_G=None, *,
                          include_kl=True,
                          config: NewtonConfig = NewtonConfig(),
                          hessian_mode="analytic", stage1_refreshes=10,
                          min_bucket=64, stage2_hess_every=None,
                          plain=False):
    """Batched fits with convergence compaction, in two stages.

    Stage 1 runs `stage1_refreshes` refresh cycles on the full batch; the
    unconverged lanes are then gathered into a power-of-two bucket (padded
    by repeating unconverged lanes) and finished there, resuming each
    lane's free vector, radius and ORIGINAL position box. Per lane the
    result equals one fit_sources call, unless stage2_hess_every stretches
    the stage-2 refresh period.
    """
    S = vp0s.shape[0]
    kw = dict(include_kl=include_kl, hessian_mode=hessian_mode, plain=plain)
    stage1 = min(stage1_refreshes, config.max_iters)
    res1 = fit_sources(vp0s, patches, bg_E_G, bg_var_G,
                       config=config._replace(max_iters=stage1), **kw)
    conv = res1.converged.cpu().numpy()
    rem = config.max_iters - stage1
    if rem <= 0 or conv.all():
        return res1

    idx = np.nonzero(~conv)[0]
    n = idx.size
    bucket = max(min_bucket, 1 << int(n - 1).bit_length())
    if bucket >= S:
        # nothing to gain: finish the full batch in place
        idx = np.arange(S)
        n, bucket = S, S
    pad = idx[np.arange(bucket - n) % n] if bucket > n else idx[:0]
    dev = vp0s.device
    idx_p = torch.as_tensor(np.concatenate([idx, pad]), device=dev)
    sub = lambda a: None if a is None else a[idx_p]

    cfg2 = config._replace(max_iters=rem)
    if stage2_hess_every is not None:
        cfg2 = cfg2._replace(hess_every=stage2_hess_every)
    # converged0 matters for the in-place path, where converged lanes are
    # re-submitted and must stay frozen
    res2 = fit_sources(sub(res1.vp), patches.index(idx_p), sub(bg_E_G),
                       sub(bg_var_G), config=cfg2, delta0=sub(res1.delta),
                       bounds_pos=vp0s[idx_p][:, 0:2], free0=sub(res1.free),
                       converged0=sub(res1.converged), **kw)

    jidx = torch.as_tensor(idx, device=dev)

    def merge(a1, a2, accumulate=False):
        out = a1.clone()
        if accumulate:
            out[jidx] += a2[:n]
        else:
            out[jidx] = a2[:n]
        return out

    return FitResult(
        vp=merge(res1.vp, res2.vp), elbo=merge(res1.elbo, res2.elbo),
        iters=merge(res1.iters, res2.iters, accumulate=True),
        f_calls=merge(res1.f_calls, res2.f_calls, accumulate=True),
        converged=merge(res1.converged, res2.converged),
        delta=merge(res1.delta, res2.delta), free=merge(res1.free, res2.free))
