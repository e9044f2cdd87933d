"""Batched per-source ELBO maximization (port of
celeste_jl_tpu/vi/optimize.py; ElboMaximize.jl).

Each source is a lane of one batched Newton trust-region fit over its 41
free parameters. With grad_mode="ad" a trust-region step's (f, g) come
from torch.autograd through the tile render (vi/elbo.py): the gradient of
the sum over lanes of the per-lane negative ELBO is the per-lane
gradient, because lanes are independent. With grad_mode="analytic" they
come from _analytic_lik_value_grad (one render and weighted pixel sums on
flat fields), and a refresh's f, g and H all come from _analytic_lik_fgh.
The likelihood Hessian is analytic (a pixel pass + moment assembly), the
KL parts come from torch.autograd and torch.func. Only
hessian_mode="analytic" is ported. With a pixel_group (a torch.distributed
process group whose ranks hold row blocks of the same tiles,
parallel/mesh.py) each rank's (f, g) and (f, g, H) are all-reduced over
the group, the counterpart of maximize(pixel_axis=) in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import hessian, jacfwd, vmap

from ..models import mixture_derivs as md
from ..models.patches import pixel_coord_grids
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


def _flat_pixel_fields(off_b, pixels_b, mask_b, sky_b, iota_b, bg_E_b,
                       bg_var_b, P):
    """Each (source, band)'s tile fields flattened to (..., P*P): pixel
    coordinates x1, x2, the mask, the counts and iota where masked in (0
    and 1 elsewhere), sky + background and the background's variance."""
    dtype = pixels_b.dtype
    lead = pixels_b.shape[:-2]
    x1g, x2g = pixel_coord_grids(off_b, P, dtype)
    flat = lambda t: t.reshape(lead + (-1,))
    msk = flat(mask_b).to(dtype)
    return (flat(x1g), flat(x2g), msk,
            torch.where(msk > 0, flat(pixels_b), 0.0),
            torch.where(msk > 0, flat(iota_b), 1.0),
            flat(sky_b) + flat(bg_E_b), flat(bg_var_b))


def _band_flat_fields(theta6, psf_b, jac_b, wc_b, pc_b, off_b, pixels_b,
                      mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P):
    """Each (source, band)'s flat tile fields (_flat_pixel_fields), its
    star and galaxy mixtures and their flat unit-flux densities fs0, fs1:
    the head of the analytic refresh blocks. Every argument has the
    leading (source, band) axes of pixels_b (..., P, P)."""
    x1, x2, msk, x, iota, a0, b0 = _flat_pixel_fields(
        off_b, pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P)
    sm = md.star_mixture(theta6, psf_b, jac_b, wc_b, pc_b)
    gm = md.galaxy_mixture(theta6, psf_b, jac_b, wc_b, pc_b)
    fs0 = md.mixture_values(x1, x2, *sm)
    fs1 = md.mixture_values(x1, x2, *gm)
    return x1, x2, msk, x, iota, a0, b0, sm, gm, fs0, fs1


def _band_grad_fields(theta6, psf_b, jac_b, wc_b, pc_b, off_b, pixels_b,
                      mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P):
    """The (f, g) evaluator's head: _band_flat_fields' fields with each
    mixture's per-component fields (models/mixture_derivs.
    component_fields) and chain in place of its parameters, so the render
    runs once for the values and the gradient moments."""
    x1, x2, msk, x, iota, a0, b0 = _flat_pixel_fields(
        off_b, pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P)
    sm = md.star_mixture(theta6, psf_b, jac_b, wc_b, pc_b)
    gm = md.galaxy_mixture(theta6, psf_b, jac_b, wc_b, pc_b, second=False)
    cs = md.component_fields(x1, x2, *sm[:3])
    cg = md.component_fields(x1, x2, *gm[:3])
    fs0, fs1 = cs[-1].sum(dim=-2), cg[-1].sum(dim=-2)
    return msk, x, iota, a0, b0, (cs, sm[3]), (cg, gm[3]), fs0, fs1


def _band_poisson_bound(clb, cllb, msk, x, iota, a0, b0, fs0, fs1):
    """The masked Poisson lower bound of each (source, band) on flat
    fields (elbo_objective.jl:274-392): (lik (...), s1, s2, E, V), the
    intermediates for the derivative blocks. clb, cllb (..., 2)."""
    s1 = clb[..., 0, None] * fs0 + clb[..., 1, None] * fs1
    s2 = cllb[..., 0, None] * fs0 ** 2 + cllb[..., 1, None] * fs1 ** 2
    E = torch.where(msk > 0, a0 + s1, 1.0)
    V = torch.where(msk > 0, b0 + s2 - s1 ** 2, 0.0)
    phi = (x * (torch.log(iota) + torch.log(E) - V / (2.0 * E ** 2))
           - iota * E - torch.lgamma(x + 1.0))
    return torch.sum(msk * phi, dim=-1), s1, s2, E, V


def _poisson_grad_fields(clb, cllb, msk, x, iota, a0, b0, fs0, fs1):
    """The bound's value and its first-derivative weight fields:
    (lik, s1, E, V, g1 = d/d s1, g2 = d/d s2, W0, W1 = d/d fs0, fs1)."""
    lik, s1, _, E, V = _band_poisson_bound(clb, cllb, msk, x, iota, a0, b0,
                                           fs0, fs1)
    cl0, cl1 = clb[..., 0, None], clb[..., 1, None]
    cll0, cll1 = cllb[..., 0, None], cllb[..., 1, None]
    E2 = E * E
    phi_E = x / E + x * V / (E2 * E) - iota
    phi_V = -x / (2.0 * E2)
    g1 = msk * (phi_E - 2.0 * s1 * phi_V)
    g2 = msk * phi_V
    W0 = g1 * cl0 + g2 * (2.0 * cll0 * fs0)
    W1 = g1 * cl1 + g2 * (2.0 * cll1 * fs1)
    return lik, s1, E, V, g1, g2, W0, W1


def _band_lik_terms(theta6, clb, cllb, psf_b, jac_b, wc_b, pc_b, off_b,
                    pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P):
    """Each (source, band)'s analytic likelihood derivative blocks in
    (theta6, Cb) space, Cb = (cl0, cl1, cll0, cll1), on flat fields in
    plain torch: the JAX package's XLA refresh (elbo_objective.jl:274-392
    semantics). The fit's refresh runs ops/refresh.band_lik_terms_fused
    (K1 or its plain twin) instead; this is its flat-field statement,
    with the same contract: (lik (...), g_theta (..., 6), g_C (..., 4),
    H_tt (..., 6, 6), H_tC (..., 6, 4), H_CC (..., 4, 4))."""
    (x1, x2, msk, x, iota, a0, b0, sm, gm,
     fs0, fs1) = _band_flat_fields(
        theta6, psf_b, jac_b, wc_b, pc_b, off_b, pixels_b, mask_b, sky_b,
        iota_b, bg_E_b, bg_var_b, P)
    cl0, cl1 = clb[..., 0, None], clb[..., 1, None]
    cll0, cll1 = cllb[..., 0, None], cllb[..., 1, None]
    lik, s1, E, V, g1, g2, W0, W1 = _poisson_grad_fields(
        clb, cllb, msk, x, iota, a0, b0, fs0, fs1)

    E2 = E * E
    E3 = E2 * E
    phi_EE = -x / E2 - 3.0 * x * V / (E2 * E2)
    phi_EV = x / E3
    h11 = msk * (phi_EE - 4.0 * s1 * phi_EV) - 2.0 * g2
    h12 = msk * phi_EV
    u0 = 2.0 * cll0 * fs0
    u1 = 2.0 * cll1 * fs1

    _, J0, Hc0 = md.mixture_value_jac_hess(x1, x2, *sm, W0)
    _, J1, Hc1 = md.mixture_value_jac_hess(x1, x2, *gm, W1)

    f00 = h11 * cl0 * cl0 + 2.0 * h12 * cl0 * u0 + 2.0 * g2 * cll0
    f01 = h11 * cl0 * cl1 + h12 * (cl0 * u1 + u0 * cl1)
    f11 = h11 * cl1 * cl1 + 2.0 * h12 * cl1 * u1 + 2.0 * g2 * cll1
    quad = lambda Ja, f, Jb: torch.einsum("...in,...n,...jn->...ij", Ja, f,
                                          Jb)
    H_tt = (Hc0 + Hc1 + quad(J0, f00, J0) + quad(J0, f01, J1)
            + quad(J1, f01, J0) + quad(J1, f11, J1))
    dot = lambda J, w: torch.einsum("...tn,...n->...t", J, w)
    g_theta = dot(J0, W0) + dot(J1, W1)
    s = lambda t: torch.sum(t, dim=-1)
    g_C = torch.stack([s(g1 * fs0), s(g1 * fs1), s(g2 * fs0 ** 2),
                       s(g2 * fs1 ** 2)], dim=-1)

    # H_tC columns: d2 lik / d theta d{cl0, cl1, cll0, cll1}
    cols = []
    for j, fsj in ((0, fs0), (1, fs1)):
        A0 = h11 * fsj * cl0 + h12 * fsj * u0 + (g1 if j == 0 else 0.0)
        A1 = h11 * fsj * cl1 + h12 * fsj * u1 + (g1 if j == 1 else 0.0)
        cols.append(dot(J0, A0) + dot(J1, A1))
    for j, fsj in ((0, fs0), (1, fs1)):
        A0 = h12 * fsj ** 2 * cl0 + (2.0 * g2 * fs0 if j == 0 else 0.0)
        A1 = h12 * fsj ** 2 * cl1 + (2.0 * g2 * fs1 if j == 1 else 0.0)
        cols.append(dot(J0, A0) + dot(J1, A1))
    H_tC = torch.stack(cols, dim=-1)                          # (..., 6, 4)

    pair = lambda a, b, c, d: torch.stack([torch.stack([a, b], -1),
                                           torch.stack([c, d], -1)], -2)
    hcl = pair(s(h11 * fs0 * fs0), s(h11 * fs0 * fs1),
               s(h11 * fs0 * fs1), s(h11 * fs1 * fs1))
    hx = pair(s(h12 * fs0 * fs0 ** 2), s(h12 * fs0 * fs1 ** 2),
              s(h12 * fs1 * fs0 ** 2), s(h12 * fs1 * fs1 ** 2))
    H_CC = torch.cat([torch.cat([hcl, hx], -1),
                      torch.cat([hx.transpose(-1, -2), torch.zeros_like(hcl)],
                                -1)], -2)
    return lik, g_theta, g_C, H_tt, H_tC, H_CC


def _band_lik_grad(theta6, clb, cllb, psf_b, jac_b, wc_b, pc_b, off_b,
                   pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P):
    """Each (source, band)'s likelihood value and gradient in (theta6, Cb)
    space, the degree-<=2 moment subset of _band_lik_terms (no Hessian
    blocks): (lik (...), g_theta (..., 6), g_C (..., 4))."""
    msk, x, iota, a0, b0, (cs, chain_s), (cg, chain_g), fs0, fs1 = \
        _band_grad_fields(theta6, psf_b, jac_b, wc_b, pc_b, off_b, pixels_b,
                          mask_b, sky_b, iota_b, bg_E_b, bg_var_b, P)
    lik, _, _, _, g1, g2, W0, W1 = _poisson_grad_fields(
        clb, cllb, msk, x, iota, a0, b0, fs0, fs1)
    g_theta = (md.grad_from_fields(cs, chain_s, W0)
               + md.grad_from_fields(cg, chain_g, W1))
    s = lambda t: torch.sum(t, dim=-1)
    g_C = torch.stack([s(g1 * fs0), s(g1 * fs1), s(g2 * fs0 ** 2),
                       s(g2 * fs1 ** 2)], dim=-1)
    return lik, g_theta, g_C


def _band_args(free, bounds, patch, bg_E_G, bg_var_G):
    """The per-(source, band) arguments of the band evaluators, in the
    band functions' order, each with leading (S, B) axes, and vp."""
    S, B = patch.pixels.shape[:2]
    vp = to_bound(free, bounds)
    C20 = brightness_coeffs(vp)
    bg_E = bg_E_G if bg_E_G is not None else torch.zeros_like(patch.sky)
    bg_V = bg_var_G if bg_var_G is not None else torch.zeros_like(patch.sky)
    args = (vp[:, None, 0:6].expand(S, B, 6), C20[:, :10].reshape(S, 5, 2),
            C20[:, 10:].reshape(S, 5, 2), patch.psf, patch.wcs_jacobian,
            patch.world_center, patch.pixel_center, patch.offset,
            patch.pixels, patch.mask, patch.sky, patch.iota, bg_E, bg_V,
            tuple(patch.pixels.shape[-2:]))
    return args, vp


def _lane_chunks(fn, args, S, elems_per_lane):
    """fn over lane chunks of args (leading S axis; the last argument, P,
    whole) whose (C, N) fields stay near 2^24 elements on the CPU (whose
    memory the host shares) and 2^28 on a card (where each chunk repeats
    every launch), concatenated."""
    budget = 1 << (28 if args[-2].device.type == "cuda" else 24)
    step = max(1, budget // max(elems_per_lane, 1))
    if step >= S:
        return fn(*args)
    outs = [fn(*(a[i:i + step] for a in args[:-1]), args[-1])
            for i in range(0, S, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _field_elems(patch):
    """Elements of one lane's (band, component, pixel) field."""
    B, K = patch.psf.shape[1:3]
    return B * 15 * K * patch.pixels.shape[-1] * patch.pixels.shape[-2]


def _analytic_lik_value_grad(free, bounds, patch, bg_E_G=None,
                             bg_var_G=None):
    """Each lane's likelihood value and exact gradient with respect to its
    free parameters: analytic per-band (theta6, C20) gradients
    (_band_lik_grad, one render and 12 degree-<=2 weighted pixel sums a
    band) chained through the pixel-free map free -> (theta6, C20) by one
    reverse pass. Returns (lik (S,), g (S, 41))."""
    S = free.shape[0]
    args, _ = _band_args(free, bounds, patch, bg_E_G, bg_var_G)
    lik_b, g_t_b, g_C_b = _lane_chunks(_band_lik_grad, args, S,
                                       _field_elems(patch))
    g_ord = torch.cat([g_t_b.sum(1), g_C_b.reshape(S, -1)], dim=-1)
    g26 = g_ord @ torch.as_tensor(_PERM26, dtype=free.dtype,
                                  device=free.device).T
    with torch.enable_grad():
        fr = free.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_h26(fr, *bounds), fr, grad_outputs=g26)
    return lik_b.sum(1), g


def _analytic_lik_fgh(free, bounds, patch, bg_E_G=None, bg_var_G=None,
                      refresh_kernel="xla"):
    """Exact likelihood (value, gradient, Hessian) of each lane with
    respect to its free parameters: analytic per-band blocks in
    (theta6, C20) space from one pixel pass, chained through the
    pixel-free map free -> (theta6, C20) with torch.func.

    free (S, 41); bounds (S, 26) each; patch (S, B, ...).
    refresh_kernel: "pallas" routes the pixel pass through
    ops/refresh.pixel_terms (the CUDA kernel K1 on CUDA tensors, its plain
    twin on CPU tensors), "xla" through the plain twin.
    Returns (lik (S,), g (S, 41), H (S, 41, 41)).
    """
    S = free.shape[0]
    B = patch.pixels.shape[1]
    dtype = free.dtype
    args, _ = _band_args(free, bounds, patch, bg_E_G, bg_var_G)
    terms = pixel_terms if refresh_kernel == "pallas" else pixel_terms_plain
    lik_b, g_t_b, g_C_b, H_tt_b, H_tC_b, H_CC_b = band_lik_terms_fused(
        *args, terms=terms)

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


def _all_reduce_lanes(parts, group):
    """Sum each (S, ...) tensor of `parts` over the ranks of `group` with
    one all_reduce of their lanes laid side by side."""
    S = parts[0].shape[0]
    widths = [int(np.prod(t.shape[1:])) for t in parts]
    flat = torch.cat([t.reshape(S, n) for t, n in zip(parts, widths)],
                     dim=-1)
    dist.all_reduce(flat, group=group)
    return tuple(block.reshape(t.shape) for t, block in
                 zip(parts, torch.split(flat, widths, dim=-1)))


def fit_evaluators(bounds, patches, bg_E_G=None, bg_var_G=None,
                   include_kl=True, refresh="xla", grad_mode="ad",
                   pixel_group=None):
    """The fit's two evaluators of every lane's negative ELBO at free
    (S, 41): fg(free) -> (f, g), a trust-region step's, and
    fgh(free) -> (f, g, H), a refresh's. grad_mode "ad": fg by autograd
    through the tile render, and fgh its (f, g) with the analytic
    likelihood Hessian; "analytic": fg from _analytic_lik_value_grad and
    fgh's f, g and H all from one _analytic_lik_fgh pass. refresh: that
    pass's route (_analytic_lik_fgh's refresh_kernel). The KL parts come
    from autograd and torch.func.

    pixel_group: a process group whose ranks each hold a row block of
    the same tiles (JAX maximize's pixel_axis). Each rank then carries
    1 / size of the KL, and fg's (f, g) and fgh's (f, g, H) are summed
    over the group once each, so every rank of the group gets the same
    bits and takes the same steps."""
    prior = default_prior(bounds.lower.device, bounds.lower.dtype)
    analytic = grad_mode == "analytic"
    n_pix = 1 if pixel_group is None else dist.get_world_size(pixel_group)

    def kl(vp):
        out = subtract_kl(vp, prior)
        return out if pixel_group is None else out / n_pix

    def neg_elbo(free):
        vp = to_bound(free, bounds)
        fs0m, fs1m = source_fs_grids(vp, patches)
        E_G_s, var_G_s = moment_grids_from_fs(brightness_coeffs(vp), fs0m,
                                              fs1m)
        ll = pixel_log_likelihood(E_G_s, var_G_s, patches, bg_E_G, bg_var_G)
        if include_kl:
            ll = ll + kl(vp)
        return -ll

    def neg_kl(free):
        return -kl(to_bound(free, bounds))

    def kl_lane(fr, lo, up, sc):
        return kl(to_bound(fr, BoxBounds(lo, up, sc)))

    def value_grad(fn, free):
        with torch.enable_grad():
            fr = free.detach().requires_grad_(True)
            f = fn(fr)
            (g,) = torch.autograd.grad(f.sum(), fr)
        return f.detach(), g

    def with_kl(f, g, free):
        if not include_kl:
            return f, g
        f_kl, g_kl = value_grad(neg_kl, free)
        return f + f_kl, g + g_kl

    def fg_raw(free):
        # this rank's (f, g), before any sum over the pixel group
        if analytic:
            lik, g_lik = _analytic_lik_value_grad(free, bounds, patches,
                                                  bg_E_G, bg_var_G)
            return with_kl(-lik, -g_lik, free)
        return value_grad(neg_elbo, free)

    def fg(free):
        f, g = fg_raw(free)
        if pixel_group is not None:
            f, g = _all_reduce_lanes((f, g), pixel_group)
        return f, g

    def fgh(free):
        lik, g_lik, H_lik = _analytic_lik_fgh(free, bounds, patches, bg_E_G,
                                              bg_var_G, refresh)
        # grad_mode="ad": the refresh's f, g are the steps' (autograd)
        f, g = with_kl(-lik, -g_lik, free) if analytic else fg_raw(free)
        H = -H_lik
        if include_kl:
            H = H - vmap(hessian(kl_lane))(free, *bounds).to(H.dtype)
        if pixel_group is not None:
            f, g, H = _all_reduce_lanes((f, g, H), pixel_group)
        return f, g, H

    return fg, fgh


def fit_sources(vp0s, patches, bg_E_G=None, bg_var_G=None, include_kl=True,
                config: NewtonConfig = NewtonConfig(),
                hessian_mode="analytic", delta0=None, bounds_pos=None,
                free0=None, converged0=None, loc_width=1e-4, loc_scale=1.0,
                plain=False, pixel_group=None):
    """Fit every source of the batch: vp0s (S, 44), patches a SkyPatch with
    leading S axis, optional fixed neighbor images bg_E_G / bg_var_G
    (S, B, P, P). Returns a FitResult with leading S axis.

    delta0 (S,) / bounds_pos (S, 2) / free0 (S, 41) / converged0 (S,):
    warm-resume state of staged compaction — the previous stage's radius,
    the ORIGINAL position-box centers, the previous free vector (vp0s is
    then ignored) and the converged flags (those lanes stay frozen).
    plain=True runs every kernel's plain twin (the comparison route).
    pixel_group: the process group over which the tiles' rows are split
    (fit_evaluators); every rank of it passes the same vp0s and its own
    row block of each tile, with offsets that place the block.
    """
    if hessian_mode != "analytic":
        raise NotImplementedError(f"hessian_mode={hessian_mode!r}")
    if config.grad_mode not in ("ad", "analytic"):
        raise NotImplementedError(f"grad_mode={config.grad_mode!r}")
    with torch.no_grad():
        return _fit(vp0s, patches, bg_E_G, bg_var_G, include_kl, config,
                    delta0, bounds_pos, free0, converged0, loc_width,
                    loc_scale, plain, pixel_group)


def _fit(vp0s, patches, bg_E_G, bg_var_G, include_kl, config, delta0,
         bounds_pos, free0, converged0, loc_width, loc_scale, plain,
         pixel_group):
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
    fg, fgh = fit_evaluators(bounds, patches, bg_E_G, bg_var_G, include_kl,
                             refresh="xla" if plain
                             else config.refresh_kernel,
                             grad_mode=config.grad_mode,
                             pixel_group=pixel_group)
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
