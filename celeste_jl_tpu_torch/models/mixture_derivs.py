"""Analytic derivatives of Gaussian-mixture pixel renders (port of
celeste_jl_tpu/models/mixture_derivs.py; BivariateNormals.jl:208-404).

A component's density is g = w N(x; mu, Sigma). With l = Lam (x - mu),
every derivative of log g with respect to eta = (mu1, mu2, s11, s12, s22,
log w) is a polynomial of degree <= 2 in l, so a weight-contracted shape
Hessian sum_px W d2 fs/dtheta2 reduces to per-component pixel moments
M_c = sum_px W g_c b b' of the basis b = [1, l1, l2, l1^2, l1 l2, l2^2],
composed with the chain matrices d eta / d theta (theta = pos(2),
gal_frac_dev, gal_axis_ratio, gal_angle, gal_radius_px).

Every function broadcasts over leading (source, band) axes.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from .bvn import get_bvn_cov
from .fsm import galaxy_prototypes, linear_world_to_pix
from .psf import psf_alphas, psf_covs, psf_mus

TWO_PI = 6.283185307179586

MU1, MU2, S11, S12, S22, LOGW = range(6)
POS1, POS2, FDEV, AXIS, ANGLE, RADIUS = range(6)


def _vech(qtr):
    c = get_bvn_cov(qtr[0], qtr[1], qtr[2])
    return torch.stack([c[0, 0], c[0, 1], c[1, 1]])


def vech_cov_chain(axis_ratio, angle, radius, second=True):
    """A = d vech(XiXi) / d(axis_ratio, angle, radius) (..., 3, 3) and its
    second derivative T (..., 3, 3, 3) (None unless `second`), by
    forward-mode AD per element (replaces GalaxySigmaDerivs,
    BivariateNormals.jl:331-404)."""
    qtr = torch.stack([axis_ratio, angle, radius], dim=-1)
    lead = qtr.shape[:-1]
    flat = qtr.reshape(-1, 3)
    # forward-mode AD of a float32 0-dim tensor minus a Python float comes
    # back float64; cast to the input's dtype
    A = vmap(jacfwd(_vech))(flat).to(qtr.dtype).reshape(lead + (3, 3))
    if not second:
        return A, None
    T = vmap(jacfwd(jacfwd(_vech)))(flat).to(qtr.dtype)
    return A, T.reshape(lead + (3, 3, 3))


def eta_basis_rows(L00, L01, L11):
    """R[..., a, b]: eta-derivative a of log g in the degree-2 basis b,
    (..., 6, 6) from (...) precision entries."""
    zc = torch.zeros_like(L00)
    oc = torch.ones_like(L00)
    half = 0.5 * oc
    return torch.stack([
        torch.stack([zc, oc, zc, zc, zc, zc], -1),            # d/dmu1
        torch.stack([zc, zc, oc, zc, zc, zc], -1),            # d/dmu2
        torch.stack([-0.5 * L00, zc, zc, half, zc, zc], -1),  # d/ds11
        torch.stack([-L01, zc, zc, zc, oc, zc], -1),          # d/ds12
        torch.stack([-0.5 * L11, zc, zc, zc, zc, half], -1),  # d/ds22
        torch.stack([oc, zc, zc, zc, zc, zc], -1),            # d/dlogw
    ], dim=-2)


# Flat order of the 15 distinct moments m_ab = sum_px W g l1^a l2^b:
#   [m00, m10, m01, m20, m11, m02, m30, m21, m12, m03,
#    m40, m31, m22, m13, m04]
# and the (6, 6) basis-moment matrix as indices into it.
MOMENT_IDX = np.asarray([
    [0, 1, 2, 3, 4, 5],
    [1, 3, 4, 6, 7, 8],
    [2, 4, 5, 7, 8, 9],
    [3, 6, 7, 10, 11, 12],
    [4, 7, 8, 11, 12, 13],
    [5, 8, 9, 12, 13, 14],
])


def moment_matrix(m15):
    """(..., C, 15) flat moments -> (..., C, 6, 6) symmetric basis-moment
    matrices."""
    idx = torch.as_tensor(MOMENT_IDX.reshape(-1), device=m15.device)
    return m15[..., idx].reshape(m15.shape[:-1] + (6, 6))


_E = np.asarray([[[1.0, 0.0], [0.0, 0.0]],
                 [[0.0, 1.0], [1.0, 0.0]],
                 [[0.0, 0.0], [0.0, 1.0]]])


def hess_from_moments(M, L00, L01, L11, P, chain, chain2):
    """Weight-contracted shape Hessian of one mixture, (..., 6, 6).

    M (..., C, 6, 6) W-weighted basis moments; L00/L01/L11 (..., C)
    precision entries; P (..., C, 6theta, 6b) chain-composed basis
    coefficients; chain (..., C, 6eta, 6theta); chain2 (..., C, 6eta,
    6theta, 6theta)."""
    # Term 1: sum W g Dtheta Dtheta' = P M P'.
    H = torch.einsum("...ctb,...cbd,...cud->...tu", P, M, P)

    # Term 2: chain' D2M chain, D2M = sum W g D2log in eta space.
    Lam = torch.stack([torch.stack([L00, L01], -1),
                       torch.stack([L01, L11], -1)], -2)      # (..., C, 2, 2)
    m0 = M[..., 0, 0]
    m1 = M[..., 0, 1:3]
    M2 = M[..., 1:3, 1:3]
    E = torch.as_tensor(_E, dtype=M.dtype, device=M.device)
    G = -torch.einsum("...cax,exy->...ceay", Lam, E)          # (..., C, 3, 2, 2)
    LEL = torch.einsum("...cax,exy,...cyb->...ceab", Lam, E, Lam)
    mu_s = torch.einsum("...ceay,...cy->...cae", G, m1)       # (..., C, 2, 3)
    GM2 = torch.einsum("...ceay,...cyb->...ceab", G, M2)
    Vs = 0.5 * (GM2 + GM2.transpose(-1, -2) + m0[..., None, None, None] * LEL)
    ss = torch.stack([Vs[..., 0, 0], 2.0 * Vs[..., 0, 1], Vs[..., 1, 1]],
                     dim=-2)                                  # (..., C, 3, 3)
    lead = M.shape[:-2]
    z = lambda *s: torch.zeros(lead + s, dtype=M.dtype, device=M.device)
    D2M = torch.cat([
        torch.cat([-Lam * m0[..., None, None], mu_s, z(2, 1)], -1),
        torch.cat([mu_s.transpose(-1, -2), ss, z(3, 1)], -1),
        z(1, 6),
    ], dim=-2)                                                # (..., C, 6, 6)
    H = H + torch.einsum("...cat,...cab,...cbu->...tu", chain, D2M, chain)

    # Term 3: sum W g Dlog_a d2 eta_a / dtheta2.
    DlogM = torch.stack([
        m1[..., 0], m1[..., 1],
        0.5 * (M2[..., 0, 0] - L00 * m0),
        M2[..., 0, 1] - L01 * m0,
        0.5 * (M2[..., 1, 1] - L11 * m0),
        m0], dim=-1)                                          # (..., C, 6)
    return H + torch.einsum("...ca,...catu->...tu", DlogM, chain2)


def _mu_rows(wcs_jacobian):
    """Chain rows of the two mean etas: [J | 0], (..., 2, 6)."""
    z = torch.zeros(wcs_jacobian.shape[:-1] + (4,), dtype=wcs_jacobian.dtype,
                    device=wcs_jacobian.device)
    return torch.cat([wcs_jacobian, z], dim=-1)


def star_mixture(theta6, psf_b, wcs_jacobian, world_center, pixel_center):
    """Star = PSF mixture at the source position. Returns (means (..., K, 2),
    covs (..., K, 2, 2), weights (..., K), chain (..., K, 6, 6),
    chain2 (..., K, 6, 6, 6))."""
    m_pos = linear_world_to_pix(wcs_jacobian, world_center, pixel_center,
                                theta6[..., 0:2])
    means = psf_mus(psf_b) + m_pos[..., None, :]
    covs = psf_covs(psf_b)
    weights = psf_alphas(psf_b)
    lead, K = means.shape[:-2], means.shape[-2]
    kw = dict(dtype=psf_b.dtype, device=psf_b.device)
    chain = torch.cat([_mu_rows(wcs_jacobian),
                       torch.zeros(lead + (4, 6), **kw)], dim=-2)
    chain = chain[..., None, :, :].expand(lead + (K, 6, 6))
    chain2 = torch.zeros(lead + (K, 6, 6, 6), **kw)
    return means, covs, weights, chain, chain2


def galaxy_mixture(theta6, psf_b, wcs_jacobian, world_center, pixel_center,
                   second=True):
    """Galaxy = PSF x (8 de Vaucouleurs + 6 exponential) profile mixture
    (model/fsm_util.jl:111-169), C = 14 K components, same return layout as
    star_mixture; chain2 is None unless `second` (the gradient needs only
    chain)."""
    kw = dict(dtype=psf_b.dtype, device=psf_b.device)
    frac_dev = theta6[..., FDEV, None]
    m_pos = linear_world_to_pix(wcs_jacobian, world_center, pixel_center,
                                theta6[..., 0:2])

    eta, nu, is_dev = galaxy_prototypes(psf_b)               # (14,)
    frac = is_dev * frac_dev + (1.0 - is_dev) * (1.0 - frac_dev)
    dlogw_dfd = (2.0 * is_dev - 1.0) / frac                  # (..., 14)

    a = psf_alphas(psf_b)
    mu = psf_mus(psf_b)
    cv = psf_covs(psf_b)
    K, n_gal = mu.shape[-2], eta.shape[0]
    lead = mu.shape[:-2]
    C = K * n_gal

    XiXi = get_bvn_cov(theta6[..., AXIS], theta6[..., ANGLE],
                       theta6[..., RADIUS])
    A, T = vech_cov_chain(theta6[..., AXIS], theta6[..., ANGLE],
                          theta6[..., RADIUS], second)

    weights = (a[..., :, None] * (eta * frac)[..., None, :]).reshape(
        lead + (C,))
    covs = (cv[..., :, None, :, :]
            + nu[:, None, None] * XiXi[..., None, None, :, :]).reshape(
        lead + (C, 2, 2))
    means = ((mu + m_pos[..., None, :])[..., :, None, :]
             .expand(lead + (K, n_gal, 2)).reshape(lead + (C, 2)))

    nu_flat = nu.expand(K, n_gal).reshape(C)
    dlw = dlogw_dfd[..., None, :].expand(lead + (K, n_gal)).reshape(
        lead + (C,))

    mu_rows = _mu_rows(wcs_jacobian)[..., None, :, :].expand(lead + (C, 2, 6))
    s_rows = torch.cat([
        torch.zeros(lead + (C, 3, 3), **kw),
        nu_flat[:, None, None] * A[..., None, :, :]], dim=-1)
    zc = torch.zeros_like(dlw)
    w_row = torch.stack([zc, zc, dlw, zc, zc, zc], dim=-1)[..., None, :]
    chain = torch.cat([mu_rows, s_rows, w_row], dim=-2)      # (..., C, 6, 6)
    if not second:
        return means, covs, weights, chain, None

    s2 = F.pad(nu_flat[:, None, None, None] * T[..., None, :, :, :],
               (3, 0, 3, 0))                                 # (..., C, 3, 6, 6)
    w2 = F.pad((-dlw * dlw)[..., None, None, None],
               (FDEV, 6 - FDEV - 1, FDEV, 6 - FDEV - 1))     # (..., C, 1, 6, 6)
    chain2 = torch.cat([torch.zeros(lead + (C, 2, 6, 6), **kw), s2, w2],
                       dim=-3)
    return means, covs, weights, chain, chain2


def component_fields(x1, x2, means, covs, weights):
    """Per component and pixel: the precision entries (..., C), l = Lam
    (x - mu) as (l1, l2) (..., C, N) and the densities g (..., C, N), on
    flat pixel coordinates x1, x2 (..., N)."""
    c00, c01, c11 = covs[..., 0, 0], covs[..., 0, 1], covs[..., 1, 1]
    det = c00 * c11 - c01 * c01
    inv_det = 1.0 / det
    L00, L01, L11 = c11 * inv_det, -c01 * inv_det, c00 * inv_det
    z = weights / (TWO_PI * torch.sqrt(det))
    d1 = x1[..., None, :] - means[..., 0, None]
    d2 = x2[..., None, :] - means[..., 1, None]
    l1 = L00[..., None] * d1 + L01[..., None] * d2
    l2 = L01[..., None] * d1 + L11[..., None] * d2
    g = z[..., None] * torch.exp(-0.5 * (d1 * l1 + d2 * l2))
    return L00, L01, L11, l1, l2, g


def mixture_values(x1, x2, means, covs, weights, *_unused):
    """Value-only mixture render on flat pixel coordinates: (..., N)."""
    return torch.sum(component_fields(x1, x2, means, covs, weights)[-1],
                     dim=-2)


def mixture_value_jac_hess(x1, x2, means, covs, weights, chain, chain2, wh):
    """Value, shape jacobian and weight-contracted shape Hessian of a
    Gaussian-mixture render on flat pixel coordinates x1, x2 (..., N).

    means (..., C, 2), covs (..., C, 2, 2), weights (..., C) (the
    1/(2 pi sqrt det) normalizer applied here); chain (..., C, 6, 6) and
    chain2 (..., C, 6, 6, 6) as star_mixture / galaxy_mixture give them;
    wh (..., N) the Hessian's weight field. Returns (fs (..., N),
    J (..., 6, N), Hc (..., 6, 6)): fs = sum_c g_c, J = d fs / d theta,
    Hc = sum_px wh d2 fs / d theta2."""
    L00, L01, L11, l1, l2, g = component_fields(x1, x2, means, covs,
                                                 weights)
    fs = torch.sum(g, dim=-2)
    P = torch.einsum("...cat,...cab->...ctb", chain,
                     eta_basis_rows(L00, L01, L11))          # (..., C, 6, 6)
    p20, p11, p02 = l1 * l1, l1 * l2, l2 * l2
    basis = (None, l1, l2, p20, p11, p02)
    # J = sum_c sum_b P[c, :, b] g_c b_b, one basis function at a time so
    # no (..., C, 6, N) operand is made
    J = sum(torch.einsum("...ct,...cn->...tn", P[..., b],
                         g if b == 0 else g * basis[b]) for b in range(6))
    wg = wh[..., None, :] * g
    m15 = torch.stack([torch.sum(wg * t, dim=-1) for t in (
        torch.ones_like(l1), l1, l2, p20, p11, p02, p20 * l1, p20 * l2,
        l1 * p02, p02 * l2, p20 * p20, p20 * p11, p20 * p02, p11 * p02,
        p02 * p02)], dim=-1)                                 # (..., C, 15)
    H = hess_from_moments(moment_matrix(m15), L00, L01, L11, P, chain,
                          chain2)
    return fs, J, H


def mixture_grad_contract(x1, x2, means, covs, weights, chain, _chain2, w):
    """Weight-contracted shape gradient of a mixture render,
    sum_px w d fs / d theta (..., 6): the degree-<=2 moments of
    mixture_value_jac_hess (6 weighted pixel sums a component instead of
    the Hessian's 15), the analytic (f, g) evaluator's engine."""
    return grad_from_fields(component_fields(x1, x2, means, covs, weights),
                            chain, w)


def grad_from_fields(fields, chain, w):
    """mixture_grad_contract on a mixture's component_fields, computed
    once for its values and its gradient."""
    L00, L01, L11, l1, l2, g = fields
    wg = w[..., None, :] * g
    a, b = wg * l1, wg * l2
    m = torch.stack([torch.sum(wg, dim=-1), torch.sum(a, dim=-1),
                     torch.sum(b, dim=-1), torch.sum(a * l1, dim=-1),
                     torch.sum(a * l2, dim=-1), torch.sum(b * l2, dim=-1)],
                    dim=-1)                                  # (..., C, 6)
    P = torch.einsum("...cat,...cab->...ctb", chain,
                     eta_basis_rows(L00, L01, L11))
    return torch.einsum("...ctb,...cb->...t", P, m)


def band_shape_derivs(theta6, psf_b, wcs_jacobian, world_center,
                      pixel_center, x1, x2, w0, w1):
    """One band's star and galaxy values, jacobians and weight-contracted
    shape Hessians on flat pixel coordinates x1, x2 (..., N), with the
    Hessian weight fields w0, w1 (..., N). Returns (fs0, fs1 (..., N),
    J0, J1 (..., 6, N), Hc0, Hc1 (..., 6, 6))."""
    sm = star_mixture(theta6, psf_b, wcs_jacobian, world_center, pixel_center)
    gm = galaxy_mixture(theta6, psf_b, wcs_jacobian, world_center,
                        pixel_center)
    fs0, J0, Hc0 = mixture_value_jac_hess(x1, x2, *sm, w0)
    fs1, J1, Hc1 = mixture_value_jac_hess(x1, x2, *gm, w1)
    return fs0, fs1, J0, J1, Hc0, Hc1
