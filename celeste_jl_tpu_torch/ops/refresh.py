"""The analytic-Hessian refresh pixel pass (port of
celeste_jl_tpu/ops/pallas_refresh.py).

Per (source, band) row: render the C = 15 K mixture components on the tile
(K star components first), form the Poisson-bound weight fields, and emit
only pixel-contracted outputs: per-component W-weighted degree-<=4 moments
m15 (C, 15) and NRED = 72 reductions. The tiny per-component assembly
(moments -> Hessian, models/mixture_derivs.hess_from_moments) stays in
torch.

`pixel_terms` launches the CUDA kernel csrc/refresh.cu on CUDA tensors and
runs `pixel_terms_plain`, its plain torch twin, on CPU tensors.
"""

import numpy as np
import torch

from ..models import mixture_derivs as md
from . import _build

# Flat order of the 72 per-row reductions:
#   [0]      lik_core (masked Poisson bound without the x log(iota) and
#            lgamma(x + 1) constants, which the caller adds back)
#   [1:37]   Hcross (6, 6) row-major: sum_px [J0 J1] F [J0 J1]'
#   [37:61]  H_tC (6, 4) row-major
#   [61:68]  H_CC entries [h11 fs0^2, h11 fs0 fs1, h11 fs1^2,
#            h12 fs0 fs0^2, h12 fs0 fs1^2, h12 fs1 fs0^2, h12 fs1 fs1^2]
#   [68:72]  g_C [g1 fs0, g1 fs1, g2 fs0^2, g2 fs1^2]
NRED = 72


def _poisson_weight_fields(cl4, msk, x, iot, a0, b0, fs0, fs1):
    """Per-pixel Poisson-bound value and derivative weight fields
    (elbo_objective.jl:274-392). cl4 entries broadcast against the
    pixel fields."""
    cl0, cl1, cll0, cll1 = cl4
    s1 = cl0 * fs0 + cl1 * fs1
    s2 = cll0 * fs0 * fs0 + cll1 * fs1 * fs1
    E = torch.where(msk > 0, a0 + s1, 1.0)
    V = torch.where(msk > 0, b0 + s2 - s1 * s1, 0.0)

    rE = 1.0 / E
    rE2 = rE * rE
    rE3 = rE2 * rE
    phi_E = x * rE + x * V * rE3 - iot
    phi_V = -0.5 * x * rE2
    phi_EE = -x * rE2 - 3.0 * x * V * rE2 * rE2
    phi_EV = x * rE3

    g1 = msk * (phi_E - 2.0 * s1 * phi_V)
    g2 = msk * phi_V
    h11 = msk * (phi_EE - 4.0 * s1 * phi_EV) - 2.0 * g2
    h12 = msk * phi_EV

    u0 = 2.0 * cll0 * fs0
    u1 = 2.0 * cll1 * fs1
    W0 = g1 * cl0 + g2 * u0
    W1 = g1 * cl1 + g2 * u1
    lik_core = msk * (x * (torch.log(E) - 0.5 * V * rE2) - iot * E)
    return lik_core, g1, g2, h11, h12, u0, u1, W0, W1


def _cross_fields(cl4, g1, g2, h11, h12, u0, u1, fs0, fs1):
    """The F (Hcross) and A (H_tC) weight fields."""
    cl0, cl1, cll0, cll1 = cl4
    f00 = h11 * cl0 * cl0 + 2.0 * h12 * cl0 * u0 + 2.0 * g2 * cll0
    f01 = h11 * cl0 * cl1 + h12 * (cl0 * u1 + u0 * cl1)
    f11 = h11 * cl1 * cl1 + 2.0 * h12 * cl1 * u1 + 2.0 * g2 * cll1
    t0, t1 = h11 * fs0, h11 * fs1
    r0, r1 = h12 * fs0, h12 * fs1
    q0, q1 = r0 * fs0, r1 * fs1
    A0 = (t0 * cl0 + r0 * u0 + g1, t1 * cl0 + r1 * u0,
          q0 * cl0 + 2.0 * g2 * fs0, q1 * cl0)
    A1 = (t0 * cl1 + r0 * u1, t1 * cl1 + r1 * u1 + g1,
          q0 * cl1, q1 * cl1 + 2.0 * g2 * fs1)
    return f00, f01, f11, A0, A1


def _moment_polys(l1, l2):
    """The 15 degree-<=4 monomials in flat moment order."""
    one = torch.ones_like(l1)
    p20, p11, p02 = l1 * l1, l1 * l2, l2 * l2
    return [one, l1, l2, p20, p11, p02,
            p20 * l1, p20 * l2, l1 * p02, p02 * l2,
            p20 * p20, p20 * p11, p20 * p02, p11 * p02, p02 * p02]


def _pixel_terms_rows(mu, lv, z, pch, cl4, off, pixels, mask, iota, a0, b0,
                      ks, pdims):
    dtype = pixels.dtype
    dev = pixels.device
    rows, cols = pdims
    n = torch.arange(rows * cols, device=dev)
    x1 = off[:, 0:1].to(dtype) + (1 + n // cols).to(dtype)     # (g, N)
    x2 = off[:, 1:2].to(dtype) + (1 + n % cols).to(dtype)
    msk = mask.to(dtype)
    x = torch.where(msk > 0, pixels, 0.0)
    iot = torch.where(msk > 0, iota, 1.0)

    L00, L01, L11 = (lv[..., k, None] for k in range(3))      # (g, C, 1)
    d1 = x1[:, None, :] - mu[..., 0, None]                    # (g, C, N)
    d2 = x2[:, None, :] - mu[..., 1, None]
    l1 = L00 * d1 + L01 * d2
    l2 = L01 * d1 + L11 * d2
    g = z[..., None] * torch.exp(-0.5 * (d1 * l1 + d2 * l2))
    fs0 = torch.sum(g[:, :ks], dim=1)                         # (g, N)
    fs1 = torch.sum(g[:, ks:], dim=1)

    cl = tuple(cl4[:, k, None] for k in range(4))
    lik_px, g1, g2, h11, h12, u0, u1, W0, W1 = _poisson_weight_fields(
        cl, msk, x, iot, a0, b0, fs0, fs1)
    lik_core = torch.sum(lik_px, dim=-1)

    polys = _moment_polys(l1, l2)
    gb = torch.stack([g * p for p in polys[:6]], dim=2)       # (g, C, 6, N)
    J0 = torch.einsum("gctb,gcbn->gtn", pch[:, :ks], gb[:, :ks])
    J1 = torch.einsum("gctb,gcbn->gtn", pch[:, ks:], gb[:, ks:])
    del gb

    C = g.shape[1]
    W = torch.cat([W0[:, None].expand(-1, ks, -1),
                   W1[:, None].expand(-1, C - ks, -1)], dim=1)
    wg = W * g
    m15 = torch.stack([torch.sum(wg * p, dim=-1) for p in polys], dim=-1)

    f00, f01, f11, A0, A1 = _cross_fields(cl, g1, g2, h11, h12, u0, u1,
                                          fs0, fs1)
    U0 = f00[:, None] * J0 + f01[:, None] * J1
    U1 = f01[:, None] * J0 + f11[:, None] * J1
    hcross = (torch.einsum("gin,gjn->gij", J0, U0)
              + torch.einsum("gin,gjn->gij", J1, U1))
    htc = torch.stack([torch.einsum("gtn,gn->gt", J0, a0_)
                       + torch.einsum("gtn,gn->gt", J1, a1_)
                       for a0_, a1_ in zip(A0, A1)], dim=-1)   # (g, 6, 4)
    s = lambda t: torch.sum(t, dim=-1)
    hcc = torch.stack([s(h11 * fs0 * fs0), s(h11 * fs0 * fs1),
                       s(h11 * fs1 * fs1), s(h12 * fs0 * fs0 ** 2),
                       s(h12 * fs0 * fs1 ** 2), s(h12 * fs1 * fs0 ** 2),
                       s(h12 * fs1 * fs1 ** 2)], dim=-1)
    gc = torch.stack([s(g1 * fs0), s(g1 * fs1), s(g2 * fs0 ** 2),
                      s(g2 * fs1 ** 2)], dim=-1)
    return lik_core, m15, hcross, htc, hcc, gc


def pixel_terms_plain(mu, lv, z, pch, cl4, off, pixels, mask, iota, a0, b0,
                      *, ks, pdims):
    """Plain torch twin of the refresh kernel (the batched counterpart of
    JAX `_pixel_terms_row`).

    Rows G: mu (G, C, 2), lv (G, C, 3) = [L00, L01, L11], z (G, C),
    pch (G, C, 6, 6), cl4 (G, 4) = [cl0, cl1, cll0, cll1], off (G, 2),
    pixel fields (G, N) with N = rows * cols. ks: star components (packed
    first); pdims: (rows, cols).

    Returns (lik_core (G,), m15 (G, C, 15), hcross (G, 6, 6),
    htc (G, 6, 4), hcc (G, 7), gc (G, 4)). Rows go in chunks so the
    (rows, C, 6, N) intermediates stay near 2^25 elements.
    """
    G, C = z.shape
    N = pixels.shape[-1]
    chunk = max(1, (1 << 25) // (C * N))
    args = (mu, lv, z, pch, cl4, off, pixels, mask, iota, a0, b0)
    outs = [_pixel_terms_rows(*(a[i:i + chunk] for a in args), ks, pdims)
            for i in range(0, G, chunk)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def pixel_terms(mu, lv, z, pch, cl4, off, pixels, mask, iota, a0, b0,
                *, ks, pdims):
    """The refresh pixel pass, same contract as `pixel_terms_plain`:
    csrc/refresh.cu on CUDA tensors (f32 or f64, any tile up to 32767
    pixels a side), the plain twin on CPU tensors. Anything else raises.

    The kernel visits only the pixels with mask > 0 and skips the
    structural zeros of the chain coefficients pch that
    `band_pixel_rows` builds (models/mixture_derivs): star components
    (the first ks) feed theta rows 0, 1 through b = 1, 2 only; galaxy
    components rows 0, 1 through b = 1, 2, row 2 through b = 0, rows 3..5
    through b = 0, 3, 4, 5. So pch must be `band_pixel_rows`' (every
    other entry 0, as tests/test_torch_refresh.py asserts of it): the
    wrapper does not check the other entries, which would cost a
    device-to-host read a call, and the kernel does not read them, so a
    pch that is not 0 there gives other results than the twin's.

    Tests: the twin against the JAX package on the CPU in
    tests/test_torch_refresh.py (with the chain coefficients' zero
    pattern); the kernel against the twin on a CUDA card in
    tests/test_torch_kernels.py (`python -m pytest --noconftest -p
    no:cacheprovider tests/test_torch_kernels.py -m cuda`)."""
    dev = mu.device
    if dev.type == "cpu":
        return pixel_terms_plain(mu, lv, z, pch, cl4, off, pixels, mask,
                                 iota, a0, b0, ks=ks, pdims=pdims)
    G, C = z.shape
    N = pixels.shape[-1]
    dtype = pixels.dtype
    rows, cols = pdims
    _build.check_cuda(dtype, dev)
    if rows * cols != N or not 0 <= ks <= C:
        raise ValueError(f"pixel_terms: N={N}, pdims={pdims}, ks={ks}, C={C}")
    for name, t, shape in (("mu", mu, (G, C, 2)), ("lv", lv, (G, C, 3)),
                           ("pch", pch, (G, C, 6, 6)), ("cl4", cl4, (G, 4)),
                           ("off", off, (G, 2)), ("pixels", pixels, (G, N)),
                           ("mask", mask, (G, N)), ("iota", iota, (G, N)),
                           ("a0", a0, (G, N)), ("b0", b0, (G, N))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"pixel_terms: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    # every operand as it is (a copy only if not contiguous or of another
    # type): the kernel reads its rows where they lie
    ops = [t.to(dtype).contiguous() for t in (mu, lv, z, pch, cl4, off, pixels,
                                              mask, iota, a0, b0)]
    m15 = torch.empty((G, C, 15), dtype=dtype, device=dev)
    red = torch.empty((G, NRED), dtype=dtype, device=dev)
    if G:
        _build.launch("refresh", dtype, *ops, m15, red, G, C, ks, N, cols)
        pixel_terms.launches += 1
    return (red[:, 0], m15, red[:, 1:37].reshape(G, 6, 6),
            red[:, 37:61].reshape(G, 6, 4), red[:, 61:68], red[:, 68:72])


pixel_terms.launches = 0


def band_pixel_rows(theta6, clb, cllb, psf_b, jac_b, wc_b, pc_b, off_b,
                    pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b):
    """The refresh pass's inputs: the star and galaxy mixtures of every
    (source, band), flattened to G rows.

    Returns (rows, mix): rows = (mu, lv, z, pch, cl4, off, pixels, mask,
    iota, a0, b0) as `pixel_terms` takes them; mix = (ks, L00, L01, L11,
    pch, chain, chain2) with the leading axes kept, for the assembly.
    """
    dtype = pixels_b.dtype
    lead = pixels_b.shape[:-2]
    sm = md.star_mixture(theta6, psf_b, jac_b, wc_b, pc_b)
    gm = md.galaxy_mixture(theta6, psf_b, jac_b, wc_b, pc_b)
    ks = sm[0].shape[-2]

    means, covs, weights, chain, chain2 = (
        torch.cat([a, b], dim=len(lead)) for a, b in zip(sm, gm))
    C = means.shape[-2]

    c00, c01, c11 = covs[..., 0, 0], covs[..., 0, 1], covs[..., 1, 1]
    det = c00 * c11 - c01 * c01
    inv_det = 1.0 / det
    L00, L01, L11 = c11 * inv_det, -c01 * inv_det, c00 * inv_det
    z = weights / (md.TWO_PI * torch.sqrt(det))
    lv = torch.stack([L00, L01, L11], dim=-1)
    pch = torch.einsum("...cat,...cab->...ctb", chain,
                       md.eta_basis_rows(L00, L01, L11))     # (..., C, 6, 6)

    cl4 = torch.cat([clb, cllb], dim=-1)                      # (..., 4)
    Gs = int(np.prod(lead))
    flat = lambda t: t.reshape(Gs, -1)
    rows = (means.reshape(Gs, C, 2), lv.reshape(Gs, C, 3), z.reshape(Gs, C),
            pch.reshape(Gs, C, 6, 6), cl4.reshape(Gs, 4),
            off_b.reshape(Gs, 2), flat(pixels_b), flat(mask_b).to(dtype),
            flat(iota_b), flat(sky_b) + flat(bg_E_b), flat(bg_var_b))
    return rows, (ks, L00, L01, L11, pch, chain, chain2)


def band_lik_terms_fused(theta6, clb, cllb, psf_b, jac_b, wc_b, pc_b, off_b,
                         pixels_b, mask_b, sky_b, iota_b, bg_E_b, bg_var_b,
                         P, terms=pixel_terms):
    """Each band's analytic likelihood derivative blocks in
    (theta6, Cb) space, Cb = (cl0, cl1, cll0, cll1), through the refresh
    pixel pass `terms` (pixel_terms or pixel_terms_plain).

    Every argument carries the same leading (source, band) axes as
    `pixels_b` (..., P, P); theta6 (..., 6), clb and cllb (..., 2).
    Returns (lik (...), g_theta (..., 6), g_C (..., 4), H_tt (..., 6, 6),
    H_tC (..., 6, 4), H_CC (..., 4, 4)).
    """
    dtype = pixels_b.dtype
    lead = pixels_b.shape[:-2]
    rows, (ks, L00, L01, L11, pch, chain, chain2) = band_pixel_rows(
        theta6, clb, cllb, psf_b, jac_b, wc_b, pc_b, off_b, pixels_b, mask_b,
        sky_b, iota_b, bg_E_b, bg_var_b)
    lik_core, m15, hcross, htc, hcc, gc = terms(*rows, ks=ks,
                                                pdims=tuple(P))
    pix, msk, iot = rows[6], rows[7], rows[8]

    # the parameter-independent part of the bound, left out of the kernel
    xm = torch.where(msk > 0, pix, 0.0)
    iot_m = torch.where(msk > 0, iot, 1.0)
    const = torch.sum(msk * (xm * torch.log(iot_m) - torch.lgamma(xm + 1.0)),
                      dim=-1)
    unflat = lambda t: t.reshape(lead + t.shape[1:])
    lik = unflat(lik_core + const)
    m15, hcross, htc, hcc, gc = map(unflat, (m15, hcross, htc, hcc, gc))

    M = md.moment_matrix(m15)                                 # (..., C, 6, 6)
    Hc0 = md.hess_from_moments(M[..., :ks, :, :], L00[..., :ks],
                               L01[..., :ks], L11[..., :ks],
                               pch[..., :ks, :, :], chain[..., :ks, :, :],
                               chain2[..., :ks, :, :, :])
    Hc1 = md.hess_from_moments(M[..., ks:, :, :], L00[..., ks:],
                               L01[..., ks:], L11[..., ks:],
                               pch[..., ks:, :, :], chain[..., ks:, :, :],
                               chain2[..., ks:, :, :, :])
    H_tt = Hc0 + Hc1 + hcross
    g_theta = torch.einsum("...ctb,...cb->...t", pch, m15[..., :6])
    hcl = torch.stack([torch.stack([hcc[..., 0], hcc[..., 1]], -1),
                       torch.stack([hcc[..., 1], hcc[..., 2]], -1)], -2)
    hx = torch.stack([torch.stack([hcc[..., 3], hcc[..., 4]], -1),
                      torch.stack([hcc[..., 5], hcc[..., 6]], -1)], -2)
    H_CC = torch.cat([torch.cat([hcl, hx], -1),
                      torch.cat([hx.transpose(-1, -2), torch.zeros_like(hcl)],
                                -1)], -2)
    return lik, g_theta, gc, H_tt, htc, H_CC
