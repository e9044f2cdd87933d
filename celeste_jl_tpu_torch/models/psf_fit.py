"""Fit a K-component Gaussian mixture to rasterized PSF stamps (port of
celeste_jl_tpu/models/psf_fit.py; PSF.jl :32-130, :385-469, :635-674).

Weighted least squares of the mixture density against each stamp,
minimized by the batched Newton trust-region of the ELBO fits
(ops/newton.minimize_newton_tr, tr_solver "eig"): each stamp is a lane,
(f, g) per lane by torch.func.grad and H by torch.func.hessian, vmapped
over lanes (the JAX package takes jax.value_and_grad and jax.hessian per
stamp and vmaps the whole fit). On a CUDA device each trust-region step
runs the K3 kernel (ops/tr.tr_subproblem) at D = K * 6; plain=True runs
its plain twin instead (the comparison route).

Per-component parameters (6): mu (2, offset from the stamp center), axis
ratio, angle, scale (major-axis sigma), weight, each boxed by a sigmoid.
"""

import numpy as np
import torch
from torch.func import grad_and_value, hessian, vmap

from ..ops.newton import NewtonConfig, minimize_newton_tr
from ..utils.device import resolve
from .bvn import get_bvn_cov

PSF_NPARAM = 6  # mu1, mu2, axis_ratio, angle, scale, weight

# box bounds per parameter (the intent of PSF.jl:250-344's bounds)
_LB = np.array([-5.0, -5.0, 0.10, -4.0 * np.pi, 0.25, 0.05])
_UB = np.array([5.0, 5.0, 1.0, 4.0 * np.pi, 10.0, 2.0])


def _to_bound(free):
    lb = torch.as_tensor(_LB, dtype=free.dtype, device=free.device)
    ub = torch.as_tensor(_UB, dtype=free.dtype, device=free.device)
    return lb + (ub - lb) / (1.0 + torch.exp(-free))


def _to_free(bound):
    frac = (np.asarray(bound) - _LB) / (_UB - _LB)
    return -np.log(1.0 / frac - 1.0)


def psf_mixture_density(params, x1, x2, center):
    """Mixture density on the stamp grid. params (K, 6); x1, x2 (H, W)
    1-based pixel coordinates; center (2,) stamp center."""
    mu = params[:, 0:2] + center[None, :]
    covs = get_bvn_cov(params[:, 2], params[:, 3], params[:, 4])  # (K,2,2)
    det = covs[:, 0, 0] * covs[:, 1, 1] - covs[:, 0, 1] ** 2
    p11 = covs[:, 1, 1] / det
    p22 = covs[:, 0, 0] / det
    p12 = -covs[:, 0, 1] / det
    z = params[:, 5] / (2.0 * np.pi * torch.sqrt(det))
    dx1 = x1[None] - mu[:, 0, None, None]
    dx2 = x2[None] - mu[:, 1, None, None]
    quad = (p11[:, None, None] * dx1 * dx1
            + 2.0 * p12[:, None, None] * dx1 * dx2
            + p22[:, None, None] * dx2 * dx2)
    return torch.sum(z[:, None, None] * torch.exp(-0.5 * quad), dim=0)


def _squared_error(free, stamp, x1, x2, center, K):
    params = _to_bound(free.reshape(K, PSF_NPARAM))
    model = psf_mixture_density(params, x1, x2, center)
    return torch.sum((model - stamp) ** 2)


def initialize_psf_params(K, dtype=np.float64):
    """Concentric isotropic start (initialize_psf_params semantics)."""
    params = np.zeros((K, PSF_NPARAM), dtype=dtype)
    params[:, 2] = 0.8                       # axis ratio
    params[:, 4] = np.sqrt(2.0 * (1.0 + np.arange(K)))   # scale
    params[:, 5] = 1.0 / K                   # weight
    return params


def _fit(stamps, K, config, plain):
    """Fit every stamp of stamps (N, H, W) as one batched launch: (packed
    (N, K, 6), final squared error (N,)), tensors on the stamps' device."""
    N, H, W = stamps.shape
    kw = dict(dtype=stamps.dtype, device=stamps.device)
    x1, x2 = torch.meshgrid(torch.arange(1, H + 1, **kw),
                            torch.arange(1, W + 1, **kw), indexing="ij")
    center = torch.tensor([(H + 1) / 2.0, (W + 1) / 2.0], **kw)
    free0 = torch.as_tensor(_to_free(initialize_psf_params(K)).reshape(-1),
                            **kw).expand(N, K * PSF_NPARAM).contiguous()

    err = lambda free, stamp: _squared_error(free, stamp, x1, x2, center, K)
    lane_gv = vmap(grad_and_value(err))
    lane_h = vmap(hessian(err))

    def fg(free):
        g, f = lane_gv(free, stamps)
        return f, g

    def fgh(free):
        f, g = fg(free)
        return f, g, lane_h(free, stamps)

    # the trust-region step goes through K3's wrapper (its plain twin on
    # CPU tensors, or with plain=True)
    cfg = config._replace(tr_kernel="pallas")
    with torch.no_grad():
        st = minimize_newton_tr(fgh, free0, cfg, fg=fg, plain=plain)
    params = _to_bound(st.x.reshape(N, K, PSF_NPARAM))
    covs = get_bvn_cov(params[..., 2], params[..., 3], params[..., 4])
    packed = torch.cat(
        [params[..., 5:6], params[..., 0:2], covs[..., 0, 0, None],
         covs[..., 0, 1, None], covs[..., 1, 1, None]], dim=-1)
    return packed, st.f


def fit_psfs_batched(stamps, K=2, config=NewtonConfig(max_iters=50), *,
                     device="cuda", plain=False):
    """Fit (N, H, W) stamps, one lane each, in one batched launch on
    `device` -> ((N, K, 6) packed mixtures, (N,) squared errors), float64
    numpy. The packed rows are models/psf.py's [alpha, mu1, mu2, s11, s12,
    s22], mu relative to the stamp center."""
    dev = resolve(device)
    stamps = torch.as_tensor(np.asarray(stamps, dtype=np.float64),
                             device=dev)
    packed, errs = _fit(stamps, K, config, plain)
    return packed.cpu().numpy(), errs.cpu().numpy()


def fit_raw_psf(raw_psf, K=2, config=NewtonConfig(max_iters=50), *,
                device="cuda", plain=False):
    """Fit one stamp. Returns ((K, 6) packed PSF mixture, final squared
    error); a one-lane fit_psfs_batched."""
    packed, errs = fit_psfs_batched(np.asarray(raw_psf)[None], K, config,
                                    device=device, plain=plain)
    return packed[0], float(errs[0])


def trim_width(raw_psf, trim_percent=0.999):
    """Half-width of the central square window holding trim_percent of |PSF|
    (PSF.jl:677-693)."""
    raw_psf = np.asarray(raw_psf)
    h_mid = (raw_psf.shape[0] + 1) // 2 - 1
    w_mid = (raw_psf.shape[1] + 1) // 2 - 1
    total = np.abs(raw_psf).sum()
    width = 1
    while True:
        win = raw_psf[h_mid - width:h_mid + width + 1,
                      w_mid - width:w_mid + width + 1]
        if np.abs(win).sum() >= trim_percent * total or \
                win.shape[0] >= min(raw_psf.shape):
            return width
        width += 1


def trim_psf(raw_psf, trim_percent=0.999):
    """Central square window holding trim_percent of |PSF| (PSF.jl:677-693)."""
    raw_psf = np.asarray(raw_psf)
    h_mid = (raw_psf.shape[0] + 1) // 2 - 1
    w_mid = (raw_psf.shape[1] + 1) // 2 - 1
    width = trim_width(raw_psf, trim_percent)
    return raw_psf[h_mid - width:h_mid + width + 1,
                   w_mid - width:w_mid + width + 1].copy()


def _pad_components(packed, K_out):
    """Pad a (K, 6) packed mixture to (K_out, 6) with zero-weight identity
    components (alpha = 0 contributes nothing to the rendered mixture)."""
    packed = np.asarray(packed, dtype=np.float64)
    K = packed.shape[0]
    if K >= K_out:
        return packed[:K_out]
    pad = np.zeros((K_out - K, 6))
    pad[:, 3] = 1.0   # s11
    pad[:, 5] = 1.0   # s22
    return np.concatenate([packed, pad], axis=0)


def fit_patch_psfs(images, positions, K=2,
                   config=NewtonConfig(max_iters=50), trim_percent=0.999, *,
                   device="cuda", plain=False):
    """Per-source, per-band local PSFs from each image's spatially-varying
    psfmap: (S, B, K_out, 6) packed mixtures, float64 numpy.

    The reference evaluates the psField eigenimage-polynomial map at every
    patch's pixel center and fits a K=2 mixture per patch
    (model/imaged_sources.jl:97-107, SDSSIO.jl:239-298). Here the S stamps
    of a band come from one einsum (SDSSPSFMap.at), are trimmed to one
    common window (the largest per-stamp trim width, so every stamp keeps
    >= trim_percent of its light) and are fitted as S lanes of one launch
    on `device`.

    A band whose Image carries no meta['psfmap'] takes the image's global
    (field-center) PSF for every source. Mixed component counts are padded
    with zero-weight components.
    """
    resolve(device)
    positions = np.asarray(positions, dtype=np.float64)
    S, B = len(positions), len(images)
    per_band = []   # (S, K_b, 6) each
    for img in images:
        psfmap = img.meta.get("psfmap") if img.meta else None
        if psfmap is None:
            per_band.append(np.broadcast_to(
                np.asarray(img.psf, dtype=np.float64),
                (S,) + np.shape(img.psf)).copy())
            continue
        centers = np.stack([np.asarray(img.world_to_pix(p), np.float64)
                            for p in positions])   # (S, 2) 1-based
        # (x = axis1, y = axis2), as the field-center fit of
        # io/sdss.load_field_images
        stamps = psfmap.at(centers[:, 0], centers[:, 1])
        width = max(trim_width(st, trim_percent) for st in stamps)
        h_mid = (stamps.shape[1] + 1) // 2 - 1
        w_mid = (stamps.shape[2] + 1) // 2 - 1
        win = stamps[:, h_mid - width:h_mid + width + 1,
                     w_mid - width:w_mid + width + 1]
        packed, _ = fit_psfs_batched(win, K=K, config=config, device=device,
                                     plain=plain)
        per_band.append(packed)
    K_out = max(pb.shape[1] for pb in per_band)
    out = np.zeros((S, B, K_out, 6))
    for b, pb in enumerate(per_band):
        for s in range(S):
            out[s, b] = _pad_components(pb[s], K_out)
    return out
