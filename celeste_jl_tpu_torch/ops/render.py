"""Fused Gaussian-mixture render + masked Poisson log-likelihood (port of
celeste_jl_tpu/ops/pallas_render.py), the MCMC likelihood's hot loop.

A row is one (lane, band): its unit-flux mixture, packed as (C, 6) rows
[mu1, mu2, p11, p12, p22, logw] with p = inv(cov) and logw = log(weight) -
log(2 pi) + 0.5 log|p| (`pack_mixture`), is rendered on a P x P tile,
scaled by the row's flux, added to the background and scored against the
pixels:
    rate = iota (bg + flux sum_c exp(logw_c - q_c / 2))   (1 where masked)
    ll   = sum_pixels mask (x log(rate) - rate)
with q_c the precision quadratic form at the 1-based pixel coordinates
(tile row/column index + meta offset). The lgamma(x + 1) terms are left
out, as in the JAX function. There is no clamp on the rate.

`mixture_poisson_ll` launches the CUDA kernel csrc/render.cu on CUDA
tensors and runs `mixture_poisson_ll_plain`, its plain torch twin (the
JAX package's `_xla_reference`), on CPU tensors. Both take an optional
row -> tile index, so the rows of the AIS samples of one source share
that source's tiles instead of copies of them. Unlike the TPU kernel,
any C and any tile size run (the TPU's C <= 8 and (P*P) % 128 gates are
not carried over).
"""

import math

import torch

from . import _build

LN2PI = math.log(2.0 * math.pi)


def pack_mixture(means, covs, weights):
    """(..., C, 2) means, (..., C, 2, 2) covs, (..., C) weights -> (..., C, 6)
    packed rows."""
    a = covs[..., 0, 0]
    b = covs[..., 0, 1]
    d = covs[..., 1, 1]
    det = a * d - b * b
    p11 = d / det
    p12 = -b / det
    p22 = a / det
    logw = torch.log(weights) - LN2PI - 0.5 * torch.log(det)
    return torch.stack([means[..., 0], means[..., 1], p11, p12, p22, logw],
                       dim=-1)


def _tiles(tiles, tile_index):
    return tiles if tile_index is None else tiles[tile_index]


def mixture_poisson_ll_plain(pixels, mask, iota, bg, comps, meta,
                             tile_index=None):
    """Per-row masked Poisson log-likelihood of a mixture render, (R,).

    pixels/mask/iota/bg: (T, P, P) tiles, mask as 0/1 floats; comps
    (R, C, 6); meta (R, 4) = [row offset, col offset, flux, unused];
    tile_index: optional (R,) integer row -> tile map (default: T == R,
    row r uses tile r). Pixels must be 0 where the mask is.

    A masked pixel adds mask (x log 1 - 1) = -0 whatever its density, so
    the render runs only on the rows and columns of the tiles that hold an
    active pixel: the same sums, on a fraction of the grid."""
    act = mask > 0
    rows = torch.nonzero(act.any(dim=(0, 2)))[:, 0]
    cols = torch.nonzero(act.any(dim=(0, 1)))[:, 0]
    if not len(rows):
        return torch.zeros(comps.shape[0], dtype=comps.dtype,
                           device=comps.device)
    r0, r1, c0, c1 = int(rows[0]), int(rows[-1]) + 1, int(cols[0]), \
        int(cols[-1]) + 1
    pixels, mask, iota, bg = (_tiles(t[:, r0:r1, c0:c1], tile_index)
                              for t in (pixels, mask, iota, bg))
    kw = dict(dtype=comps.dtype, device=comps.device)
    i_r = torch.arange(r0, r1, **kw)
    i_c = torch.arange(c0, c1, **kw)
    row = meta[:, None, None, 0] + i_r[None, :, None]        # (R, P, 1)
    col = meta[:, None, None, 1] + i_c[None, None, :]        # (R, 1, P)
    e = lambda k: comps[:, :, k, None, None]                 # (R, C, 1, 1)
    dx1 = row[:, None] - e(0)                                # (R, C, P, 1)
    dx2 = col[:, None] - e(1)                                # (R, C, 1, P)
    # logw - q / 2 as a row term + a cross term + a column term, so that
    # only three passes run over the (R, C, P, P) grid before the exp
    arg = torch.addcmul(e(5) - 0.5 * e(2) * dx1 * dx1, -e(3) * dx1, dx2)
    dens = torch.sum(torch.exp(arg - 0.5 * e(4) * dx2 * dx2), dim=1)
    rate = iota * (bg + meta[:, 2, None, None] * dens)
    rate = torch.where(mask > 0, rate, 1.0)
    ll = mask * (pixels * torch.log(rate) - rate)
    return torch.sum(ll, dim=(1, 2))


def mixture_poisson_ll(pixels, mask, iota, bg, comps, meta, tile_index=None):
    """Same contract as `mixture_poisson_ll_plain`: csrc/render.cu on CUDA
    tensors (f32 or f64, any C and P), the plain twin on CPU tensors.
    Anything else raises; a row whose tile index is outside [0, T) comes
    back NaN (checked on the card, where the index lives)."""
    if comps.device.type == "cpu":
        return mixture_poisson_ll_plain(pixels, mask, iota, bg, comps, meta,
                                        tile_index)
    dtype = comps.dtype
    _build.check_cuda(dtype, comps.device)
    R, C, six = comps.shape
    T, P = pixels.shape[0], pixels.shape[-1]
    if (six != 6 or meta.shape != (R, 4)
            or any(t.shape != (T, P, P) for t in (pixels, mask, iota, bg))
            or (tile_index is None and T != R)
            or (tile_index is not None and tile_index.shape != (R,))):
        raise ValueError(
            f"mixture_poisson_ll: comps {tuple(comps.shape)}, meta "
            f"{tuple(meta.shape)}, tiles {tuple(pixels.shape)}, tile_index "
            f"{None if tile_index is None else tuple(tile_index.shape)}")
    if tile_index is None:
        tile_index = torch.arange(R, dtype=torch.int32, device=comps.device)
    tiles = [t.to(dtype).contiguous() for t in (pixels, mask, iota, bg)]
    out = torch.empty(R, dtype=dtype, device=comps.device)
    if R:
        _build.launch("mixture_poisson_ll", dtype, comps.contiguous(),
                      meta.to(dtype).contiguous(), *tiles,
                      tile_index.to(torch.int32).contiguous(), out, R, C, P,
                      T)
        mixture_poisson_ll.launches += 1
    return out


mixture_poisson_ll.launches = 0
