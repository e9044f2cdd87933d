"""Fixed-shape patch tiles (port of celeste_jl_tpu/models/patches.py).

A SkyPatch holds one source's five band tiles, with a leading S axis when
stacked: (S, B, P, P) pixel fields and (S, B, ...) per-band metadata.
`make_patch_for_source` and `make_patches_batched` build them host-side
with numpy leaves, as the JAX package does; `stack_patches` moves a list
of them onto a device.
"""

from typing import NamedTuple

import numpy as np
import torch


class SkyPatch(NamedTuple):
    pixels: torch.Tensor        # (..., B, P, P) electron counts; NaN = masked
    mask: torch.Tensor          # (..., B, P, P) bool active pixels
    sky: torch.Tensor           # (..., B, P, P) sky background, nMgy
    iota: torch.Tensor          # (..., B, P, P) nelec per nMgy
    offset: torch.Tensor        # (..., B, 2) int32 0-based tile corner
    wcs_jacobian: torch.Tensor  # (..., B, 2, 2)
    world_center: torch.Tensor  # (..., B, 2)
    pixel_center: torch.Tensor  # (..., B, 2) 1-based
    psf: torch.Tensor           # (..., B, K, 6)

    def to(self, device, dtype):
        """Move every field to `device`; float fields become `dtype`, the
        mask stays bool and the offsets stay integer."""
        return SkyPatch(*(
            t.to(device=device, dtype=dtype) if t.is_floating_point()
            else t.to(device=device) for t in self))

    def index(self, idx):
        """The lanes `idx` (an index tensor or slice) of a stacked patch."""
        return SkyPatch(*(t[idx] for t in self))


def pixel_coord_grids(offset, P, dtype):
    """1-based pixel coordinates (x1, x2), each (..., rows, cols), of tiles
    whose 0-based corners are `offset` (..., 2). P: int or (rows, cols)."""
    rows, cols = (P, P) if isinstance(P, int) else P
    dev = offset.device
    r1 = torch.arange(1, rows + 1, dtype=dtype, device=dev)
    r2 = torch.arange(1, cols + 1, dtype=dtype, device=dev)
    off = offset.to(dtype)
    x1 = off[..., 0, None, None] + r1[:, None] + torch.zeros(
        (1, cols), dtype=dtype, device=dev)
    x2 = off[..., 1, None, None] + r2[None, :] + torch.zeros(
        (rows, 1), dtype=dtype, device=dev)
    return x1, x2


def make_patch_for_source(images, world_pos, radius, tile_size, psf=None):
    """A SkyPatch of numpy arrays (leading B axis) for one source: the tile
    of each image around `world_pos`, active within +-radius pixels of the
    source center, inside the image and not NaN. psf: optional (B, K, 6)
    local PSF per band; default each image's PSF."""
    world_pos = np.asarray(world_pos, dtype=np.float64)
    B, P = len(images), tile_size
    pix = np.full((B, P, P), np.nan, dtype=np.float64)
    mask = np.zeros((B, P, P), dtype=bool)
    sky = np.zeros((B, P, P), dtype=np.float64)
    iota = np.ones((B, P, P), dtype=np.float64)
    offset = np.zeros((B, 2), dtype=np.int32)
    jac = np.zeros((B, 2, 2), dtype=np.float64)
    wc = np.zeros((B, 2), dtype=np.float64)
    pc = np.zeros((B, 2), dtype=np.float64)
    psf = (np.asarray(psf, dtype=np.float64) if psf is not None
           else np.stack([np.asarray(img.psf, dtype=np.float64)
                          for img in images]))

    for b, img in enumerate(images):
        H, W = img.pixels.shape
        ctr = np.asarray(img.world_to_pix(world_pos), dtype=np.float64)
        off = np.round(ctr - 1.0 - (P - 1) / 2.0).astype(np.int64)
        offset[b] = off
        pc[b] = ctr
        jac[b] = img.wcs_jacobian(ctr)
        wc[b] = world_pos

        i0, i1 = max(0, off[0]), min(H, off[0] + P)
        j0, j1 = max(0, off[1]), min(W, off[1] + P)
        if i0 >= i1 or j0 >= j1:
            continue
        ti0, tj0 = i0 - off[0], j0 - off[1]
        sl_img = (slice(i0, i1), slice(j0, j1))
        sl_t = (slice(ti0, ti0 + (i1 - i0)), slice(tj0, tj0 + (j1 - j0)))
        pix[b][sl_t] = img.pixels[sl_img]

        s = img.sky
        sky[b][sl_t] = s[sl_img] if np.ndim(s) == 2 else s
        io_ = img.nelec_per_nmgy
        if np.ndim(io_) == 1:
            iota[b][sl_t] = io_[i0:i1, None]
        else:
            iota[b][sl_t] = io_

        ii = np.arange(P)[:, None] + off[0] + 1.0  # 1-based coords
        jj = np.arange(P)[None, :] + off[1] + 1.0
        xlo, xhi = ctr[0] - radius, ctr[0] + radius
        ylo, yhi = ctr[1] - radius, ctr[1] + radius
        inbox = ((ii >= xlo) & (ii <= xhi) & (jj >= ylo) & (jj <= yhi))
        valid = np.zeros((P, P), dtype=bool)
        valid[sl_t] = ~np.isnan(pix[b][sl_t])
        mask[b] = inbox & valid

    return SkyPatch(pixels=pix, mask=mask, sky=sky, iota=iota,
                    offset=offset, wcs_jacobian=jac, world_center=wc,
                    pixel_center=pc, psf=psf)


def make_patches_batched(images, positions, radii, tile_size, psfs=None,
                         active_boxes=None):
    """`make_patch_for_source` for S sources with one vectorized gather per
    band. positions (S, 2) world coordinates, radii (S,). active_boxes:
    optional (S, B, 4) [x_lo, x_hi, y_lo, y_hi] 1-based inclusive pixel
    bounds of each source's active region per image (the dilated
    detection boxes, detection.jl:152-167); default the +-radius box.
    psfs, per-source local PSFs, need the PSF fit, which has no port yet:
    given, it raises. Returns a list of S numpy SkyPatches (views into
    shared buffers)."""
    if psfs is not None:
        raise NotImplementedError(
            "per-source PSFs need models/psf_fit.py, not ported yet")
    positions = np.asarray(positions, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)
    S, B, P = len(positions), len(images), tile_size
    pix = np.full((S, B, P, P), np.nan, dtype=np.float64)
    mask = np.zeros((S, B, P, P), dtype=bool)
    sky = np.zeros((S, B, P, P), dtype=np.float64)
    iota = np.ones((S, B, P, P), dtype=np.float64)
    offset = np.zeros((S, B, 2), dtype=np.int32)
    jac = np.zeros((S, B, 2, 2), dtype=np.float64)
    wc = np.broadcast_to(positions[:, None, :], (S, B, 2)).copy()
    pc = np.zeros((S, B, 2), dtype=np.float64)
    psf = np.broadcast_to(
        np.stack([np.asarray(img.psf, dtype=np.float64) for img in images]),
        (S, B) + np.shape(images[0].psf)).copy()

    ar = np.arange(P)
    for b, img in enumerate(images):
        H, W = img.pixels.shape
        ctr = np.asarray(img.world_to_pix(positions), dtype=np.float64)
        off = np.round(ctr - 1.0 - (P - 1) / 2.0).astype(np.int64)  # (S, 2)
        offset[:, b] = off
        pc[:, b] = ctr
        jac[:, b] = img.wcs_jacobian(ctr)

        ii = off[:, 0:1] + ar[None, :]          # (S, P) 0-based rows
        jj = off[:, 1:2] + ar[None, :]          # (S, P) 0-based cols
        vi = (ii >= 0) & (ii < H)
        vj = (jj >= 0) & (jj < W)
        iic = np.clip(ii, 0, H - 1)
        jjc = np.clip(jj, 0, W - 1)
        valid = vi[:, :, None] & vj[:, None, :]  # (S, P, P)
        gathered = img.pixels[iic[:, :, None], jjc[:, None, :]]
        pix[:, b] = np.where(valid, gathered, np.nan)

        s = img.sky
        if np.ndim(s) == 2:
            sky[:, b] = np.where(valid, s[iic[:, :, None], jjc[:, None, :]],
                                 0.0)
        else:
            sky[:, b] = np.where(valid, s, 0.0)
        io_ = img.nelec_per_nmgy
        if np.ndim(io_) == 1:
            iota[:, b] = np.where(valid, np.asarray(io_)[iic][:, :, None],
                                  1.0)
        else:
            iota[:, b] = np.where(valid, io_, 1.0)

        i1 = ii + 1.0   # 1-based coords
        j1 = jj + 1.0
        if active_boxes is not None:
            bx = np.asarray(active_boxes, dtype=np.float64)[:, b]  # (S, 4)
        else:
            bx = np.stack([ctr[:, 0] - radii, ctr[:, 0] + radii,
                           ctr[:, 1] - radii, ctr[:, 1] + radii], axis=1)
        inbox = (((i1 >= bx[:, 0:1]) & (i1 <= bx[:, 1:2]))[:, :, None]
                 & ((j1 >= bx[:, 2:3]) & (j1 <= bx[:, 3:4]))[:, None, :])
        mask[:, b] = inbox & valid & ~np.isnan(pix[:, b])

    return [SkyPatch(pixels=pix[s], mask=mask[s], sky=sky[s], iota=iota[s],
                     offset=offset[s], wcs_jacobian=jac[s],
                     world_center=wc[s], pixel_center=pc[s], psf=psf[s])
            for s in range(S)]


def stack_patches(patches, device, dtype):
    """Stack per-source numpy SkyPatches into one SkyPatch with a leading S
    axis on `device`: one host-to-device copy per field; float fields in
    `dtype`, the mask bool and the offsets int32."""
    out = []
    for f in SkyPatch._fields:
        arr = np.stack([np.asarray(getattr(p, f)) for p in patches])
        if arr.dtype.kind == "f":
            out.append(torch.as_tensor(arr, dtype=dtype, device=device))
        else:
            out.append(torch.as_tensor(arr, device=device))
    return SkyPatch(*out)
