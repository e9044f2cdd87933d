"""Fixed-shape patch tiles (port of celeste_jl_tpu/models/patches.py).

A SkyPatch holds one source's five band tiles, with a leading S axis when
stacked: (S, B, P, P) pixel fields and (S, B, ...) per-band metadata.
"""

from typing import NamedTuple

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
