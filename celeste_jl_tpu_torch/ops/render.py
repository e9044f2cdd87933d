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

Two entry points:
- `mixture_poisson_ll_ragged(tiles, plan, comps, meta)`, the one the MCMC
  path uses: rows of any component counts in one launch; `tiles`
  (`active_tiles`) holds each tile's active pixels, made once per set of
  tiles, and `plan` (`row_plan`) the rows' tiles and component counts,
  made once per set of rows; comps are packed ragged, (sum_r C_r, 6);
- `mixture_poisson_ll(pixels, mask, iota, bg, comps, meta, tile_index)`,
  one model's rows (R, C, 6) on dense tiles: a thin adapter for tests and
  chip_smoke.py that builds the tiles and the plan on every call (four
  device-to-host reads), not for hot loops.
On CUDA tensors both launch the CUDA kernel csrc/render.cu; on CPU
tensors they run the plain torch twin `mixture_poisson_ll_plain` (the JAX
package's `_xla_reference`), once per segment of rows with one C. Unlike
the TPU kernel, any C and any tile size run (the TPU's C <= 8 and
(P*P) % 128 gates are not carried over).

Tests: the twin against the JAX package on the CPU in
tests/test_torch_render.py (`python -m pytest tests/test_torch_render.py`);
the kernel against the twin on a CUDA card in tests/test_torch_kernels.py
(`python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels.py -m cuda`, which skips without a card).
"""

import math
from typing import NamedTuple

import torch

from . import _build

LN2PI = math.log(2.0 * math.pi)
# most rows (one warp each) in a block of the kernel: a block stages its
# tile's active pixels once for its rows. Read by `row_plan` when it is
# called (python -m celeste_jl_tpu_torch.mcmc.profile --k4-warps W times
# the AIS at another width). 4: K4's mean time a launch in the AIS on an
# H100 was 0.1145 ms at 4, 0.1192 at 8 and 0.1202 at 16 (mcmc/profile.py).
K4_WARPS = 4


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


class ActiveTiles(NamedTuple):
    """T tiles in both of K4's forms: dense (the plain twin's input) and
    as a list of each tile's active pixels (the kernel's), tile t's being
    entries ptr[t] .. ptr[t + 1] - 1 in row-major order."""
    pixels: torch.Tensor   # (T, P, P), 0 where masked
    mask: torch.Tensor     # (T, P, P) 0/1
    iota: torch.Tensor     # (T, P, P)
    bg: torch.Tensor       # (T, P, P)
    ptr: torch.Tensor      # (T + 1,) int32
    pos: torch.Tensor      # (n,) int32: tile row << 16 | tile column
    x: torch.Tensor        # (n,) pixels, iota and bg at the active pixels
    iota_a: torch.Tensor
    bg_a: torch.Tensor


def active_tiles(pixels, mask, iota, bg):
    """The ActiveTiles of (T, P, P) tiles; mask must be 0/1. Plain torch
    on the tiles' device (one host read, for the list's length)."""
    T, P = pixels.shape[0], pixels.shape[-1]
    if P >= 1 << 15:
        raise ValueError(f"active_tiles: tile width {P} too large")
    if not bool(torch.all((mask == 0) | (mask == 1))):
        raise ValueError("active_tiles: mask must be 0 or 1")
    act = mask.reshape(T, -1) > 0
    ptr = torch.zeros(T + 1, dtype=torch.int32, device=pixels.device)
    ptr[1:] = torch.cumsum(act.sum(dim=1), dim=0)
    t, n = torch.nonzero(act, as_tuple=True)     # by tile, then row-major
    pos = ((n // P) << 16 | n % P).to(torch.int32)
    at = lambda f: f.reshape(T, -1)[t, n].contiguous()
    return ActiveTiles(pixels, mask, iota, bg, ptr, pos, at(pixels),
                       at(iota), at(bg))


class RowPlan(NamedTuple):
    """The rows of one K4 launch: consecutive segments of rows with one
    component count each, every row's tile, and the kernel's grouping of
    rows by tile: work item w = [tile, begin, end] takes rows
    order[begin:end], at most `warps` rows of one tile (tile -1 collects
    the rows whose tile index is out of range), heaviest items first."""
    tile_index: torch.Tensor   # (R,) row -> tile
    segments: tuple            # ((rows, C), ...) in row order
    comp_ptr: torch.Tensor     # (R + 1,) int32 first packed component
    order: torch.Tensor        # (R,) int32 rows grouped by tile
    work: torch.Tensor         # (n_work, 3) int32
    warps: int                 # warps (rows) a block
    n_tiles: int               # T of the ActiveTiles it was made for


def row_plan(tiles: ActiveTiles, tile_index, segments):
    """The RowPlan of rows (R,) -> tile of `tiles`, made of the segments
    ((rows, C), ...). Plain torch on tile_index's device (two host reads).

    A tile's rows go to the fewest work items of at most K4_WARPS rows,
    and a block has as many warps as the busiest tile's items need (the
    AIS's 10, 20 or 40 rows a tile: 3, 5 or 10 items of 4 warps). The
    items are ordered by their work (active pixels x components),
    heaviest first, so that the launch's last blocks are short ones."""
    dev = tile_index.device
    R = tile_index.numel()
    n_tiles = tiles.ptr.numel() - 1
    if sum(n for n, _ in segments) != R or any(n < 0 or C < 0
                                               for n, C in segments):
        raise ValueError(f"row_plan: segments {segments} for {R} rows")
    ti = tile_index.reshape(-1).long()
    ok = (ti >= 0) & (ti < n_tiles)
    group = torch.where(ok, ti, n_tiles)
    order = torch.argsort(group, stable=True)
    count = torch.bincount(group, minlength=n_tiles + 1)
    n_max = int(count.max()) if R else 0
    warps = -(-n_max // -(-n_max // K4_WARPS)) if n_max else 1
    first = torch.cumsum(count, 0) - count
    n_items = (count + warps - 1) // warps
    n_work = int(n_items.sum())
    g = torch.repeat_interleave(torch.arange(n_tiles + 1, device=dev),
                                n_items, output_size=n_work)
    k = torch.arange(n_work, device=dev) - (torch.cumsum(n_items, 0)
                                            - n_items)[g]
    begin = first[g] + k * count[g] // n_items[g]
    end = first[g] + (k + 1) * count[g] // n_items[g]
    sizes = torch.repeat_interleave(
        torch.tensor([C for _, C in segments], device=dev),
        torch.tensor([n for n, _ in segments], device=dev), output_size=R)
    n_act = (tiles.ptr[1:] - tiles.ptr[:-1]).long()
    cost = torch.where(ok, sizes * n_act[ti.clamp(0, max(n_tiles - 1, 0))],
                       0) if n_tiles else torch.zeros_like(sizes)
    cum = torch.cat([cost.new_zeros(1), torch.cumsum(cost[order], 0)])
    heavy = torch.argsort(cum[end] - cum[begin], descending=True,
                          stable=True)
    work = torch.stack([torch.where(g < n_tiles, g, -1), begin, end], dim=1)
    comp_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    comp_ptr[1:] = torch.cumsum(sizes, 0)
    return RowPlan(tile_index, tuple(segments), comp_ptr,
                   order.to(torch.int32),
                   work[heavy].to(torch.int32).contiguous(), warps, n_tiles)


def mixture_poisson_ll_ragged_plain(tiles: ActiveTiles, plan: RowPlan, comps,
                                    meta):
    """The plain twin on ragged rows: one `mixture_poisson_ll_plain` call
    per segment of plan, (R,)."""
    out, r0, k0 = [], 0, 0
    for n, C in plan.segments:
        out.append(mixture_poisson_ll_plain(
            tiles.pixels, tiles.mask, tiles.iota, tiles.bg,
            comps[k0:k0 + n * C].reshape(n, C, 6), meta[r0:r0 + n],
            plan.tile_index[r0:r0 + n]))
        r0, k0 = r0 + n, k0 + n * C
    return torch.cat(out)


def mixture_poisson_ll_ragged(tiles: ActiveTiles, plan: RowPlan, comps, meta):
    """Per-row log-likelihood of the rows of `plan`, (R,): comps
    (sum_r C_r, 6) packed in row order, meta (R, 4). csrc/render.cu in one
    launch on CUDA tensors (f32 or f64), the plain twin on CPU tensors.
    A row whose tile index is outside [0, T) comes back NaN, a row whose
    tile has no active pixel 0.

    Raises ValueError unless every tensor of comps, meta, tiles and plan
    lies on comps' device with the type and shape the kernel reads (the
    float fields in comps' type, the indices int32), plan was made for
    these tiles and comps holds plan's components. The index values are
    row_plan's and active_tiles' and are not re-read on the host: plan
    and tiles come from those functions."""
    if comps.device.type == "cpu":
        return mixture_poisson_ll_ragged_plain(tiles, plan, comps, meta)
    dtype, dev = comps.dtype, comps.device
    _build.check_cuda(dtype, dev)
    R, T, n = plan.order.numel(), tiles.ptr.numel() - 1, tiles.pos.numel()
    n_comps = sum(n_r * C for n_r, C in plan.segments)
    i32 = torch.int32
    for name, t, want_dtype, shape in (
            ("comps", comps, dtype, (n_comps, 6)),
            ("meta", meta, dtype, (R, 4)),
            ("tiles.ptr", tiles.ptr, i32, (T + 1,)),
            ("tiles.pos", tiles.pos, i32, (n,)),
            ("tiles.x", tiles.x, dtype, (n,)),
            ("tiles.iota_a", tiles.iota_a, dtype, (n,)),
            ("tiles.bg_a", tiles.bg_a, dtype, (n,)),
            ("plan.comp_ptr", plan.comp_ptr, i32, (R + 1,)),
            ("plan.order", plan.order, i32, (R,)),
            ("plan.work", plan.work, i32, (plan.work.shape[0], 3))):
        if t.dtype != want_dtype or t.device != dev or t.shape != shape:
            raise ValueError(
                f"mixture_poisson_ll_ragged: {name} {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, want {want_dtype} {shape} "
                f"on {dev}")
    if plan.n_tiles != T:
        raise ValueError(f"mixture_poisson_ll_ragged: plan made for "
                         f"{plan.n_tiles} tiles, given {T}")
    out = torch.empty(R, dtype=dtype, device=dev)
    if R:
        _build.launch("mixture_poisson_ll", dtype, comps.contiguous(),
                      plan.comp_ptr, meta.contiguous(), tiles.ptr,
                      tiles.pos, tiles.x, tiles.iota_a, tiles.bg_a,
                      plan.order, plan.work, out, plan.work.shape[0],
                      plan.warps)
        mixture_poisson_ll.launches += 1
    return out


def mixture_poisson_ll(pixels, mask, iota, bg, comps, meta, tile_index=None):
    """Same contract as `mixture_poisson_ll_plain`: csrc/render.cu on CUDA
    tensors (f32 or f64, any C and P), through `active_tiles`, `row_plan`
    and `mixture_poisson_ll_ragged` on each call; the plain twin on CPU
    tensors. Anything else raises; a row whose tile index is outside
    [0, T) comes back NaN (checked on the card, where the index lives).
    `mixture_poisson_ll.launches` counts the kernel's launches, from
    either entry point.

    An adapter for tests and chip_smoke.py: it rebuilds the active-pixel
    lists and the row plan on every call (four device-to-host reads), so
    a loop that scores the same tiles again makes them once and calls
    `mixture_poisson_ll_ragged`, as the MCMC path does."""
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
        tile_index = torch.arange(R, device=comps.device)
    tiles = active_tiles(*(t.to(dtype) for t in (pixels, mask, iota, bg)))
    plan = row_plan(tiles, tile_index, ((R, C),))
    return mixture_poisson_ll_ragged(tiles, plan, comps.reshape(R * C, 6),
                                     meta.to(dtype))


mixture_poisson_ll.launches = 0
