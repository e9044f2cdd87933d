"""Constrained <-> unconstrained maps of the 44-dim vp (port of
celeste_jl_tpu/ops/bijectors.py, ConstraintTransforms.jl:66-126).

Free layout (41,): 26 box params, then the simplex-free params of is_star
(1) and the two k columns (7 + 7). Every function works on the trailing
axis, so one call maps a whole (S, 41) batch, and the same code runs per
lane under torch.func.vmap.

A fit resumed with the same bounds goes through its free vector, never
through to_free(vp): in f32 the position box (width 2e-4 at coordinates
~16) makes to_free ill-conditioned at the box edges.
"""

from typing import NamedTuple

import torch

IS_STAR_FLOOR = 0.005
K_FLOOR = 0.01 / 8
N_BOX = 26
N_FREE = 41


class BoxBounds(NamedTuple):
    lower: torch.Tensor   # (..., 26)
    upper: torch.Tensor   # (..., 26)
    scale: torch.Tensor   # (..., 26)


def default_box_bounds(pos, loc_width=1e-4, loc_scale=1.0):
    """Box bounds with the position box centered on `pos` (..., 2), in
    pos's dtype and on its device (elbo_constraints, ElboMaximize.jl:63-93).
    """
    lead = pos.shape[:-1]
    kw = dict(dtype=pos.dtype, device=pos.device)
    lo = [1e-2, 1e-2, -10.0, 0.10] + [-1.0] * 2 + [1e-4] * 2 \
        + [-10.0] * 8 + [1e-4] * 8
    hi = [0.99, 0.99, 10.0, 70.0] + [10.0] * 2 + [0.10] * 2 \
        + [10.0] * 8 + [1.0] * 8
    rest_lo = torch.tensor(lo, **kw).expand(lead + (24,))
    rest_hi = torch.tensor(hi, **kw).expand(lead + (24,))
    lower = torch.cat([pos - loc_width, rest_lo], dim=-1)
    upper = torch.cat([pos + loc_width, rest_hi], dim=-1)
    scale = torch.cat([torch.full(lead + (2,), float(loc_scale), **kw),
                       torch.ones(lead + (24,), **kw)], dim=-1)
    return BoxBounds(lower, upper, scale)


def simplex_to_bound(free, floor):
    """free (..., n-1) -> bound (..., n): floored softmax of [free, 0],
    with the implicit 0 logit inside the max shift."""
    n = free.shape[-1] + 1
    m = torch.clamp(torch.amax(free, dim=-1, keepdim=True), min=0.0)
    e = torch.exp(free - m)
    last = torch.exp(-m)
    total = torch.sum(e, dim=-1, keepdim=True) + last
    p = torch.cat([e, last], dim=-1) / total
    return (1.0 - n * floor) * p + floor


def simplex_to_free(bound, floor):
    n = bound.shape[-1]
    u = (bound - floor) / (1.0 - n * floor)
    return torch.log(u[..., :-1]) - torch.log(u[..., -1:])


def to_bound(free, bounds: BoxBounds):
    """free (..., 41) -> vp (..., 44)."""
    box = bounds.lower + (bounds.upper - bounds.lower) * torch.reciprocal(
        1.0 + torch.exp(-free[..., :N_BOX] / bounds.scale))
    is_star = simplex_to_bound(free[..., 26:27], IS_STAR_FLOOR)
    k0 = simplex_to_bound(free[..., 27:34], K_FLOOR)
    k1 = simplex_to_bound(free[..., 34:41], K_FLOOR)
    return torch.cat([box, is_star, k0, k1], dim=-1)


def to_free(vp, bounds: BoxBounds):
    """vp (..., 44) -> free (..., 41)."""
    frac = (vp[..., :N_BOX] - bounds.lower) / (bounds.upper - bounds.lower)
    box = -torch.log(1.0 / frac - 1.0) * bounds.scale
    is_star = simplex_to_free(vp[..., 26:28], IS_STAR_FLOOR)
    k0 = simplex_to_free(vp[..., 28:36], K_FLOOR)
    k1 = simplex_to_free(vp[..., 36:44], K_FLOOR)
    return torch.cat([box, is_star, k0, k1], dim=-1)


def _margin(vp, eps):
    """Projection margin that survives `lower + eps * width` rounding in
    vp's dtype: 1e-10 rounds away in f32, and a bound-saturated vp would
    then map to infinite free params."""
    if eps is not None:
        return eps
    return 1e-10 if vp.dtype == torch.float64 else 1e-5


def _enforce_simplex(bound, floor, eps):
    n = bound.shape[-1]
    bound = torch.clamp(bound, floor + eps, 1.0 - eps)
    total = torch.sum(bound, dim=-1, keepdim=True)
    rescale = (1.0 - n * floor) / (total - n * floor)
    return floor + eps + rescale * (bound - floor)


def enforce(vp, bounds: BoxBounds, eps=None):
    """Project vp strictly inside the constraint set
    (ConstraintTransforms.jl:225-291), with a dtype-aware margin."""
    eps = _margin(vp, eps)
    width = bounds.upper - bounds.lower
    box = torch.minimum(torch.maximum(vp[..., :N_BOX],
                                      bounds.lower + eps * width),
                        bounds.upper - eps * width)
    is_star = _enforce_simplex(vp[..., 26:28], IS_STAR_FLOOR, eps)
    k0 = _enforce_simplex(vp[..., 28:36], K_FLOOR, eps)
    k1 = _enforce_simplex(vp[..., 36:44], K_FLOOR, eps)
    return torch.cat([box, is_star, k0, k1], dim=-1)
