"""Expected per-band brightness moments (port of
celeste_jl_tpu/models/brightness.py, source_brightness.jl:27-202)."""

import torch

from .params import ids


def brightness_moments(vp):
    """vp (..., 44) -> (E_l (..., 5, 2), E_ll (..., 5, 2)): E[l_b | type]
    and E[l_b^2 | type]; band 3 (r, index 2) is the reference band."""
    flux_loc = vp[..., ids.flux_loc]          # (..., 2)
    flux_scale = vp[..., ids.flux_scale]
    cm = lambda c: vp[..., ids.color_mean[c]]  # (..., 2)
    cv = lambda c: vp[..., ids.color_var[c]]

    e3 = torch.exp(flux_loc + 0.5 * flux_scale)
    e4 = e3 * torch.exp(cm(2) + 0.5 * cv(2))
    e5 = e4 * torch.exp(cm(3) + 0.5 * cv(3))
    e2 = e3 * torch.exp(-cm(1) + 0.5 * cv(1))
    e1 = e2 * torch.exp(-cm(0) + 0.5 * cv(0))
    E_l = torch.stack([e1, e2, e3, e4, e5], dim=-2)

    f3 = torch.exp(2.0 * flux_loc + 2.0 * flux_scale)
    f4 = f3 * torch.exp(2.0 * cm(2) + 2.0 * cv(2))
    f5 = f4 * torch.exp(2.0 * cm(3) + 2.0 * cv(3))
    f2 = f3 * torch.exp(-2.0 * cm(1) + 2.0 * cv(1))
    f1 = f2 * torch.exp(-2.0 * cm(0) + 2.0 * cv(0))
    E_ll = torch.stack([f1, f2, f3, f4, f5], dim=-2)
    return E_l, E_ll
