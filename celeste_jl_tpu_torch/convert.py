"""Turn the JAX package's inputs into the port's.

The JAX package hands out numpy-compatible arrays (SkyPatch leaves, vp0s,
NewtonConfig fields, PriorConstants arrays); `np.asarray` reads each one,
so this module never imports jax. The tests feed both packages the same
numbers through it.
"""

import numpy as np
import torch

from .models.patches import SkyPatch
from .ops.newton import NewtonConfig
from .vi.elbo import PriorConstants


def tensor(a, device, dtype):
    """Any array -> tensor on `device`; float arrays become `dtype`."""
    a = np.array(a)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    return torch.tensor(a, device=device)


def sky_patch(patch, device, dtype):
    """A SkyPatch of arrays (either package's, or numpy) -> the port's."""
    return SkyPatch(*(tensor(getattr(patch, f), device, dtype)
                      for f in SkyPatch._fields))


def vp0s(vp, device, dtype):
    """(S, 44) initial variational parameters."""
    return tensor(vp, device, dtype)


def newton_config(cfg):
    """The JAX NewtonConfig -> the port's (same fields, same values)."""
    return NewtonConfig(**cfg._asdict())


def prior_constants(pc, device, dtype):
    """The JAX vi/elbo.PriorConstants -> the port's."""
    t = lambda a: tensor(a, device, dtype)
    return PriorConstants(t(pc.is_star), t(pc.flux_mean), t(pc.flux_var),
                          t(pc.k), t(pc.color_mean), t(pc.color_cov_inv),
                          t(pc.color_cov_logdet), pc.gal_radius_px_mean,
                          pc.gal_radius_px_var)
