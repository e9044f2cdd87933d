"""Turn the JAX package's inputs into the port's.

The JAX package hands out numpy-compatible arrays (SkyPatch and
SourceTarget leaves, vp0s, NewtonConfig fields, PriorConstants arrays) and
plain dataclasses (Image, CatalogEntry); `np.asarray` reads each array, so
this module never imports jax. The tests feed both packages the same
numbers through it. The MCMC slice has no weights: its state is the
targets, the catalog and the prior.
"""

import dataclasses

import numpy as np
import torch

from .mcmc.log_prob import SourceTarget, stack_targets
from .models.image import CatalogEntry, Image
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


def source_target(tgt, device, dtype):
    """A JAX SourceTarget -> the port's, with a leading source axis: a
    single source's (pixels (B, P, P)) becomes S = 1, a stacked one (the
    JAX package's vmapped targets, pixels (S, B, P, P)) keeps its S."""
    if np.ndim(tgt.pixels) == 3:
        return stack_targets([tgt], device, dtype)
    S = np.shape(tgt.pixels)[0]
    return stack_targets([SourceTarget(*(np.asarray(f)[s] for f in tgt))
                          for s in range(S)], device, dtype)


def catalog(entries):
    """JAX CatalogEntry list -> the port's (same fields, numpy arrays)."""
    return [CatalogEntry(**{f.name: getattr(ce, f.name)
                            for f in dataclasses.fields(CatalogEntry)})
            for ce in entries]


def images(imgs):
    """JAX Image list -> the port's (same fields; pixels copied)."""
    return [Image(**{f.name: (np.array(img.pixels) if f.name == "pixels"
                              else getattr(img, f.name))
                     for f in dataclasses.fields(Image)})
            for img in imgs]
