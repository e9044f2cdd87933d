"""Stochastic variational inference (port of
celeste_jl_tpu/vi/stochastic.py; the reference's StochasticVI.jl is an
empty stub, StochasticVI.jl:1-3).

The variational family and closed-form ELBO of deterministic VI, optimized
by Adam on pixel-minibatch gradients: each step scores a Bernoulli
subsample of the active pixels and scales the likelihood by the inverse
sampling fraction, an unbiased estimate of the ELBO gradient at
`pixel_fraction` of the full cost. Sources are the lanes of one batched
run; the gradient of the sum over lanes is each lane's gradient.

The JAX package runs optax.adam over optax.cosine_decay_schedule; both are
written out here to optax's formulas (`cosine_decay_lr`, `AdamState`). The
subsample masks are drawn step by step with a torch.Generator on the
device, or passed in (`masks`), so a test can feed the JAX package's
draws.
"""

import math
from typing import NamedTuple

import torch

from ..ops import bijectors
from .elbo import default_prior, elbo_likelihood, subtract_kl
from .optimize import _make_bounds


class SVIConfig(NamedTuple):
    steps: int = 500
    learning_rate: float = 0.1
    pixel_fraction: float = 0.25
    # cosine-decay the step size to a fraction of the initial value
    final_lr_fraction: float = 0.02


class SVIResult(NamedTuple):
    vp: torch.Tensor          # (S, 44)
    elbo: torch.Tensor        # (S,) full ELBO at the final iterate
    elbo_trace: torch.Tensor  # (S, steps) minibatch ELBO estimates


def cosine_decay_lr(config: SVIConfig, count):
    """optax.cosine_decay_schedule(learning_rate, steps,
    alpha=final_lr_fraction) at step `count` (0-based)."""
    count = min(float(count), float(config.steps))
    cosine = 0.5 * (1 + math.cos(math.pi * count / config.steps))
    alpha = config.final_lr_fraction
    return config.learning_rate * ((1 - alpha) * cosine + alpha)


class AdamState(NamedTuple):
    """optax.scale_by_adam's state (b1 0.9, b2 0.999, eps 1e-8)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor

    B1, B2, EPS = 0.9, 0.999, 1e-8

    @classmethod
    def init(cls, params):
        return cls(0, torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grad, lr):
        """(the update to add to the parameters, the next state): optax's
        scale_by_adam then scale_by_learning_rate(-lr), op for op."""
        mu = (1 - self.B1) * grad + self.B1 * self.mu
        nu = (1 - self.B2) * grad ** 2 + self.B2 * self.nu
        count = self.count + 1
        mu_hat = mu / (1 - self.B1 ** count)
        nu_hat = nu / (1 - self.B2 ** count)
        step = mu_hat / (torch.sqrt(nu_hat) + self.EPS)
        return -lr * step, AdamState(count, mu, nu)


def draw_mask(mask, config: SVIConfig, generator):
    """One step's subsample, mask.shape bool: Bernoulli with p =
    pixel_fraction (jax.random.bernoulli's uniform < p), drawn from
    `generator` on mask's device."""
    u = torch.rand(mask.shape, generator=generator, device=mask.device,
                   dtype=torch.float64)
    return u < config.pixel_fraction


def svi_maximize(vp0s, patches, bg_E_G=None, bg_var_G=None, include_kl=True,
                 config: SVIConfig = SVIConfig(), loc_width=1e-4,
                 loc_scale=1.0, *, masks=None, generator=None):
    """Fit every lane by pixel-minibatch SVI: vp0s (S, 44), patches a
    SkyPatch with leading S. masks (steps, S, B, P, P) bool: the subsample
    of each step (None: each step's is drawn from `generator`; unused when
    pixel_fraction >= 1). Returns an SVIResult."""
    bounds = _make_bounds(vp0s[:, 0:2], loc_width, loc_scale)
    prior = default_prior(vp0s.device, vp0s.dtype)
    p = config.pixel_fraction

    def estimate(free, t):
        vp = bijectors.to_bound(free, bounds)
        if p >= 1.0:
            ll = elbo_likelihood(vp, patches, bg_E_G, bg_var_G)
        else:
            keep = (draw_mask(patches.mask, config, generator)
                    if masks is None else masks[t])
            sub = patches._replace(mask=patches.mask & keep)
            ll = (1.0 / p) * elbo_likelihood(vp, sub, bg_E_G, bg_var_G)
        if include_kl:
            ll = ll + subtract_kl(vp, prior)
        return ll

    with torch.no_grad():
        free = bijectors.to_free(bijectors.enforce(vp0s, bounds), bounds)
    opt = AdamState.init(free)
    trace = []
    for t in range(config.steps):
        with torch.enable_grad():
            fr = free.detach().requires_grad_(True)
            ll = estimate(fr, t)
            (grad,) = torch.autograd.grad(-ll.sum(), fr)
        with torch.no_grad():
            update, opt = opt.update(grad, cosine_decay_lr(config, t))
            free = free + update
        trace.append(ll.detach())
    with torch.no_grad():
        vp = bijectors.to_bound(free, bounds)
        full = elbo_likelihood(vp, patches, bg_E_G, bg_var_G)
        if include_kl:
            full = full + subtract_kl(vp, prior)
    return SVIResult(vp=vp, elbo=full, elbo_trace=torch.stack(trace, dim=1))


def fit_sources_svi(vp0s, patches, bg_E_G=None, bg_var_G=None,
                    include_kl=True, config: SVIConfig = SVIConfig(), *,
                    seed=0):
    """Batched SVI fits of vp0s (S, 44) on patches with leading S, the
    subsamples drawn from a torch.Generator on the patches' device seeded
    with `seed` (the JAX package's fit_sources_svi takes a PRNG key)."""
    generator = torch.Generator(device=patches.mask.device)
    generator.manual_seed(seed)
    return svi_maximize(vp0s, patches, bg_E_G, bg_var_G, include_kl, config,
                        generator=generator)
