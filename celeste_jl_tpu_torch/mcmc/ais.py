"""Annealed importance sampling over the batched slice sampler (port of
celeste_jl_tpu/mcmc/ais.py, mcmc/ais.jl)."""

import math

import numpy as np
import torch

from .log_prob import logpost_from_terms
from .slice import slicesample


def sigmoid_schedule(num_steps, rad=4.0):
    """Temperature ladder concentrated near 0 and 1 (ais.jl:94-101)."""
    if num_steps == 1:
        return np.linspace(0.0, 1.0, 2)
    t = np.linspace(-rad, rad, num_steps)
    sigm = 1.0 / (1.0 + np.exp(-t))
    return (sigm - sigm.min()) / (sigm.max() - sigm.min())


def ais(gen, evaluate, z0, parts0, ndim, schedule, sigma=1.0, history=None):
    """One AIS run per lane: anneal z0 ~ prior through
    p_t ∝ post^t prior^(1-t), with evaluate(z) -> (loglike, logprior).

    Returns (z_final, parts_final, ln_weight (L,)). The per-step importance
    ratio is (t - t_prev) (logpost(z) - logprior(z)) (ais.jl:17-63). At
    t = 1 outside the prior's support, t logpost + (1 - t) logprior is
    1 (-inf) + 0 (-inf) = NaN, and a NaN never clears the slice: such a
    point is rejected, as in the JAX package. A `history` list receives z
    after each step."""
    z, parts = z0, parts0
    llrs = []
    for tprev, t in zip(schedule[:-1], schedule[1:]):
        tprev, t = float(tprev), float(t)

        def lnpdf_t(p, t=t):
            return t * logpost_from_terms(*p) + (1.0 - t) * p[1]

        z, parts, _ = slicesample(gen, z, parts, ndim, evaluate, lnpdf_t,
                                  sigma=sigma)
        llrs.append((t - tprev) * (logpost_from_terms(*parts) - parts[1]))
        if history is not None:
            history.append(z)
    return z, parts, torch.sum(torch.stack(llrs), dim=0)


def log_mean_exp(w, dim=-1):
    return torch.logsumexp(w, dim=dim) - math.log(w.shape[dim])


def bootstrap_lnZ(gen, lnZ_samps, num_bootstrap=100):
    """Bootstrap distribution of the lnZ estimator of each row of the
    (S, n) weights (ais.jl:75-83), (S, num_bootstrap)."""
    S, n = lnZ_samps.shape
    idx = torch.randint(0, n, (S, num_bootstrap, n), generator=gen,
                        device=lnZ_samps.device)
    boots = torch.gather(lnZ_samps[:, None, :].expand(S, num_bootstrap, n),
                         2, idx)
    return log_mean_exp(boots)
