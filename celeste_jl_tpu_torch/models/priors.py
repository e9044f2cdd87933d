"""Model priors (the port's copy of celeste_jl_tpu/models/priors.py).

Color GMM priors are pre-trained artifacts extracted from the reference's
cfg/star_prior.jld, cfg/gal_prior.jld into data/priors.npz (the port keeps
its own copy of the file). Scalar priors follow the reference
(model/light_source_model.jl:90-129).
"""

import os
from dataclasses import dataclass

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "priors.npz")


@dataclass(frozen=True)
class PriorParams:
    is_star: np.ndarray          # (2,)
    flux_mean: np.ndarray        # (2,) lognormal loc of r-flux   [star, gal]
    flux_var: np.ndarray         # (2,) lognormal var of r-flux
    k: np.ndarray                # (8, 2) color GMM weights
    color_mean: np.ndarray       # (4, 8, 2) color GMM means
    color_cov: np.ndarray        # (4, 4, 8, 2) color GMM covariances
    gal_radius_px_mean: float
    gal_radius_px_var: float


def load_prior(path=_DATA) -> PriorParams:
    """The priors of the .npz at `path` (default the shipped
    data/priors.npz; models/fit_priors.save_prior writes the schema)."""
    d = np.load(path)
    k = np.stack([d["star_prior_weights"], d["gal_prior_weights"]], axis=1)
    color_mean = np.stack([d["star_prior_means"], d["gal_prior_means"]], axis=2)
    color_cov = np.stack([d["star_prior_covs"], d["gal_prior_covs"]], axis=3)
    return PriorParams(
        is_star=np.array([0.95, 0.05]),
        flux_mean=np.array([1.5035546, 1.07431]),
        flux_var=np.array([1.9039063 ** 2, 1.1177502 ** 2]),
        k=k,
        color_mean=color_mean,
        color_cov=color_cov,
        gal_radius_px_mean=0.5015693,
        gal_radius_px_var=0.8590007 ** 2,
    )


prior = load_prior()
