"""Micro-benchmarks of the fit's evaluators (the port's counterpart of
benchmark/bench_elbo.py; the reference's benchmark_elbo_likelihood.jl and
benchmark_one_light_source.jl).

    python -m celeste_jl_tpu_torch.benchmark.bench_elbo

On synthetic.synthetic_patch_batch(S, tile=TILE, seed=0), float32 on the
card, it prints one JSON line a metric:

  * elbo_evals_per_sec         batched ELBO values (vi/elbo.elbo)
  * fg_evals_per_sec           a trust-region step's (f, g) with
                               grad_mode="ad": autograd through the tile
                               render (vi/optimize.fit_evaluators)
  * fg_analytic_evals_per_sec  the same with grad_mode="analytic"
                               (_analytic_lik_value_grad)
  * fgh_evals_per_sec          a refresh's (f, g, H): the step's (f, g),
                               the likelihood Hessian through the refresh
                               kernel (refresh_kernel="pallas") and the KL
                               Hessian, as the fit's refresh runs them
  * single_fit_latency_ms      one cold-start fit of one source (S = 1),
                               the reference's one-light-source workload

Each time is the least of REPEATS calls, with the card synchronized
before and after each, after a first call that builds the kernels. Each
line carries the card's name and power limit. The fg/fg_flat layout A/B
of the JAX runner is not ported. Env: BENCH_ELBO_SOURCES (512),
BENCH_ELBO_TILE (32), BENCH_ELBO_REPEATS (5). main(device="cpu",
dtype=torch.float64) runs it on the CPU.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ops.bijectors import enforce, to_free
from ..ops.newton import NewtonConfig
from ..parallel.run import _platform_newton_config
from ..synthetic import synthetic_patch_batch
from ..utils.device import resolve
from ..vi.elbo import elbo
from ..vi.optimize import _make_bounds, fit_evaluators, fit_sources
from .galsim_suite import card_name_and_power_limit


def evaluators(vp0, patches):
    """The timed evaluators on the batch: {metric: fn()}, each returning
    its outputs (elbo: (S,); fg, fg_analytic: (f, g); fgh: (f, g, H))."""
    bounds = _make_bounds(vp0[:, 0:2])
    free = to_free(enforce(vp0, bounds), bounds)
    fg_ad, _ = fit_evaluators(bounds, patches, grad_mode="ad")
    fg_an, _ = fit_evaluators(bounds, patches, grad_mode="analytic")
    _, fgh = fit_evaluators(bounds, patches, refresh="pallas",
                            grad_mode="ad")
    return {"elbo_evals_per_sec": lambda: elbo(vp0, patches),
            "fg_evals_per_sec": lambda: fg_ad(free),
            "fg_analytic_evals_per_sec": lambda: fg_an(free),
            "fgh_evals_per_sec": lambda: fgh(free)}


def min_wall(fn, repeats, device):
    """The least wall of `repeats` calls of fn, seconds, after one call
    that builds the kernels and makes the first allocations; the card is
    synchronized before and after each call."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    fn()
    sync()
    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def main(argv=None, *, device="cuda", dtype=torch.float32,
         newton_config=None):
    """Prints the metrics' JSON lines; returns them as a list of dicts.
    newton_config (default NewtonConfig()) is the single fit's, on the
    card as run.card_newton_config turns it."""
    argparse.ArgumentParser(
        description="micro-benchmarks of the fit's evaluators (env: "
        "BENCH_ELBO_SOURCES, BENCH_ELBO_TILE, BENCH_ELBO_REPEATS)"
    ).parse_args(argv)
    S = int(os.environ.get("BENCH_ELBO_SOURCES", "512"))
    tile = int(os.environ.get("BENCH_ELBO_TILE", "32"))
    repeats = int(os.environ.get("BENCH_ELBO_REPEATS", "5"))
    dev = resolve(device)
    card = card_name_and_power_limit(dev)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    _, vp0s, patches = synthetic_patch_batch(S, tile=tile, seed=0,
                                             dtype=np_dtype, device=dev)
    vp0 = torch.as_tensor(vp0s, device=dev)
    px_per_lane = int(patches.mask.sum()) // S
    with torch.no_grad():      # as the fit runs them
        rates = {name: S / min_wall(fn, repeats, dev)
                 for name, fn in evaluators(vp0, patches).items()}

    _, vp1s, patch1 = synthetic_patch_batch(1, tile=tile, seed=1,
                                            dtype=np_dtype, device=dev)
    vp1 = torch.as_tensor(vp1s, device=dev)
    cfg = _platform_newton_config(newton_config or NewtonConfig(), dev,
                                  dtype)
    latency = min_wall(lambda: fit_sources(vp1, patch1, config=cfg).elbo,
                       repeats, dev)

    common = dict(tile=tile, backend=dev.type, dtype=str(dtype)[6:],
                  card=card)
    lines = [dict(metric=name, value=round(rate, 1), unit="evals/s",
                  batch=S, **common) for name, rate in rates.items()]
    lines[0]["active_px_per_eval"] = px_per_lane
    lines[1]["fg_analytic_evals_per_sec"] = round(
        rates["fg_analytic_evals_per_sec"], 1)
    lines.append(dict(metric="single_fit_latency_ms",
                      value=round(1e3 * latency, 2), unit="ms",
                      solver=cfg.tr_solver, **common,
                      reference_anchor="38776 pixel-visits/fit "
                      "(benchmark_one_light_source.jl:14-17)"))
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
