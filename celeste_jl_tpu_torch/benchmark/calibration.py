"""Posterior uncertainty calibration study, multi-seed with noise on (the
port's counterpart of benchmark/run_calibration.py;
AccuracyBenchmark.jl:978-1026).

    python -m celeste_jl_tpu_torch.benchmark.calibration \
        [--scenes a,b,c] [--out DIR]

Every GalSim-suite scene (benchmark/galsim.SCENES) is rendered with
Poisson noise at CAL_SEEDS seeds (1234 + 7919 i; default 5) and inferred
jointly in float64 on the card (galsim.run_benchmarks with force_noise),
so each (scene, field) pair contributes independent error realizations.
It prints the within-k-sigma fractions per field (a calibrated posterior
gives ~0.38 / 0.68 / 0.95 / 0.997 for k = 0.5 / 1 / 2 / 3), the |z|
quantiles per field, the mean absolute errors per field over the seeds,
and as its last line one JSON object of the three tables, the wall and
the card's name and power limit. It writes calibration_results.md only
under --out. main(argv, device="cpu") runs it on the CPU.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..utils.device import resolve
from . import accuracy as ab
from .galsim import SCENES, run_benchmarks
from .galsim_suite import card_name_and_power_limit


def seeds(n):
    """The study's seeds: 1234 + 7919 i."""
    return [1234 + 7919 * i for i in range(n)]


def aggregate(unc_tables, score_tables):
    """The study's tables from each seed's uncertainty table (with a
    `seed` column) and field-score table (with `seed`): (calibration: the
    within-k-sigma fractions per field and each field's row count N,
    |z| quantiles per field, mean errors per field: N summed and `first`
    averaged over the seeds), as run_calibration.py computes them."""
    all_unc = ab.concat(unc_tables)
    cal = ab.score_uncertainty(all_unc)
    cal["N"] = [int((all_unc["name"] == f).sum()) for f in cal["field"]]

    # z-score quantiles per field: a sharper view than threshold counts
    qs = []
    for f, g in all_unc.groupby("name"):
        z = np.abs(g["error"] / g["posterior_std_err"])
        z = z[np.isfinite(z)]
        qs.append({"field": f, "z_median": float(np.median(z)),
                   "z_p90": float(np.quantile(z, 0.9)),
                   "z_max": float(z.max())})
    zq = ab.Table.from_rows(qs)

    scores = ab.concat(score_tables)
    mean_scores = ab.Table.from_rows(
        {"field": f, "N": int(g["N"].sum()),
         "mean_err": float(g["first"].mean())}
        for f, g in scores.groupby("field"))
    return cal, zq, mean_scores


def run(names, n_seeds, *, device="cuda", newton_config=None):
    """Each seed's run; returns (calibration, z quantiles, mean errors,
    sources a seed, wall seconds)."""
    t0 = time.perf_counter()
    unc_tables, score_tables, n_sources = [], [], []
    for seed in seeds(n_seeds):
        truth_df, pred_df = run_benchmarks(
            names, joint_inference=True, seed=seed, force_noise=True,
            newton_config=newton_config, device=device, dtype=torch.float64)
        unc = ab.get_uncertainty_df(truth_df, pred_df, aligned=True)
        unc["seed"] = seed
        unc_tables.append(unc)
        scores = ab.get_scores_df(truth_df, ab.get_error_df(truth_df,
                                                            pred_df))
        scores["seed"] = seed
        score_tables.append(scores)
        n_sources.append(len(truth_df))
        print(f"seed {seed}: {len(truth_df)} sources, "
              f"{time.perf_counter() - t0:.0f}s elapsed", flush=True)
    return (*aggregate(unc_tables, score_tables), n_sources,
            time.perf_counter() - t0)


def _records(table):
    return [{k: (v.item() if hasattr(v, "item") else v)
             for k, v in table.row(i).items()} for i in range(len(table))]


def main(argv=None, *, device="cuda", newton_config=None):
    ap = argparse.ArgumentParser(
        description="posterior calibration over noisy GalSim scenes")
    ap.add_argument("--scenes", default=None)
    ap.add_argument("--out", default=None,
                    help="write calibration_results.md here")
    args = ap.parse_args(argv)
    n_seeds = int(os.environ.get("CAL_SEEDS", "5"))
    dev = resolve(device)
    names = args.scenes.split(",") if args.scenes else [s.name for s in SCENES]

    cal, zq, mean_scores, n_sources, wall = run(
        names, n_seeds, device=dev, newton_config=newton_config)
    card = card_name_and_power_limit(dev)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        md = os.path.join(args.out, "calibration_results.md")
        with open(md, "w") as f:
            f.write("# Posterior uncertainty calibration study\n\n")
            f.write(f"{len(names)} scenes x {n_seeds} seeds, ALL scenes "
                    f"rendered with Poisson noise, joint inference, "
                    f"{dev.type} f64 ({card}), {wall:.0f}s wall.\n\n")
            f.write("A calibrated posterior gives within-k-sigma fractions "
                    "~0.38 / 0.68 / 0.95 / 0.997 for k = 0.5 / 1 / 2 / 3 "
                    "(AccuracyBenchmark.jl:978-1026 analog).\n\n")
            f.write(cal.to_markdown(floatfmt=".3f"))
            f.write("\n\n## |z| quantiles per field "
                    "(|error| / posterior sd)\n\n")
            f.write(zq.to_markdown(floatfmt=".3f"))
            f.write("\n\n## Mean abs errors under noise "
                    "(per-field, averaged over seeds)\n\n")
            f.write(mean_scores.to_markdown(floatfmt=".4f"))
            f.write("\n")
        print(f"wrote {md}", flush=True)
    print(cal.to_markdown(floatfmt=".3f"))
    print(zq.to_markdown(floatfmt=".3f"))
    print(mean_scores.to_markdown(floatfmt=".4f"))
    record = dict(metric="calibration", scenes=len(names), seeds=n_seeds,
                  sources=n_sources, wall_s=round(wall, 3),
                  backend=dev.type, card=card,
                  calibration=_records(cal), z_quantiles=_records(zq),
                  mean_errors=_records(mean_scores))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
