"""MCMC-vs-VI experiment (the port's counterpart of
experiments/run_mcmc_experiment.py; the reference's AIS-MCMC results
pipeline, experiments/mcmc_scripts).

    python -m celeste_jl_tpu_torch.experiments.mcmc_experiment \
        [--num-sources 16] [--size 200] [--seed 11] [--temperatures 0] \
        [--samples 0] [--output-dir build/mcmc_experiment]

1. draw a catalog from the model prior (accuracy.generate_catalog_from_prior)
   and render a five-band field on a LinearWCS at 0.396 arcsec/px
   (synthetic.gen_images);
2. fit every source by joint VI (one_node_joint_infer, through the refresh,
   Jacobi-sweep and TR kernels on the card) and by batched AIS/MCMC
   (one_node_mcmc_infer, through the render kernel), both initialised
   from the truth, as the reference's synthetic experiment is;
3. write truth.csv, vi.csv, mc.csv and vi_posterior.csv (the files pandas
   writes) and the chains in mc_samples.npz into --output-dir, for
   experiments/mcmc_figures.py (the port's or the JAX package's).

Full width is the defaults: 16 sources on 200 x 200 px with Config()'s
ladder (50 temperatures x 10 samples), float32 on the card.
main(argv, device="cpu", dtype=torch.float64) runs it on the CPU.
"""

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..benchmark.accuracy import (Table, catalog_entries_to_df,
                                  celeste_to_df,
                                  generate_catalog_from_prior)
from ..io.wcs import LinearWCS
from ..mcmc.infer import mcmc_to_df, one_node_mcmc_infer
from ..models.image import Image
from ..models.psf import gaussian_psf
from ..ops.newton import NewtonConfig
from ..parallel.run import one_node_joint_infer
from ..synthetic import gen_images
from ..utils import log as Log
from ..utils.config import Config
from ..utils.device import resolve

# real sky scale (0.396 arcsec/px, like the GalSim suite), so the angular
# scorers and the one-SDSS-pixel match tolerance of benchmark/accuracy.py
# apply unchanged
DEG_PER_PX = 0.396 / 3600.0


def experiment_field(num_sources, size, seed, device):
    """(truth catalog, five images) of the experiment."""
    truth = generate_catalog_from_prior(num_sources,
                                        extent=size * DEG_PER_PX,
                                        margin=16.0 * DEG_PER_PX, seed=seed)
    wcs = LinearWCS(crpix=(0.0, 0.0), crval=(0.0, 0.0),
                    cd=np.eye(2) * DEG_PER_PX)
    psf = gaussian_psf()
    images = [Image(pixels=np.zeros((size, size)), band=b, psf=psf, sky=0.1,
                    nelec_per_nmgy=600.0, wcs=wcs) for b in range(5)]
    gen_images(images, truth, seed=seed, device=device)
    return truth, images


def ladder_config(config=None, temperatures=0, samples=0):
    """Config() (or a copy of `config`) with the AIS ladder's temperatures
    and samples replaced where not 0."""
    cfg = copy.copy(config) if config is not None else Config()
    if temperatures:
        cfg.num_ais_temperatures = temperatures
    if samples:
        cfg.num_ais_samples = samples
    return cfg


def vi_stage(truth, images, cfg, *, device, dtype, newton_config=None):
    """Joint VI over the catalog, initialised from it (the reference's
    synthetic experiment skips --use-full-initialization for the same
    reason: the init is the truth, the posterior moves off it). Returns
    (the catalog Table, the ELBOs)."""
    Log.info(f"experiment: joint VI over {len(truth)} sources")
    results = one_node_joint_infer(
        truth, images, config=cfg,
        newton_config=newton_config or NewtonConfig(), device=device,
        dtype=dtype)
    return celeste_to_df(results), np.array([r.elbo for r in results])


def mcmc_stage(truth, images, cfg, seed, *, device, dtype):
    """Batched AIS/MCMC over the catalog. Returns (the MCMC Table, the
    chains as {"star_i" | "gal_i": (draws, D)})."""
    Log.info(f"experiment: batched AIS/MCMC over {len(truth)} sources "
             f"({cfg.num_ais_temperatures} temps x {cfg.num_ais_samples})")
    results = one_node_mcmc_infer(truth, images, config=cfg, seed=seed,
                                  device=device, dtype=dtype)
    chains = {f"{m}_{i}": np.asarray(r[f"{m}_samples"])
              for m in ("star", "gal") for i, r in enumerate(results)}
    return mcmc_to_df(results, num_chains=cfg.num_ais_samples), chains


def write_outputs(output_dir, truth, vi_df, mc_df, chains):
    """truth.csv, vi.csv, mc.csv, vi_posterior.csv (as pandas writes them)
    and mc_samples.npz (the raw chains, for the posterior-comparison
    figure) under output_dir. Returns ({name: path}, truth Table,
    VI-posterior Table)."""
    os.makedirs(output_dir, exist_ok=True)
    truth_df = catalog_entries_to_df(truth)
    vi_post = Table({
        "is_star": vi_df["is_star"],
        "log_flux_r_mean": np.log(vi_df["flux_r_nmgy"]),
        "log_flux_r_stderr": vi_df["log_flux_r_stderr"],
    })
    files = {}
    for name, table in (("truth", truth_df), ("vi", vi_df), ("mc", mc_df),
                        ("vi_posterior", vi_post)):
        files[name] = os.path.join(output_dir, f"{name}.csv")
        table.to_csv(files[name])
    files["mc_samples"] = os.path.join(output_dir, "mc_samples.npz")
    np.savez_compressed(files["mc_samples"], **chains)
    Log.info(f"experiment: wrote truth/vi/mc CSVs to {output_dir}")
    return files, truth_df, vi_post


def run(num_sources=16, size=200, seed=11, temperatures=0, samples=0,
        output_dir=os.path.join("build", "mcmc_experiment"), *,
        device="cuda", dtype=torch.float32, config=None, newton_config=None,
        stage=None):
    """The experiment; returns a dict of the truth catalog (catalog), each
    stage's seconds (render, vi, mcmc), the AIS ladder and, of the stages
    run, the VI Table and ELBOs (vi, vi_elbos) and the MCMC Table and
    chains (mc, chains). config (default Config(); temperatures and
    samples, where not 0, replace its ladder) and newton_config (default
    NewtonConfig()) shorten a CPU rehearsal. stage None runs both stages
    and writes the files (adding files, truth, vi_posterior); "vi" or
    "mcmc" runs that stage alone and writes nothing. The stages are
    independent (both start from the truth), so a caller may run them in
    two processes and write their parts with write_outputs."""
    dev = resolve(device)
    t0 = time.perf_counter()
    truth, images = experiment_field(num_sources, size, seed, dev)
    cfg = ladder_config(config, temperatures, samples)
    out = dict(catalog=truth, seconds=dict(render=time.perf_counter() - t0),
               ladder=(cfg.num_ais_temperatures, cfg.num_ais_samples))
    if stage in (None, "vi"):
        t1 = time.perf_counter()
        out["vi"], out["vi_elbos"] = vi_stage(
            truth, images, cfg, device=dev, dtype=dtype,
            newton_config=newton_config)
        out["seconds"]["vi"] = time.perf_counter() - t1
    if stage in (None, "mcmc"):
        t1 = time.perf_counter()
        out["mc"], out["chains"] = mcmc_stage(truth, images, cfg, seed,
                                              device=dev, dtype=dtype)
        out["seconds"]["mcmc"] = time.perf_counter() - t1
    if stage is None:
        out["files"], out["truth"], out["vi_posterior"] = write_outputs(
            output_dir, truth, out["vi"], out["mc"], out["chains"])
    return out


def main(argv=None, *, device="cuda", dtype=torch.float32):
    p = argparse.ArgumentParser(
        description="MCMC-vs-VI experiment on a prior-draw field")
    p.add_argument("--num-sources", type=int, default=16)
    p.add_argument("--size", type=int, default=200, help="field side (px)")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--temperatures", type=int, default=0,
                   help="AIS temperatures (0 = Config default, 50)")
    p.add_argument("--samples", type=int, default=0,
                   help="AIS importance samples (0 = Config default, 10)")
    p.add_argument("--output-dir",
                   default=os.path.join("build", "mcmc_experiment"))
    args = p.parse_args(argv)
    return run(args.num_sources, args.size, args.seed, args.temperatures,
               args.samples, args.output_dir, device=device, dtype=dtype)


if __name__ == "__main__":
    main()
