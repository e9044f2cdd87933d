"""SVI against Newton VI on one synthetic field: accuracy and throughput
(the port's counterpart of benchmark/run_svi_compare.py).

    python -m celeste_jl_tpu_torch.benchmark.svi_compare [--out DIR]

The field: SVI_SOURCES sources (half stars) on an SVI_SIZE-px square,
drawn from SVI_SEED as run_svi_compare.py draws them, detected
(detect_sources, thresh 6), then fitted through the same driver twice:
one_node_single_infer (Newton trust region through the refresh,
Jacobi-sweep and TR kernels on the card) and one_node_svi_infer (Adam on
pixel minibatches, vi/stochastic.py) at pixel fractions 1.0, 0.5 and
0.25, SVI_STEPS steps. Both fit each source independently against its
neighbours' catalog-init background, so the comparison isolates the
optimizer. Scored against the generating truth. Prints one JSON line a
configuration and pass (run_svi_compare.py's keys, backend "cuda", the
card's name and power limit) and writes svi_results.md only under --out.
Env (defaults): SVI_SOURCES (128), SVI_SIZE (512), SVI_SEED (7),
SVI_STEPS (500), SVI_REPEAT (2; pass 0 builds the kernels). f32 on the
card; main(argv, device="cpu", dtype=torch.float64) on the CPU.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..detection.detect import detect_sources
from ..models.params import ids
from ..ops.newton import NewtonConfig
from ..parallel.run import (detection_active_boxes, one_node_single_infer,
                            one_node_svi_infer)
from ..synthetic import (gen_images_fast, make_blank_images, sample_galaxy,
                         sample_star)
from ..utils import telemetry
from ..utils.config import Config
from ..utils.device import resolve
from ..vi.stochastic import SVIConfig
from .galsim_suite import card_name_and_power_limit


def svi_field(n_sources, size, seed, device):
    """(truth, images) of run_svi_compare.py's field."""
    margin = 16.0
    rng = np.random.default_rng(seed)
    truth, n_star = [], n_sources // 2
    pos = margin + rng.random((n_sources, 2)) * (size - 2 * margin)
    for i in range(n_sources):
        p = tuple(pos[i])
        if i < n_star:
            truth.append(sample_star(pos=p, r_flux=float(
                np.exp(rng.normal(3.0, 0.6)))))
        else:
            truth.append(sample_galaxy(
                pos=p, r_flux=float(np.exp(rng.normal(3.2, 0.5))),
                gal_radius_px=float(np.exp(rng.normal(0.7, 0.3))),
                gal_axis_ratio=float(rng.uniform(0.25, 0.9)),
                gal_angle=float(rng.uniform(0.0, np.pi))))
    images = make_blank_images(H=size, W=size, sky_nmgy=0.05,
                               nelec_per_nmgy=800.0)
    gen_images_fast(images, truth, seed=seed, device=device)
    return truth, images


def score(results, truth):
    """(matched, type accuracy, median relative r-flux error, mean ELBO):
    each result matched to its nearest truth within 2 px."""
    from scipy.spatial import cKDTree

    tpos = np.array([t.pos for t in truth])
    rpos = np.array([r.init_pos for r in results])
    dist, nearest = cKDTree(tpos).query(rpos, k=1)
    matched = dist < 2.0
    type_ok, errs = 0, []
    for r, t_i, m in zip(results, nearest, matched):
        if not m:
            continue
        t = truth[t_i]
        p_star = r.vs[ids.is_star[0]]
        type_ok += int((p_star > 0.5) == t.is_star)
        tf = (t.star_fluxes if t.is_star else t.gal_fluxes)[2]
        j = 0 if p_star > 0.5 else 1
        f = float(np.exp(r.vs[ids.flux_loc[j]]
                         + 0.5 * r.vs[ids.flux_scale[j]]))
        errs.append(abs(f - tf) / tf)
    nm = int(matched.sum())
    return (nm, type_ok / max(nm, 1),
            float(np.median(errs)) if errs else None,
            float(np.mean([r.elbo for r in results])))


def main(argv=None, *, device="cuda", dtype=torch.float32,
         newton_config=None):
    """Prints the rows' JSON lines; returns the rows."""
    ap = argparse.ArgumentParser(description="SVI against Newton VI")
    ap.add_argument("--out", default=None, help="write svi_results.md here")
    args = ap.parse_args(argv)
    n_sources = int(os.environ.get("SVI_SOURCES", "128"))
    size = int(os.environ.get("SVI_SIZE", "512"))
    seed = int(os.environ.get("SVI_SEED", "7"))
    steps = int(os.environ.get("SVI_STEPS", "500"))
    repeat = int(os.environ.get("SVI_REPEAT", "2"))
    dev = resolve(device)
    card = card_name_and_power_limit(dev)
    newton_config = newton_config or NewtonConfig()

    truth, images = svi_field(n_sources, size, seed, dev)
    catalog, det_boxes = detect_sources(images, thresh=6.0,
                                        boxsize=(size, size),
                                        match_radius_deg=1.0)
    active = detection_active_boxes(catalog, det_boxes, images)
    cfg = Config()
    kw = dict(config=cfg, active_boxes=active, device=dev, dtype=dtype)
    cases = ([("single_vi", None)]
             + [("svi", SVIConfig(steps=steps, pixel_fraction=pf))
                for pf in (1.0, 0.5, 0.25)])
    rows = []
    for rep in range(repeat):
        for method, svi_cfg in cases:
            telemetry.counters.reset()
            t0 = time.perf_counter()
            if method == "svi":
                res = one_node_svi_infer(catalog, images, svi_config=svi_cfg,
                                         **kw)
            else:
                res = one_node_single_infer(catalog, images,
                                            newton_config=newton_config, **kw)
            wall = time.perf_counter() - t0
            nm, acc, med_err, mean_elbo = score(res, truth)
            busy = telemetry.counters.busy_s()
            row = {
                "metric": "svi_vs_newton", "method": method,
                "pixel_fraction": svi_cfg.pixel_fraction if svi_cfg else None,
                "steps": svi_cfg.steps if svi_cfg else None,
                "sources": len(catalog), "n_matched": nm,
                "type_accuracy": round(acc, 3),
                "median_flux_relerr": (round(med_err, 4)
                                       if med_err is not None else None),
                "mean_elbo": round(mean_elbo, 1), "wall_s": round(wall, 2),
                "sources_per_sec": round(len(catalog) / wall, 2),
                "device_busy_s": round(busy, 2),
                "device_sources_per_sec": (round(len(catalog) / busy, 2)
                                           if busy else None),
                "backend": dev.type, "dtype": str(dtype)[6:], "card": card,
                "pass": rep,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        warm = [r for r in rows if r["pass"] == repeat - 1]
        with open(os.path.join(args.out, "svi_results.md"), "w") as f:
            f.write("# SVI vs Newton-VI (same field, same driver)\n\n"
                    f"`python -m celeste_jl_tpu_torch.benchmark.svi_compare`"
                    f" with SVI_SOURCES={n_sources} SVI_SIZE={size} "
                    f"SVI_STEPS={steps} on {dev.type} ({card}), "
                    f"{str(dtype)[6:]}; last pass:\n\n"
                    "| method | pix frac | type acc | med flux err "
                    "| mean ELBO | src/s (e2e) | src/s (device) |\n"
                    "|---|---|---|---|---|---|---|\n")
            for r in warm:
                f.write(f"| {r['method']} | {r['pixel_fraction'] or '-'} "
                        f"| {r['type_accuracy']} | {r['median_flux_relerr']} "
                        f"| {r['mean_elbo']} | {r['sources_per_sec']} "
                        f"| {r['device_sources_per_sec']} |\n")
            f.write("\nFull JSON rows:\n\n```json\n"
                    + "\n".join(json.dumps(r) for r in rows) + "\n```\n")
    return rows


if __name__ == "__main__":
    main()
