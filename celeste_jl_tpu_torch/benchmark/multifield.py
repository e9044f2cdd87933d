"""Multi-field fused-schedule run: the box-farm occupancy test (the port's
counterpart of benchmark/run_multifield.py, on one CUDA device).

    python -m celeste_jl_tpu_torch.benchmark.multifield

Synthesizes M independent fields (each too sparse to fill a class step's
lanes alone), detects sources per field, and infers all fields as ONE
merged fused schedule (`parallel/run.joint_infer_fields`: cross-field
lateral class merging). Reference analog: the box-level task farm
(contrib/nersc/infer.sl:30 x ParallelRun.jl:302-369), which never shared a
thread pool across boxes.

Reports device fits/s (telemetry: fits over the busy wall, the union of
the fit launches' intervals), end-to-end sources/s and the fields' scores.
Prints one JSON line a pass (the JAX runner's keys, with "backend" the
torch device type and "device" the card's name) and writes no file.
Env: MF_FIELDS (default 8), MF_SOURCES (per field, default 128), MF_SIZE
(default 512), MF_SEED (default 7; field f is drawn from MF_SEED + 1000 f),
MF_REPEAT (default 2; the first pass pays the kernels' build and the first
CUDA work). MF_PIPELINE=1 runs the farm pipeline
(`joint_infer_fields_pipelined`) over a lazy stream of MF_GROUP-field
groups (default 2): each group's synthesis, detection and staging comes
before the previous group's schedule runs, and `infer_wall_s` includes
them.
"""

import json
import os
import time

import numpy as np
import torch

from ..detection.detect import detect_sources
from ..models.params import ids
from ..ops.newton import NewtonConfig
from ..parallel import run
from ..parallel.state import detection_active_boxes
from ..synthetic import (gen_images_fast, make_blank_images, sample_galaxy,
                         sample_star)
from ..utils import telemetry
from ..utils.config import Config
from ..utils.device import resolve


def make_field(seed, n_sources=128, size=512, device="cuda"):
    """benchmark/run_multifield.py's field (and run_field.py's): n_sources
    from default_rng(seed), the first half stars (r-flux lognormal(3.0,
    0.6)), the rest galaxies (lognormal(3.2, 0.5), radius lognormal(0.7,
    0.3) px, axis ratio 0.25-0.9, any angle), 16 px from the edges of a
    size x size 5-band image (sky 0.05 nMgy, 800 e-/nMgy), drawn by
    gen_images_fast on `device`. Returns (images, truth)."""
    margin = 16.0
    rng = np.random.default_rng(seed)
    truth = []
    pos = margin + rng.random((n_sources, 2)) * (size - 2 * margin)
    for i in range(n_sources):
        p = tuple(pos[i])
        if i < n_sources // 2:
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
    return images, truth


def score(results, truth):
    """run_multifield.py's score: results matched to the truth within 2 px
    (identity WCS), type accuracy over the matched, and the matched
    sources' r-flux relative errors under the fitted type. Returns
    (matched, type accuracy, errors)."""
    from scipy.spatial import cKDTree

    if not results:
        return 0, 0.0, []
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
    n_match = int(matched.sum())
    return n_match, type_ok / max(n_match, 1), errs


def build_field(seed, n_sources=128, size=512, device="cuda"):
    """One field drawn and detected (thresh 6, the whole image one box):
    (the joint_infer_fields field dict, the truth, detection seconds)."""
    images, truth = make_field(seed, n_sources, size, device)
    t0 = time.perf_counter()
    catalog, det_boxes = detect_sources(images, thresh=6.0,
                                        boxsize=(size, size),
                                        match_radius_deg=1.0)
    t_detect = time.perf_counter() - t0
    active = (detection_active_boxes(catalog, det_boxes, images)
              if catalog else None)
    return ({"catalog": catalog, "images": images, "active_boxes": active},
            truth, t_detect)


def run_pass(n_fields=8, n_sources=128, size=512, seed=7, pipeline=False,
             group=2, device="cuda", dtype=torch.float32, config=None,
             newton_config=None):
    """One pass of the run: the fields drawn from seed + 1000 f, detected,
    inferred as one merged schedule (or through the pipeline), scored.
    config and newton_config: the inference calls' (defaults Config(),
    NewtonConfig()). Returns (the JSON record with run_multifield.py's
    keys, the per-field results, the per-field truths)."""
    dev = resolve(device)
    kw = dict(config=config or Config(),
              newton_config=newton_config or NewtonConfig(), device=device,
              dtype=dtype)
    t_detect = [0.0]
    truths = []

    def field(f):
        fld, truth, td = build_field(seed + 1000 * f, n_sources, size,
                                     device)
        t_detect[0] += td
        truths.append(truth)
        return fld

    if pipeline:
        def groups():
            for g0 in range(0, n_fields, group):
                yield [field(f) for f in range(g0, min(g0 + group,
                                                       n_fields))]

        telemetry.counters.reset()
        t1 = time.perf_counter()
        per_field = []
        for res in run.joint_infer_fields_pipelined(groups(), **kw):
            per_field.extend(res)
        wall = time.perf_counter() - t1   # includes synthesis + detection
        t_synth_detect = wall
    else:
        t0 = time.perf_counter()
        fields = [field(f) for f in range(n_fields)]
        t_synth_detect = time.perf_counter() - t0
        t1 = time.perf_counter()
        per_field = run.joint_infer_fields(fields, **kw)
        wall = time.perf_counter() - t1
    c = telemetry.counters
    fits, busy = c.sources_fit, c.busy_s()
    achieved, mfu = c.mfu(dev)
    n_det = n_match = 0
    accs, errs = [], []
    for res, truth in zip(per_field, truths):
        nm, acc, e = score(res, truth)
        n_det += len(res)
        n_match += nm
        accs.append(acc)
        errs.extend(e)
    out = {
        "metric": ("multifield_pipelined_e2e_sources_per_sec" if pipeline
                   else "multifield_device_fits_per_sec"),
        "value": (n_det / wall if pipeline
                  else fits / busy if busy else None),
        "unit": "sources/s" if pipeline else "fits/s",
        "fields": n_fields,
        "sources_per_field": n_sources,
        "n_true": n_fields * n_sources,
        "n_detected": n_det,
        "n_matched": n_match,
        "completeness": n_match / (n_fields * n_sources),
        "type_accuracy": float(np.mean(accs)) if accs else 0.0,
        "median_flux_relerr": float(np.median(errs)) if errs else None,
        "fits": fits,
        "device_busy_s": busy,
        "launch_wall_sum_s": c.launch_s,
        "device_sources_per_sec": n_det / busy if busy else None,
        "utilization": c.utilization(),
        "achieved_model_gflops_per_s": achieved / 1e9,
        "mfu": mfu,
        "serial_tr_steps": c.serial_steps,
        "mean_iters_per_fit": c.newton_iters / fits if fits else None,
        "converged_frac": float(np.mean(
            [r.converged for res in per_field for r in res]
            or [0.0])),
        "e2e_sources_per_sec": n_det / wall if wall else None,
        "infer_wall_s": wall,
        "detect_wall_s": t_detect[0],
        "synth_plus_detect_wall_s": t_synth_detect,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if pipeline:
        out["pipeline"] = True
        out["group_fields"] = group
    return out, per_field, truths


def main():
    env = lambda k, d: int(os.environ.get(k, d))
    for rep in range(env("MF_REPEAT", "2")):
        out, _, _ = run_pass(
            n_fields=env("MF_FIELDS", "8"), n_sources=env("MF_SOURCES", "128"),
            size=env("MF_SIZE", "512"), seed=env("MF_SEED", "7"),
            pipeline=os.environ.get("MF_PIPELINE", "0") == "1",
            group=env("MF_GROUP", "2"))
        out["pass"] = rep
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
