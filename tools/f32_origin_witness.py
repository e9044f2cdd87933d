"""One multi-field runner field (benchmark/multifield.make_field) fitted in
float32 with its WCS at the origin and moved far from it, as the farm
runner's boxes are (benchmark/run_worker_farm.py gives box f the crval
(512 f, 0)): the scores of each, through the port and, with --jax, through
the JAX package on the same pixels (its joint_infer_fields with x64 off).

    python3 tools/f32_origin_witness.py [--size 128] [--sources 10]
        [--shifts 0,3584] [--fields 1] [--dtypes f32,f64] [--jax]

Prints one line a (package, dtype, shift): matched sources, type accuracy,
median r-flux relative error and the wall. On the CPU; --jax needs JAX.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def port_scores(size, n, shift, seeds, dtype):
    import numpy as np

    from celeste_jl_tpu_torch.benchmark.multifield import make_field, score
    from celeste_jl_tpu_torch.detection.detect import detect_sources
    from celeste_jl_tpu_torch.io.wcs import LinearWCS
    from celeste_jl_tpu_torch.parallel.run import joint_infer_fields
    from celeste_jl_tpu_torch.parallel.state import detection_active_boxes

    fields, truths = [], []
    for s in seeds:
        images, truth = make_field(s, n, size, "cpu")
        for img in images:
            img.wcs = LinearWCS(crval=(shift, 0.0))
        cat, boxes = detect_sources(images, thresh=6.0, boxsize=(size, size),
                                    match_radius_deg=1.0)
        fields.append({"catalog": cat, "images": images,
                       "active_boxes": detection_active_boxes(cat, boxes,
                                                              images)})
        truths.append(truth)
    res = joint_infer_fields(fields, device="cpu", dtype=dtype)
    return res, truths, np.array([shift, 0.0])


def jax_scores(size, n, shift, seeds):
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from celeste_jl_tpu.detection.detect import detect_sources
    from celeste_jl_tpu.io.wcs import LinearWCS
    from celeste_jl_tpu.parallel.run import joint_infer_fields
    from celeste_jl_tpu.parallel.state import detection_active_boxes
    from celeste_jl_tpu.synthetic import (gen_images_fast, make_blank_images,
                                          sample_galaxy, sample_star)

    fields, truths = [], []
    for s in seeds:   # make_field's draws, rendered by the JAX package
        margin, rng, truth = 16.0, np.random.default_rng(s), []
        pos = margin + rng.random((n, 2)) * (size - 2 * margin)
        for i in range(n):
            p = tuple(pos[i])
            if i < n // 2:
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
        gen_images_fast(images, truth, seed=s)
        for img in images:
            img.wcs = LinearWCS(crval=(shift, 0.0))
        cat, boxes = detect_sources(images, thresh=6.0, boxsize=(size, size),
                                    match_radius_deg=1.0)
        fields.append({"catalog": cat, "images": images,
                       "active_boxes": detection_active_boxes(cat, boxes,
                                                              images)})
        truths.append(truth)
    res = joint_infer_fields(fields)
    for r in (x for f in res for x in f):
        r.vs = np.asarray(r.vs)
        r.init_pos = np.asarray(r.init_pos)
    return res, truths, np.array([shift, 0.0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--sources", type=int, default=10)
    ap.add_argument("--shifts", default="0,3584")
    ap.add_argument("--fields", type=int, default=1)
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--jax", action="store_true",
                    help="also the JAX package, float32")
    args = ap.parse_args()

    import numpy as np
    import torch

    from celeste_jl_tpu_torch.benchmark.multifield import score

    seeds = [7 + 1000 * f for f in range(args.fields)]
    runs = [("port", d) for d in args.dtypes.split(",")]
    if args.jax:
        runs.append(("jax", "f32"))
    for pkg, dt in runs:
        for shift in (float(s) for s in args.shifts.split(",")):
            t0 = time.perf_counter()
            if pkg == "port":
                res, truths, origin = port_scores(
                    args.size, args.sources, shift, seeds,
                    torch.float32 if dt == "f32" else torch.float64)
            else:
                res, truths, origin = jax_scores(args.size, args.sources,
                                                 shift, seeds)
            wall = time.perf_counter() - t0
            n_match, accs, errs = 0, [], []
            for r, truth in zip(res, truths):
                for x in r:   # back to the field's pixel coordinates
                    x.init_pos = x.init_pos - origin
                m, acc, e = score(r, truth)
                n_match += m
                accs.append(acc)
                errs.extend(e)
            print(f"{pkg} {dt} shift {shift:g}: matched {n_match}, type "
                  f"accuracy {np.mean(accs):.4f}, median r-flux rel err "
                  f"{np.median(errs):.4g}, {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
