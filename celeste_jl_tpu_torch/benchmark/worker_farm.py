"""Queue-driven farm-worker run: the production path, measured (the port's
counterpart of benchmark/run_worker_farm.py, on one CUDA device).

    python -m celeste_jl_tpu_torch.benchmark.worker_farm

Unlike benchmark/multifield.py (which calls joint_infer_fields directly),
this drives the production worker loop — FileWorkQueue claims and
parallel/multinode.run_worker_pipelined — over synthetic sky boxes: each
box is one field (benchmark/multifield.make_field) synthesized inside
load_images, so its making is host work the pipeline has to carry, as
survey FITS reads would. Reference analog: the taskfarmer box farm,
contrib/nersc/infer.sl.

Prints one JSON line a pass: sustained end-to-end sources/s (the sources
in the result files over the wall, claim to last file), the occupancy
telemetry, each group's load, detect and infer seconds, the scores against
the fields' truth, K1-K3's launches and the card's name. The queue lives
in a temporary directory, removed after each pass; nothing else is
written. It runs in float32, as run_worker_farm.py does (box f's sources
sit at world coordinates up to WF_SIZE x (f + 1); the fits work relative
to each source's position box, vi/optimize._fit, so float32 holds there).

Env: WF_BOXES (default 8), WF_SOURCES (per box, default 128), WF_SIZE
(default 512), WF_GROUP (boxes fused per schedule, default 2), WF_SEED
(default 7; box f from WF_SEED + 1000 f), WF_REPEAT (default 2; the first
pass pays the kernels' build and the first CUDA work).
"""

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..io.dataset import BoundingBox
from ..io.wcs import LinearWCS
from ..main import load_results
from ..parallel.multinode import (FileWorkQueue, box_name,
                                  run_worker_pipelined, split_box)
from ..utils import telemetry
from ..utils.config import Config
from ..utils.device import resolve
from .multifield import make_field, score


def run_pass(n_boxes=8, n_sources=128, size=512, group=2, seed=7, *,
             device="cuda", config=None):
    """One pass: the boxes (RA strips of one identity-WCS box, each its
    own field moved to the strip's corner) drained by
    run_worker_pipelined from a fresh queue, then scored. Returns the
    pass's JSON record."""
    dev = resolve(device)
    boxes = split_box(BoundingBox(0.0, float(size * n_boxes), 0.0,
                                  float(size)), n_boxes, 1)
    seed_of = {box_name(b): seed + 1000 * f for f, b in enumerate(boxes)}
    truths = {}

    def load_images(box):
        # the field is drawn in pixel space, then given a translated WCS
        # so that its sources land inside THIS box's world extent (the
        # worker's targets are the sources inside the box)
        images, truth = make_field(seed_of[box_name(box)], n_sources, size,
                                   device)
        wcs = LinearWCS(crval=(box.ramin, box.decmin))
        for img in images:
            img.wcs = wcs
        truths[box_name(box)] = truth
        return images

    workdir = tempfile.mkdtemp(prefix="farm-")
    groups = []
    try:
        q = FileWorkQueue(workdir, boxes)
        telemetry.counters.reset()
        telemetry.fit_kernel_launches(reset=True)
        t0 = time.perf_counter()
        done = run_worker_pipelined(
            q, load_images=load_images, config=config or Config(),
            group_boxes=group, detect_kwargs=dict(
                thresh=6.0, boxsize=(size, size), match_radius_deg=1.0),
            device=device, dtype=torch.float32, on_group=groups.append)
        wall = time.perf_counter() - t0
        n_out = n_match = 0
        accs, errs = [], []
        for b in boxes:
            res = load_results(q._result_file(b))
            n_out += len(res)
            for r in res:   # back to the field's pixel coordinates
                r.init_pos = r.init_pos - np.array([b.ramin, b.decmin])
            nm, acc, e = score(res, truths[box_name(b)])
            n_match += nm
            accs.append(acc)
            errs.extend(e)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    c = telemetry.counters
    achieved, mfu = c.mfu(dev)
    busy = c.busy_s()
    return {
        "metric": "worker_farm_e2e_sources_per_sec",
        "value": n_out / wall,
        "unit": "sources/s",
        "boxes": n_boxes,
        "boxes_done": done,
        "group_boxes": group,
        "sources_per_box": n_sources,
        "n_inferred": n_out,
        "n_matched": n_match,
        "completeness": n_match / (n_boxes * n_sources),
        "type_accuracy": float(np.mean(accs)) if accs else 0.0,
        "median_flux_relerr": float(np.median(errs)) if errs else None,
        "wall_s": wall,
        "fits": c.sources_fit,
        "device_busy_s": busy,
        "launch_wall_sum_s": c.launch_s,
        "device_sources_per_sec": n_out / busy if busy else None,
        "utilization": c.utilization(),
        "achieved_model_gflops_per_s": achieved / 1e9,
        "mfu": mfu,
        "failures": c.failures,
        "groups": [{"boxes": len(g["boxes"]), "sources": g["sources"],
                    "load_s": g["load_s"], "detect_s": g["detect_s"],
                    "infer_s": g["infer_s"]} for g in groups],
        "launches": telemetry.fit_kernel_launches(),
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main():
    env = lambda k, d: int(os.environ.get(k, d))
    for rep in range(env("WF_REPEAT", "2")):
        out = run_pass(n_boxes=env("WF_BOXES", "8"),
                       n_sources=env("WF_SOURCES", "128"),
                       size=env("WF_SIZE", "512"),
                       group=env("WF_GROUP", "2"), seed=env("WF_SEED", "7"))
        out["pass"] = rep
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
