"""Farm worker: drain the shared box queue until empty (the port's
counterpart of contrib/slurm/worker.py, one process on one card).

    python -m celeste_jl_tpu_torch.worker --workdir W --basedir B \
        --box ramin,ramax,decmin,decmax [--grid 8x8] [--method joint_vi] \
        [--group-boxes 2] [--no-pipeline] [--detect-thresh 1.3]

The box is split --grid RAxDEC ways into sub-boxes, published once to the
work queue under --workdir (parallel/multinode.FileWorkQueue), and drained
from the SDSS files under --basedir (io/sdss.SDSSDataSet, "celeste"
layout). Default mode (joint_vi) is the pipelined worker
(multinode.run_worker_pipelined): boxes are claimed --group-boxes at a time
and merged into one fused schedule, the next group's image loading,
detection and staging coming before the current group's schedule runs.
--no-pipeline (or a method other than joint_vi) runs the one-box-at-a-time
run_worker loop. Any number of workers may share one --workdir; a box whose
result file (celeste-<box>.npz) exists is never run again, so a rerun
resumes the farm.

The worker runs on the card, in float64 as the survey app does; main(argv,
device="cpu") runs it on the CPU. It prints one JSON line at its end: the
boxes it completed, the sources in the workdir's result files, its wall
time, each pipelined group's load, detect and infer seconds, and the
kernels' launches (K3's also by D: the PSF fits' are D = 12).
--distributed (one pod over several processes) is not ported and exits
with an error.
"""

import argparse
import json
import time

import torch

from .utils import log as Log
from .utils.device import resolve

DISTRIBUTED_MESSAGE = (
    "--distributed (one pod of processes sharing each box's fit) is not "
    "ported to celeste_jl_tpu_torch yet: it is ROADMAP Slice E's "
    "distributed half. Run one worker process per card against a shared "
    "--workdir instead.")


def main(argv=None, *, device="cuda", config=None, newton_config=None):
    """The worker CLI. Runs on `device` (the card unless the caller asks
    for the CPU) in float64; config: the inference's Config (default
    Config()); newton_config: the pipelined schedule's NewtonConfig
    (default NewtonConfig()). Returns the exit code."""
    ap = argparse.ArgumentParser(
        prog="celeste_jl_tpu_torch.worker",
        description="Drain a shared queue of sky boxes on one card.")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--basedir", required=True)
    ap.add_argument("--box", required=True,
                    help="ramin,ramax,decmin,decmax of the whole box")
    ap.add_argument("--grid", default="8x8",
                    help="RAxDEC sub-boxes the box is split into")
    ap.add_argument("--method", default="joint_vi",
                    choices=["joint_vi", "single_vi", "svi"])
    ap.add_argument("--group-boxes", type=int, default=2,
                    help="boxes fused per schedule (pipelined mode)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="one-box-at-a-time worker loop")
    ap.add_argument("--detect-thresh", type=float, default=1.3,
                    help="detection threshold in sky-noise sigmas "
                         "(detection.jl uses 1.3)")
    ap.add_argument("--distributed", action="store_true",
                    help="not ported: exits with an error")
    args = ap.parse_args(argv)
    if args.distributed:
        Log.error(DISTRIBUTED_MESSAGE)
        return 2
    resolve(device)

    from .io.dataset import BoundingBox
    from .io.sdss import SDSSDataSet
    from .main import load_results
    from .parallel import multinode as mn
    from .utils import telemetry
    from .utils.config import Config

    ramin, ramax, decmin, decmax = (float(x) for x in args.box.split(","))
    n_ra, n_dec = (int(x) for x in args.grid.split("x"))
    boxes = mn.split_box(BoundingBox(ramin, ramax, decmin, decmax),
                         n_ra, n_dec)
    queue = mn.FileWorkQueue(args.workdir, boxes)
    dataset = SDSSDataSet(args.basedir, device=device)

    def load_images(box):
        images = dataset.load_images(box)
        if not images:
            raise RuntimeError(f"no SDSS field overlaps box {box}")
        return images

    def detect_kwargs(images):
        # the survey app's detection settings (main.py)
        return dict(thresh=args.detect_thresh,
                    boxsize=(min(256, images[0].H), min(256, images[0].W)))

    groups = []
    kw = dict(config=config or Config(), newton_config=newton_config,
              detect_kwargs=detect_kwargs, device=device,
              dtype=torch.float64)
    telemetry.fit_kernel_launches(reset=True)
    t0 = time.perf_counter()
    if args.method == "joint_vi" and not args.no_pipeline:
        done = mn.run_worker_pipelined(
            queue, load_images=load_images, group_boxes=args.group_boxes,
            on_group=groups.append, **kw)
    else:
        kw.pop("newton_config")
        done = mn.run_worker(queue, load_images=load_images,
                             method=args.method, **kw)
    wall = time.perf_counter() - t0
    n_sources = sum(len(load_results(queue._result_file(b)))
                    for b in boxes if queue.done(b))
    print(json.dumps({
        "boxes": len(boxes), "boxes_done": done,
        "pending": len(queue.pending()), "sources_in_results": n_sources,
        "wall_s": wall,
        "groups": [{"boxes": [mn.box_name(b) for b in g["boxes"]],
                    **{k: g[k] for k in ("sources", "load_s", "detect_s",
                                         "infer_s")}} for g in groups],
        "kernel_launches": telemetry.fit_kernel_launches(),
        "tr_launches_by_dim": telemetry.tr_launches_by_dim(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
