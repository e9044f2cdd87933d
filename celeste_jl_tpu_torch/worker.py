"""Farm worker: drain the shared box queue until empty (the port's
counterpart of contrib/slurm/worker.py).

    python -m celeste_jl_tpu_torch.worker --workdir W --basedir B \
        --box ramin,ramax,decmin,decmax [--grid 8x8] [--method joint_vi] \
        [--group-boxes 2] [--no-pipeline] [--detect-thresh 1.3] \
        [--distributed]

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

--distributed joins every process of the job into one pod
(multinode.init_distributed: torchrun's, Slurm's or the CELESTE_*
variables) before anything touches the card, and drains the queue as the
pod (multinode.run_worker_distributed): rank 0 claims each box, every rank
stages it (detection, 32 x 32 patches of radius 12 around each target,
catalog initialization: single-source VI, make_single_vi_stage) and fits
its block of the box's targets, and rank 0 saves them. --method,
--group-boxes and --no-pipeline do not apply to it.

The worker runs on the card, in float64 as the survey app does; main(argv,
device="cpu") runs it on the CPU. It prints one JSON line at its end: the
boxes it completed, the sources in the workdir's result files, its wall
time, each pipelined group's load, detect and infer seconds, its rank and
the pod's size, and the kernels' launches (K3's also by D: the PSF fits'
are D = 12), this rank's and every rank's.
"""

import argparse
import json
import time

import numpy as np
import torch

from .utils.device import resolve


def make_single_vi_stage(load_images, detect_kwargs, *, device, dtype):
    """BoundingBox -> (vp0s (S, 44), patches, positions, bad_sky) for the
    distributed worker: detection, each target's (a detection inside the
    box) 32 x 32 patch, active within 12 px, and catalog initialization
    (contrib/slurm/worker.make_single_vi_stage), with each target's
    catalog position and run.bad_sky flag for its record. Deterministic
    host work, repeated the same on every rank of the pod. A box without
    targets gives S = 0 and patches None. detect_kwargs: a callable of the
    images that returns detection's keywords."""
    from .detection.detect import detect_sources
    from .models.patches import make_patch_for_source, stack_patches
    from .parallel.run import bad_sky
    from .vi.init import catalog_init_source

    def stage(box):
        images = load_images(box)
        catalog, _ = detect_sources(images, **detect_kwargs(images))
        targets = [ce for ce in catalog if box.contains(ce.pos[0], ce.pos[1])]
        positions = [np.asarray(ce.pos, np.float64) for ce in targets]
        bad = [bad_sky(ce, images) for ce in targets]
        if not targets:
            return (torch.zeros((0, 44), dtype=dtype, device=device), None,
                    positions, bad)
        patches = stack_patches([
            make_patch_for_source(images, ce.pos, radius=12, tile_size=32)
            for ce in targets], device, dtype)
        vp0s = torch.as_tensor(np.stack([catalog_init_source(ce)
                                         for ce in targets]),
                               dtype=dtype, device=device)
        return vp0s, patches, positions, bad

    return stage


def _save_single_vi(workdir):
    """save_box of the distributed worker: each target's record with its
    catalog position and its bad_sky flag."""
    from .main import save_results
    from .parallel.state import OptimizedSource

    def save(box, res, positions, bad):
        results = []
        if res is not None:
            vp = res.vp.double().cpu().numpy()
            elbo = res.elbo.double().cpu().numpy()
            conv = res.converged.cpu().numpy()
            results = [OptimizedSource(init_pos=positions[i], vs=vp[i],
                                       elbo=float(elbo[i]),
                                       converged=bool(conv[i]),
                                       is_sky_bad=bool(bad[i]))
                       for i in range(len(positions))]
        save_results(workdir, box, results)

    return save
def main(argv=None, *, device="cuda", config=None, newton_config=None):
    """The worker CLI. Runs on `device` (the card unless the caller asks
    for the CPU) in float64; config: the inference's Config (default
    Config()); newton_config: the pipelined schedule's NewtonConfig
    (default NewtonConfig()). Returns the exit code."""
    ap = argparse.ArgumentParser(
        prog="celeste_jl_tpu_torch.worker",
        description="Drain a shared queue of sky boxes.")
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
                    help="join the job's processes into one pod: rank 0 "
                         "claims and saves, every rank fits a block of "
                         "each box's sources")
    args = ap.parse_args(argv)

    from .parallel import multinode as mn

    rank, world = (mn.init_distributed(device=device) if args.distributed
                   else (0, 1))
    resolve(device)

    from .io.dataset import BoundingBox
    from .io.sdss import SDSSDataSet
    from .main import load_results
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
    if args.distributed:
        done = mn.run_worker_distributed(
            queue, make_single_vi_stage(load_images, detect_kwargs,
                                        device=device, dtype=torch.float64),
            save_box=_save_single_vi(queue.workdir), config=newton_config,
            worker_id=f"rank{rank}")
    elif args.method == "joint_vi" and not args.no_pipeline:
        done = mn.run_worker_pipelined(
            queue, load_images=load_images, group_boxes=args.group_boxes,
            on_group=groups.append, **kw)
    else:
        kw.pop("newton_config")
        done = mn.run_worker(queue, load_images=load_images,
                             method=args.method, **kw)
    wall = time.perf_counter() - t0
    launches = telemetry.fit_kernel_launches()
    by_rank = [launches]
    if args.distributed:
        import torch.distributed as dist

        by_rank = [None] * world
        dist.all_gather_object(by_rank, launches)
    n_sources = sum(len(load_results(queue._result_file(b)))
                    for b in boxes if queue.done(b))
    print(json.dumps({
        "boxes": len(boxes), "boxes_done": done,
        "pending": len(queue.pending()), "sources_in_results": n_sources,
        "wall_s": wall,
        "groups": [{"boxes": [mn.box_name(b) for b in g["boxes"]],
                    **{k: g[k] for k in ("sources", "load_s", "detect_s",
                                         "infer_s")}} for g in groups],
        "rank": rank, "world_size": world,
        "kernel_launches": launches, "kernel_launches_by_rank": by_rank,
        "tr_launches_by_dim": telemetry.tr_launches_by_dim(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
