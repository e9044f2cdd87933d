"""Sky-box farming on one card (the port's counterpart of the one-card part
of celeste_jl_tpu/parallel/multinode.py; the reference's cluster layer).

The reference distributes work as one process per RA/Dec box with no
inter-box communication — Slurm taskfarmer at NERSC (contrib/nersc/infer.sl)
plus a historical Dtree distributed work-stealing scheduler
(contrib/http/infer_boxes_http.jl). Here:

  * `split_box` — partition a big BoundingBox into a grid of sub-boxes
    (contrib/nersc/list_rcfs.jl / list_quarters.jl role);
  * `FileWorkQueue` — a filesystem-based dynamic work queue: any number of
    worker processes/hosts sharing a directory atomically claim boxes via
    O_EXCL lock files and mark them done by writing the result file. No
    coordinator process, elastic (a crashed worker's stale claim is
    reclaimed after `stale_s`);
  * `run_worker` — claim-infer-save loop for one process, one box at a
    time. Failed boxes are released for retry (up to `max_attempts`) — the
    reference's "a failed box task is just re-run" elasticity;
  * `run_worker_pipelined` — the production loop: boxes claimed a group at
    a time and streamed through `joint_infer_fields_pipelined`, the boxes
    of a group merged into one fused schedule on the card.

Checkpoint/resume granularity is the box, like the reference (main.jl:50-56):
a box whose result file exists is never re-run, so resume = rerun the farm.
The workers run on the card unless the caller asks for the CPU.

Across processes, one pod: `init_distributed()` joins the processes into
one torch.distributed world (Slurm's, torchrun's or the JAX package's
CELESTE_* variables, or explicit arguments), `fit_sources_distributed`
shards one fit batch's sources across every rank (parallel/mesh.py), and
`run_worker_distributed` gates the queue on `is_queue_leader()`, so that
one process claims boxes and writes results while every process joins
each box's fit.
"""

import json
import os
import time

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..io.dataset import BoundingBox
from ..utils import log as Log


def _env_int(*names):
    """The first of the environment variables `names` that is set, as an
    int (a Slurm count such as "2(x3)" reads as 2), else None."""
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v.split("(")[0])
    return None


def _coordinator():
    addr = os.environ.get("CELESTE_COORDINATOR")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, initialization_timeout=None, *,
                     device="cuda"):
    """Join this process to its pod: the torch.distributed default process
    group (idempotent). Returns (rank, world_size).

    The pod comes from the arguments, else from the JAX package's
    CELESTE_COORDINATOR ("host:port"), CELESTE_NUM_PROCESSES and
    CELESTE_PROCESS_ID, else torchrun's RANK and WORLD_SIZE or Slurm's
    SLURM_PROCID and SLURM_NTASKS, with the coordinator from
    CELESTE_COORDINATOR or torchrun's MASTER_ADDR and MASTER_PORT. With
    none of these the process is a pod of one, which the log says. A pod
    of more than one that cannot form raises; the JAX package runs such a
    process alone instead.

    device "cpu": the ranks join with Gloo. device "cuda" (the card
    unless the caller asks for the CPU): each rank takes card
    local rank % cards (LOCAL_RANK or SLURM_LOCALID, else the rank) and
    the ranks join with NCCL when every rank of the host has a card of
    its own (LOCAL_WORLD_SIZE or SLURM_NTASKS_PER_NODE ranks a host,
    else the world on one host), with Gloo when ranks share a card (NCCL
    refuses two ranks on one device). initialization_timeout (seconds)
    bounds the forming and every collective of the group. One barrier
    follows the forming."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    from ..utils.device import resolve

    dev = resolve(device)
    address = coordinator_address or _coordinator()
    world = num_processes or _env_int("CELESTE_NUM_PROCESSES", "WORLD_SIZE",
                                      "SLURM_NTASKS")
    rank = process_id if process_id is not None else _env_int(
        "CELESTE_PROCESS_ID", "RANK", "SLURM_PROCID")
    if world is None and address is None:
        world, rank = 1, 0
    if world is None or rank is None:
        raise ValueError(f"pod: world size {world} and rank {rank} are not "
                         "both given")
    if world > 1 and address is None:
        raise ValueError(f"a pod of {world} processes needs a coordinator "
                         "address (CELESTE_COORDINATOR or MASTER_ADDR and "
                         "MASTER_PORT)")

    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        local_world = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE")
        torch.cuda.set_device((rank if local_rank is None else local_rank)
                              % cards)
        if (world if local_world is None else local_world) <= cards:
            backend = "nccl"
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if world == 1 and address is None:
        Log.info("init_distributed: no pod was asked for; running as a pod "
                 "of one process")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                rank=rank, world_size=world, **kw)
    dist.barrier()
    Log.info(f"init_distributed: rank {rank} of {world} ({backend})")
    return rank, world


def is_queue_leader():
    """True on the process that claims boxes and writes results: rank 0
    of the pod (every process that is in no pod)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def fit_sources_distributed(vp0s, patches, config=None, include_kl=True):
    """One fit batch sharded across every rank of the pod.

    vp0s (S, 44) and patches (leading S axis) must be the same on every
    rank, each on its rank's device: each rank stages the box (cheap host
    work) and fits its block of source lanes on a 1-D src mesh over the
    pod (parallel/mesh.fit_sources_sharded: lanes padded to the world
    size, independent, gathered once at the end). Rank r's block is the
    r-th. config: the NewtonConfig; default the solver of the rank's
    device (run._platform_newton_config: on a card pjacobi through
    K1-K3). Returns the whole FitResult on every rank."""
    from ..ops.newton import NewtonConfig
    from .mesh import fit_sources_sharded, world_src_mesh
    from .run import _platform_newton_config

    if config is None:
        config = _platform_newton_config(NewtonConfig(), vp0s.device,
                                         vp0s.dtype)
    return fit_sources_sharded(vp0s, patches, world_src_mesh(),
                               include_kl=include_kl, config=config)


def _broadcast_index(i):
    """Rank 0's int `i` on every rank of the pod (an int64 tensor on the
    device the backend's collectives take)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([i], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def split_box(box: BoundingBox, n_ra: int, n_dec: int):
    """Partition `box` into an n_ra x n_dec grid of sub-boxes."""
    ras = np.linspace(box.ramin, box.ramax, n_ra + 1)
    decs = np.linspace(box.decmin, box.decmax, n_dec + 1)
    return [BoundingBox(ras[i], ras[i + 1], decs[j], decs[j + 1])
            for i in range(n_ra) for j in range(n_dec)]


def box_name(box: BoundingBox):
    return (f"{box.ramin:.4f}-{box.ramax:.4f}"
            f"-{box.decmin:.4f}-{box.decmax:.4f}")


class FileWorkQueue:
    """Atomic filesystem work queue over sky boxes.

    Layout under `workdir`:
      boxes.json                 — the task list (written once by any worker)
      claims/<name>.claim        — O_EXCL lock file, holds claimer + attempt
      celeste-<name>.npz         — result file; its existence means done
    """

    def __init__(self, workdir, boxes=None, stale_s=3600.0, max_attempts=3):
        self.workdir = workdir
        self.claims = os.path.join(workdir, "claims")
        os.makedirs(self.claims, exist_ok=True)
        self.stale_s = stale_s
        self.max_attempts = max_attempts
        self.tasks_file = os.path.join(workdir, "boxes.json")
        if boxes is not None and not os.path.exists(self.tasks_file):
            tmp = self.tasks_file + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump([[b.ramin, b.ramax, b.decmin, b.decmax]
                           for b in boxes], f)
            os.replace(tmp, self.tasks_file)  # atomic publish

    def boxes(self):
        with open(self.tasks_file) as f:
            return [BoundingBox(*row) for row in json.load(f)]

    def _result_file(self, box):
        return os.path.join(self.workdir, f"celeste-{box_name(box)}.npz")

    def _claim_file(self, box):
        return os.path.join(self.claims, f"{box_name(box)}.claim")

    def done(self, box):
        return os.path.exists(self._result_file(box))

    def _read_claim(self, path):
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            return {"t": 0.0, "attempt": 0}

    def try_claim(self, box, worker_id):
        """Atomically claim `box`. Returns the attempt number, or None if the
        box is done, actively claimed, or exhausted its attempts."""
        if self.done(box):
            return None
        path = self._claim_file(box)
        attempt = 1
        if os.path.exists(path):
            prev = self._read_claim(path)
            age = time.time() - prev.get("t", 0.0)
            if age < self.stale_s:
                return None              # actively claimed
            attempt = prev.get("attempt", 0) + 1
            if attempt > self.max_attempts:
                return None              # permanently failed
            try:
                os.unlink(path)          # reclaim stale lock
            except FileNotFoundError:
                pass
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None                  # raced another worker
        with os.fdopen(fd, "w") as f:
            json.dump({"worker": worker_id, "t": time.time(),
                       "attempt": attempt}, f)
        return attempt

    def release(self, box):
        """Release a claim after failure so another worker may retry (the
        attempt count is kept in the claim file until reclaimed)."""
        path = self._claim_file(box)
        if os.path.exists(path):
            prev = self._read_claim(path)
            prev["t"] = 0.0              # mark immediately stale
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(prev, f)
            os.replace(tmp, path)

    def pending(self):
        return [b for b in self.boxes() if not self.done(b)]


def _worker_id(worker_id):
    return worker_id or f"{os.uname().nodename}:{os.getpid()}"


def _detect_kwargs(detect_kwargs, images):
    if callable(detect_kwargs):
        return detect_kwargs(images)
    return detect_kwargs or {}


def run_worker(queue: FileWorkQueue, load_images, method="joint_vi",
               config=None, worker_id=None, infer=None, max_boxes=None,
               detect_kwargs=None, *, device="cuda", dtype=torch.float32):
    """Claim-infer-save loop for one worker process, one box at a time.

    load_images: BoundingBox -> [Image] (e.g. dataset.load_images).
    infer: override the inference callable (images, box) -> results, for
    tests; by default infer_box(method, detect_kwargs) on `device` in
    `dtype`. detect_kwargs: detection's keywords (thresh, boxsize, ...), or
    a callable of the images that returns them. Returns the number of
    boxes this worker completed."""
    from ..main import save_results
    from ..utils.config import Config
    from .run import infer_box

    config = config or Config()
    worker_id = _worker_id(worker_id)
    infer = infer or (lambda images, box: infer_box(
        images, box=box, method=method, config=config, device=device,
        dtype=dtype, **_detect_kwargs(detect_kwargs, images)))

    completed = 0
    progress = True
    while progress and (max_boxes is None or completed < max_boxes):
        progress = False
        for box in queue.boxes():
            if max_boxes is not None and completed >= max_boxes:
                break
            if queue.done(box):
                continue
            attempt = queue.try_claim(box, worker_id)
            if attempt is None:
                continue
            progress = True
            Log.info(f"worker {worker_id}: box {box_name(box)} "
                     f"(attempt {attempt})")
            try:
                t0 = time.perf_counter()
                images = load_images(box)
                results = infer(images, box)
                save_results(queue.workdir, box, results)
                completed += 1
                Log.info(f"worker {worker_id}: box {box_name(box)} done, "
                         f"{len(results)} sources in "
                         f"{time.perf_counter() - t0:.1f}s")
            except Exception as exc:
                Log.exception(exc)
                queue.release(box)
    return completed


def run_worker_pipelined(queue: FileWorkQueue, load_images, config=None,
                         worker_id=None, group_boxes=2, max_boxes=None,
                         detect_kwargs=None, seed=42, newton_config=None, *,
                         device="cuda", dtype=torch.float32, on_group=None):
    """Claim-infer-save loop over fused multi-field schedules: boxes are
    claimed `group_boxes` at a time and streamed through
    `joint_infer_fields_pipelined`, so box k+1's image loading, detection
    and staging come before box k's schedule runs, and the boxes of one
    group merge into one schedule (cross-field class merging). This is the
    production replacement for run_worker's one-box-at-a-time loop — the
    reference's taskfarmer kept nodes busy with one process per box
    (contrib/nersc/infer.sl:5-30); here one process keeps one card busy
    across boxes. joint_vi only.

    load_images: BoundingBox -> [Image]. newton_config: the schedule's
    NewtonConfig (default NewtonConfig()). detect_kwargs: passed through to
    detection (thresh, boxsize, ...), or a callable of a box's images that
    returns them. on_group: optional callable(dict)
    told, after each group is saved, its boxes, its sources, the load and
    detect seconds of its boxes and its infer seconds (the wall since the
    previous group was saved, less the loads and detections run in it).
    Returns boxes completed."""
    from ..detection.detect import detect_sources
    from ..main import save_results
    from ..ops.newton import NewtonConfig
    from ..utils.config import Config
    from .common import is_production_run
    from .run import joint_infer_fields_pipelined
    from .state import detection_active_boxes

    config = config or Config()
    worker_id = _worker_id(worker_id)
    host_s = []          # per yielded group: {"load_s", "detect_s"}

    def stage(box, acc):
        """Host work for one box: load + detect + target selection."""
        t0 = time.perf_counter()
        images = load_images(box)
        t1 = time.perf_counter()
        catalog, det_boxes = detect_sources(
            images, **_detect_kwargs(detect_kwargs, images))
        acc["load_s"] += t1 - t0
        acc["detect_s"] += time.perf_counter() - t1
        active = (detection_active_boxes(catalog, det_boxes, images)
                  if catalog else None)
        targets = [i for i, ce in enumerate(catalog)
                   if box.contains(ce.pos[0], ce.pos[1])]
        return {"catalog": catalog, "images": images,
                "active_boxes": active, "target_sources": targets}

    group_order = []     # groups' boxes, in yield order
    claimed_total = [0]  # boxes handed to the pipeline (done + in flight)

    # Keep claiming until a full sweep of the task list yields nothing.
    # The generator runs interleaved with the consumer below: group k+1's
    # stage() calls run before group k's schedule.
    def groups():
        while True:
            grp, boxes_g = [], []
            acc = {"load_s": 0.0, "detect_s": 0.0}
            budget = (group_boxes if max_boxes is None else
                      min(group_boxes, max_boxes - claimed_total[0]))
            if budget <= 0:
                return
            for box in queue.boxes():
                if len(grp) >= budget:
                    break
                if queue.done(box):
                    continue
                attempt = queue.try_claim(box, worker_id)
                if attempt is None:
                    continue
                Log.info(f"worker {worker_id}: box {box_name(box)} "
                         f"(attempt {attempt})")
                try:
                    fields = stage(box, acc)
                except Exception as exc:
                    Log.exception(exc)
                    queue.release(box)
                    continue
                if not fields["catalog"] or not fields["target_sources"]:
                    # nothing to fit — an empty box is still done
                    save_results(queue.workdir, box, [])
                    continue
                grp.append(fields)
                boxes_g.append(box)
            if not grp:
                return
            group_order.append(boxes_g)
            host_s.append(acc)
            claimed_total[0] += len(boxes_g)
            yield grp

    completed = 0
    n_saved = 0    # groups fully saved (index into group_order)
    n_counted = 0  # groups whose host seconds an infer_s has had deducted
    try:
        t0 = time.perf_counter()
        for results in joint_infer_fields_pipelined(
                groups(), config=config,
                newton_config=newton_config or NewtonConfig(), seed=seed,
                device=device, dtype=dtype):
            boxes_g = group_order[n_saved]
            for box, res in zip(boxes_g, results):
                save_results(queue.workdir, box, res)
                completed += 1
                Log.info(f"worker {worker_id}: box {box_name(box)} done, "
                         f"{len(res)} sources")
            if on_group is not None:
                hosted = sum(h["load_s"] + h["detect_s"]
                             for h in host_s[n_counted:])
                on_group({"boxes": boxes_g,
                          "sources": sum(len(r) for r in results),
                          **host_s[n_saved],
                          "infer_s": time.perf_counter() - t0 - hosted})
                n_counted = len(host_s)
            n_saved += 1
            t0 = time.perf_counter()
    except Exception as exc:
        # release every claimed-but-unsaved box for retry by another worker
        for g in group_order[n_saved:]:
            for box in g:
                queue.release(box)
        if not is_production_run():
            raise
        Log.exception(exc)
    return completed


def run_worker_distributed(queue: FileWorkQueue, stage_box, save_box=None,
                           config=None, worker_id=None, max_boxes=None):
    """Queue-draining loop of one pod (init_distributed first).

    Every rank runs this loop in step: the leader (is_queue_leader) claims
    the next pending box and broadcasts its index; every rank stages the
    box with the deterministic `stage_box: BoundingBox -> (vp0s, patches,
    *extra)` and joins its fit (fit_sources_distributed, `config`); the
    leader alone saves it with `save_box(box, fit_result, *extra)`, whose
    result file marks the box done for the whole farm (fit_result None
    for a box of no sources). Followers never touch the queue (the
    reference's master-rank I/O, SDSSIO.jl:687-691). On an error the
    leader releases the box and every rank raises (a rank that did not
    fail itself at its next collective's timeout). Returns the boxes
    completed (the same on every rank)."""
    worker_id = _worker_id(worker_id)
    leader = is_queue_leader()
    completed = 0
    while max_boxes is None or completed < max_boxes:
        nxt = -1
        if leader:
            for i, box in enumerate(queue.boxes()):
                if queue.done(box):
                    continue
                if queue.try_claim(box, worker_id) is not None:
                    nxt = i
                    break
        nxt = _broadcast_index(nxt)
        if nxt < 0:
            break
        box = queue.boxes()[nxt]
        Log.info(f"pod worker {worker_id}: box {box_name(box)}")
        try:
            vp0s, patches, *extra = stage_box(box)
            res = (fit_sources_distributed(vp0s, patches, config=config)
                   if len(vp0s) else None)
            if leader and save_box is not None:
                save_box(box, res, *extra)
            completed += 1
        except Exception as exc:
            Log.exception(exc)
            if leader:
                queue.release(box)
            raise
    return completed
