"""Process-mesh scheduling of batched source fits (port of
celeste_jl_tpu/parallel/mesh.py; ParallelRun.jl:203-369's thread
scheduler).

In torch one process drives one device, so a mesh is laid over the
ranks of a pod (parallel/multinode.init_distributed): a
torch.distributed DeviceMesh with two axes.

  * ``src`` — source-level data parallelism: each rank fits its block of
    the source batch (the analog of `Threads.@threads` over thread
    partitions, ParallelRun.jl:285-296). Source blocks end their Newton
    loops at different steps, so no collective inside the loop spans
    this axis: one all_gather at the end returns the whole FitResult.
  * ``pix`` — pixel sharding: a source's tiles are split by rows across
    the ranks of the axis and each rank's (f, g) and (f, g, H) are
    all-reduced over it (vi/optimize.fit_evaluators). Exact, because the
    ELBO is a sum over pixels; after each all-reduce every rank of the
    group holds the same bits, so all of them take the same steps and
    end with the same free vectors.

`spawn_pod` starts a pod of processes on this host and returns what its
rank 0 returned; the tests, `dryrun_multichip` and chip_smoke.py run
their pods through it.
"""

import math
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..models.patches import SkyPatch
from ..ops.newton import NewtonConfig
from ..vi.optimize import FitResult, fit_sources

SRC_AXIS = "src"
PIX_AXIS = "pix"

# the (S, B, P, P) fields of a SkyPatch, split by rows on the pix axis
_TILE_FIELDS = ("pixels", "mask", "sky", "iota")


def _mesh_device_type(device):
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_src=None, n_pix=1, device=None):
    """A (src, pix) DeviceMesh over the pod's default process group
    (init_distributed first). One process is one device, so n_src * n_pix
    must be the world size; n_src defaults to world size // n_pix. The
    pix axis runs over consecutive ranks. device: the mesh's device type;
    default "cuda" under NCCL and "cpu" under Gloo, whose groups take
    tensors on either."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a pod: call "
                           "multinode.init_distributed() first")
    world = dist.get_world_size()
    if n_src is None:
        n_src = world // n_pix
    if n_src < 1 or n_pix < 1 or n_src * n_pix != world:
        raise ValueError(f"a ({n_src}, {n_pix}) mesh needs {n_src * n_pix} "
                         f"ranks; the pod has {world}")
    return init_device_mesh(_mesh_device_type(device), (n_src, n_pix),
                            mesh_dim_names=(SRC_AXIS, PIX_AXIS))


def world_src_mesh():
    """The 1-D src mesh of every rank of the pod, over its default group
    (no new process group is formed)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(dist.group.WORLD, _mesh_device_type(None),
                                 mesh_dim_names=(SRC_AXIS,))


def _axis(mesh, name):
    """(size, this rank's index, group) of the mesh's axis `name`; an axis
    the mesh does not have is of size 1."""
    if name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(name), mesh.get_group(name)


def _pad_sources(vp0s, patches, multiple, *lanes):
    """Repeat lane 0 until the batch is a multiple of `multiple`, in vp0s,
    patches and each (S, ...) tensor of `lanes`. Returns (vp0s, patches,
    the original S, *lanes)."""
    S = vp0s.shape[0]
    reps = math.ceil(S / multiple) * multiple - S
    if reps == 0:
        return (vp0s, patches, S, *lanes)

    def pad(x):
        return torch.cat([x, x[:1].expand((reps,) + x.shape[1:])], dim=0)

    return (pad(vp0s), SkyPatch(*[pad(f) for f in patches]), S,
            *(pad(x) for x in lanes))


def _row_block(patches, pix_rank, rows):
    """Rows [pix_rank * rows, (pix_rank + 1) * rows) of every tile field
    (JAX _patch_specs: tiles split on rows, per-source fields whole)."""
    r0 = pix_rank * rows
    return patches._replace(**{
        k: getattr(patches, k)[..., r0:r0 + rows, :].contiguous()
        for k in _TILE_FIELDS})


def _shift_row_offset(patches, pix_rank, rows):
    """The row block's tiles start pix_rank * rows rows into the full
    tile: shift the tile-corner row offset so pixel coordinates stay
    exact."""
    offset = patches.offset.clone()
    offset[..., 0] += pix_rank * rows
    return patches._replace(offset=offset)


def _gather_lanes(t, group):
    """The (lanes, ...) blocks of t of every rank of `group`, in rank
    order, concatenated on lanes."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def fit_sources_sharded(vp0s, patches, mesh, include_kl=True,
                        config: NewtonConfig = NewtonConfig()):
    """Batched Newton-TR fits sharded over a (src, pix) mesh.

    vp0s: (S, 44); patches: SkyPatch with leading S axis and (B, P, P)
    tiles, the same on every rank, on the rank's device. P must be
    divisible by the pix axis's size. S is padded to a multiple of the src
    axis's size by repeating lane 0; padded lanes are dropped from the
    result. Returns the whole FitResult (leading S axis) on every rank.
    """
    n_src, src_rank, src_group = _axis(mesh, SRC_AXIS)
    n_pix, pix_rank, pix_group = _axis(mesh, PIX_AXIS)
    P = patches.pixels.shape[-2]
    if P % n_pix != 0:
        raise ValueError(f"tile size {P} not divisible by pix axis {n_pix}")
    rows = P // n_pix

    vp0s, patches, S = _pad_sources(vp0s, patches, n_src)
    block = vp0s.shape[0] // n_src
    lanes = slice(src_rank * block, (src_rank + 1) * block)
    local = _shift_row_offset(_row_block(patches.index(lanes), pix_rank,
                                         rows), pix_rank, rows)
    res = fit_sources(vp0s[lanes], local, include_kl=include_kl,
                      config=config,
                      pixel_group=pix_group if n_pix > 1 else None)
    if n_src == 1:
        return FitResult(*(f[:S] for f in res))
    return FitResult(*(_gather_lanes(f, src_group)[:S] for f in res))


def src_size(mesh):
    """The size of the mesh's src axis (1 without a mesh)."""
    return 1 if mesh is None else _axis(mesh, SRC_AXIS)[0]


def _raise_if_a_rank_failed(exc, mesh, device):
    """Tell every rank of the mesh whether any rank's fit raised (a flag
    all-reduced over src, then over pix), and raise on every rank if one
    did: the rank that failed its own exception, the others a
    RuntimeError. Without this the others would wait in the gather for
    the failed rank until the group's timeout."""
    flag = torch.tensor([0.0 if exc is None else 1.0], device=device)
    for name in (SRC_AXIS, PIX_AXIS):
        n, _, group = _axis(mesh, name)
        if n > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if exc is not None:
        raise exc
    if flag.item() > 0:
        raise RuntimeError("a fit failed on another rank of the mesh")


def row_block(W, mesh):
    """The lanes each rank fits of a W-lane row sharded over the mesh's
    src axis (fit_row_sharded): ceil(W / n_src), but never one lane of a
    wider row. torch's CPU kernels take another path for a batch of one
    (a one-matrix product rounds differently), and the fit's flat
    directions grow that to ~1e-7; with blocks of two or more a lane's
    arithmetic does not depend on its batch on the CPU, so a sharded
    schedule there is the one-process schedule bit for bit. The rule
    costs padding on the card, where a fit depends on its batch anyway: a
    row of two lanes is not split (rank 0 fits both, the other ranks
    padded copies of lane 0), and any row narrower than 2 n_src lanes
    leaves some ranks with pads only."""
    return max(-(-W // src_size(mesh)), min(W, 2))


def fit_row_sharded(vp0s, patches, bg_E, bg_V, mesh,
                    config: NewtonConfig = NewtonConfig(), plain=False):
    """The fused schedule's fit of one lane row, sharded over the mesh's
    src axis (JAX fused.py:67-103, the shard_map branch of a class step
    and of a wide pass).

    vp0s (W, 44), the lanes' patches and their neighbors' background
    bg_E / bg_V (W, B, P, P), the same on every rank, on the rank's
    device. The row is padded to n_src blocks of row_block(W) lanes by
    repeating lane 0; each rank fits its block with fit_sources, whole
    tiles and no pixel_group, and the FitResult is all-gathered over src
    (the pad lanes dropped). JAX's in_specs name only src, so the ranks
    along pix repeat the same fits. Source blocks end their Newton loops
    at different refresh cycles, so no collective runs inside a fit.
    Returns the whole row's FitResult on every rank. A fit that raises on
    any rank raises on every rank of the mesh, at this call."""
    n_src, src_rank, src_group = _axis(mesh, SRC_AXIS)
    block = row_block(vp0s.shape[0], mesh)
    vp0s, patches, W, bg_E, bg_V = _pad_sources(vp0s, patches,
                                                 n_src * block, bg_E, bg_V)
    lanes = slice(src_rank * block, (src_rank + 1) * block)
    failed = None
    try:
        res = fit_sources(vp0s[lanes], patches.index(lanes), bg_E[lanes],
                          bg_V[lanes], config=config, plain=plain)
    except Exception as exc:
        failed = exc
    _raise_if_a_rank_failed(failed, mesh, vp0s.device)
    return FitResult(*(_gather_lanes(f, src_group)[:W] for f in res))


# ---------------------------------------------------------------------------
# a pod of processes on this host
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pod_rank(rank, n_ranks, address, fn, args, device, timeout_s, out):
    """One rank of spawn_pod: join the pod, run fn(*args), post
    (rank, ok, rank 0's value or the traceback)."""
    from .multinode import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n_ranks)
    try:
        init_distributed(address, n_ranks, rank,
                         initialization_timeout=timeout_s, device=device)
        value = fn(*args)
        out.put((rank, True, value if rank == 0 else None))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_pod(n_ranks, fn, *args, device="cuda", timeout_s=600.0):
    """Run fn(*args) on every rank of a pod of n_ranks processes on this
    host (spawned; joined by init_distributed through a coordinator on a
    free localhost port, the group's timeout timeout_s) and return what
    rank 0's call returned. fn and args must pickle. device: the ranks'
    device ("cpu", or "cuda": ranks that share a card join with Gloo).
    Raises RuntimeError when a rank raises or dies, TimeoutError when the
    pod has not finished within timeout_s seconds; every rank it started
    is ended before it returns or raises."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"localhost:{_free_port()}"
    procs = [ctx.Process(target=_pod_rank, name=f"pod-rank{r}",
                         args=(r, n_ranks, address, fn, args, device,
                               timeout_s, out))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        posted, value = set(), None
        while len(posted) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"pod of {n_ranks} ranks: ranks "
                    f"{sorted(set(range(n_ranks)) - posted)} not done "
                    f"after {timeout_s:g} s")
            try:
                rank, ok, got = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in posted and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"pod rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and posted nothing")
                continue
            if not ok:
                raise RuntimeError(f"pod rank {rank} failed:\n{got}")
            posted.add(rank)
            if rank == 0:
                value = got
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        out.close()


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------

def _dryrun_rank(n_ranks, device):
    from ..synthetic import synthetic_patch_batch

    torch.set_num_threads(1)
    n_pix = 2 if n_ranks % 2 == 0 else 1
    n_src = n_ranks // n_pix
    dev = torch.device(device)
    _, vp0s, patches = synthetic_patch_batch(max(2, n_src), tile=16,
                                             dtype=np.float64, device=dev)
    mesh = make_mesh(n_src, n_pix)
    res = fit_sources_sharded(torch.as_tensor(vp0s, device=dev), patches,
                              mesh, config=NewtonConfig(max_iters=2))
    return {"mesh": (n_src, n_pix), "vp_shape": tuple(res.vp.shape),
            "elbo": res.elbo.cpu().numpy()}


def dryrun_multichip(n_ranks, device="cpu"):
    """The sharded fit over an n_ranks pod on tiny shapes (the port's
    counterpart of __graft_entry__.dryrun_multichip): a (n / 2, 2) mesh
    when n is even, else (n, 1); synthetic_patch_batch at tile 16, two
    Newton refreshes, f64. Raises unless it returns (S, 44) and finite
    ELBOs; returns rank 0's summary."""
    out = spawn_pod(n_ranks, _dryrun_rank, n_ranks, device, device=device,
                    timeout_s=300.0)
    S = max(2, out["mesh"][0])
    if out["vp_shape"] != (S, 44) or not np.all(np.isfinite(out["elbo"])):
        raise RuntimeError(f"dryrun_multichip({n_ranks}): {out}")
    return out
