"""The port's pod (parallel/multinode.py: init_distributed,
is_queue_leader, fit_sources_distributed, run_worker_distributed) on the
CPU, f64: tests/test_multihost.py's two-process pod as one pod of two
Gloo ranks (mesh.spawn_pod, one thread a rank), started once for the
module: the sharded fit against the JAX package's one-device fit_sources
and the leader-gated queue loop; then init_distributed without a pod and
against a coordinator that never answers.

The JAX package is imported inside the fixtures only: the pod's ranks
import this module to find their function, and need none of it."""

import concurrent.futures
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.io.dataset import BoundingBox
from celeste_jl_tpu_torch.models.patches import SkyPatch
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel import mesh, multinode

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
POD_TIMEOUT_S = 300.0
# the queue test's fits: what it holds is the gating, not the fit
SHORT_NEWTON = NewtonConfig(max_iters=1, hess_every=2)
POD_VARIABLES = ("CELESTE_COORDINATOR", "CELESTE_NUM_PROCESSES",
                 "CELESTE_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS")


def _pod_rank(vp0s, patches, farm):
    """One rank of tests/_multihost_driver.py's pod: fit_sources_distributed
    of the batch (the CPU's default config), then run_worker_distributed
    over two boxes, each staged as the batch's first 4 sources. Returns
    the fit and every rank's (completed, is_queue_leader)."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    vp = convert.vp0s(vp0s, **F64)
    p = convert.sky_patch(patches, **F64)
    res = multinode.fit_sources_distributed(vp, p)
    queue = multinode.FileWorkQueue(farm, boxes=multinode.split_box(
        BoundingBox(0.0, 1.0, 0.0, 1.0), 2, 1))

    def stage(box):
        return vp[:4], p.index(slice(0, 4))

    def save(box, r):
        np.savez(os.path.join(farm, f"celeste-{multinode.box_name(box)}.npz"),
                 vp=r.vp.numpy(), elbo=r.elbo.numpy())

    completed = multinode.run_worker_distributed(
        queue, stage, save_box=save, config=SHORT_NEWTON,
        worker_id=f"rank{rank}")
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (completed, multinode.is_queue_leader()))
    return dict(fit={k: v.numpy() for k, v in res._asdict().items()},
                ranks=ranks)


def _failing_rank(seconds):
    """Rank 1 raises; rank 0 waits `seconds` (past spawn_pod's timeout
    when that is shorter)."""
    import time

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(seconds)
    return "rank 0 done"


@pytest.fixture(scope="module")
def batch():
    """__graft_entry__._synthetic_batch(6, tile=16, seed=3), the pod's
    batch of tests/_multihost_driver.py, its float32 fields cast to
    float64, so that both packages fit in f64: (vp0s, SkyPatch of the JAX
    package), numpy leaves."""
    from __graft_entry__ import _synthetic_batch

    vp0s, patches = _synthetic_batch(n_sources=6, tile=16, seed=3)
    f64 = lambda a: (np.asarray(a, np.float64)
                     if np.asarray(a).dtype.kind == "f" else np.asarray(a))
    return f64(vp0s), type(patches)(*(f64(a) for a in patches))


@pytest.fixture(scope="module")
def pod(batch, tmp_path_factory):
    """(the pod's result (a future), its farm directory), started once for
    the module from a thread of this process, so that the JAX reference
    compiles while the pod fits."""
    vp0s, patches = batch
    farm = str(tmp_path_factory.mktemp("pod") / "farm")
    numpy_patch = SkyPatch(*(np.asarray(getattr(patches, f))
                             for f in SkyPatch._fields))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(mesh.spawn_pod, 2, _pod_rank, vp0s, numpy_patch,
                        farm, device="cpu", timeout_s=POD_TIMEOUT_S), farm


def test_distributed_fit_matches_the_jax_fit(batch, pod):
    """tests/test_multihost.py:92-109: the pod's fit against the JAX
    package's fit_sources in one process, vp to rtol / atol 1e-4, the ELBO
    to 1e-6, the same converged flags."""
    from celeste_jl_tpu.vi.optimize import fit_sources

    vp0s, patches = batch
    ref = fit_sources(vp0s, patches)
    fit = pod[0].result()["fit"]
    assert fit["vp"].shape == (6, 44)
    np.testing.assert_allclose(fit["vp"], np.asarray(ref.vp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(fit["elbo"], np.asarray(ref.elbo), rtol=1e-6)
    np.testing.assert_array_equal(fit["converged"], np.asarray(ref.converged))


def test_queue_gating_and_completion(pod):
    """tests/test_multihost.py:112-126: two result files, both claims by
    rank0 (the leader, the only rank that touches the queue), and both
    ranks report two boxes completed."""
    future, farm = pod
    ranks = future.result()["ranks"]
    assert ranks == [(2, True), (2, False)]
    results = [f for f in os.listdir(farm) if f.startswith("celeste-")]
    assert len(results) == 2, results
    claims = os.listdir(os.path.join(farm, "claims"))
    assert len(claims) == 2, claims
    for c in claims:
        with open(os.path.join(farm, "claims", c)) as f:
            assert json.load(f)["worker"] == "rank0"


def test_init_distributed_without_a_pod_is_a_pod_of_one(monkeypatch):
    for name in POD_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    try:
        assert multinode.init_distributed(device="cpu") == (0, 1)
        # idempotent
        assert multinode.init_distributed(device="cpu") == (0, 1)
        assert multinode.is_queue_leader()
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_a_pod_that_cannot_form_raises(monkeypatch):
    """Asked for 2 ranks against a coordinator that never answers, with a
    5 s timeout, init_distributed raises (it does not run as one process);
    a pod of 2 without a coordinator address is refused at once."""
    for name in POD_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        multinode.init_distributed(f"localhost:{port}", 2, 1,
                                   initialization_timeout=5, device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="coordinator address"):
        multinode.init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_spawn_pod_raises_when_a_rank_fails_or_time_runs_out():
    """A rank that raises fails the pod with its traceback (while rank 0
    is still busy); a pod still running at its timeout raises
    TimeoutError. Either way no rank is left running."""
    import multiprocessing
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh.spawn_pod(2, _failing_rank, 60.0, device="cpu",
                       timeout_s=POD_TIMEOUT_S)
    assert time.monotonic() - t0 < 60.0
    with pytest.raises(TimeoutError):
        mesh.spawn_pod(1, _failing_rank, 60.0, device="cpu", timeout_s=5.0)
    assert time.monotonic() - t0 < 60.0
    assert not multiprocessing.active_children()
