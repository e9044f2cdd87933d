"""The port's box farm on one card (parallel/multinode.py, the worker CLI
celeste_jl_tpu_torch.worker), f64 on the CPU: tests/test_multinode.py's
queue cases on the port's queue; run_worker_pipelined saving, bit for bit,
what joint_infer_fields_pipelined returns on the same groups (on the JAX
package's detections); the CLI on the SDSS fixture field."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from celeste_jl_tpu.detection.detect import detect_sources as jax_detect
from celeste_jl_tpu.io.dataset import BoundingBox as JaxBox
from celeste_jl_tpu.parallel import multinode as jmn
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu_torch import convert, worker
from celeste_jl_tpu_torch.detection.detect import detect_sources
from celeste_jl_tpu_torch.io.dataset import BoundingBox
from celeste_jl_tpu_torch.main import load_results
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel.multinode import (FileWorkQueue, box_name,
                                                     run_worker,
                                                     run_worker_pipelined,
                                                     split_box)
from celeste_jl_tpu_torch.parallel.run import joint_infer_fields_pipelined
from celeste_jl_tpu_torch.parallel.state import (OptimizedSource,
                                                 detection_active_boxes)
from celeste_jl_tpu_torch.utils.config import Config
from sdss_fixtures import make_sdss_field

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# a schedule cut to a refresh a step: what the tests that take it hold is
# the farm's bookkeeping, not the fit
SHORT = Config(min_radius_pix=8.0, num_joint_vi_iters=1,
               joint_step_refreshes=1, polish_refreshes=1, polish_sweeps=1,
               probe_refreshes=1)
SHORT_NEWTON = NewtonConfig(max_iters=1, hess_every=2)


def _fake_result():
    return OptimizedSource(init_pos=np.zeros(2), vs=np.zeros(44),
                           elbo=-1.0, converged=True, is_sky_bad=False)


def test_split_box_and_box_name_match_jax():
    box = BoundingBox(0.0, 1.0, 10.0, 12.0)
    subs = split_box(box, 2, 4)
    want = jmn.split_box(JaxBox(0.0, 1.0, 10.0, 12.0), 2, 4)
    assert [(b.ramin, b.ramax, b.decmin, b.decmax) for b in subs] == [
        (b.ramin, b.ramax, b.decmin, b.decmax) for b in want]
    areas = sum((b.ramax - b.ramin) * (b.decmax - b.decmin) for b in subs)
    assert areas == pytest.approx(2.0)
    b = BoundingBox(12.3456, 12.5, -1.25, -1.0)
    assert box_name(b) == "12.3456-12.5000--1.2500--1.0000"
    assert box_name(b) == jmn.box_name(JaxBox(12.3456, 12.5, -1.25, -1.0))


def test_claim_is_exclusive_and_the_jax_queue_reads_it(tmp_path):
    boxes = split_box(BoundingBox(0, 1, 0, 1), 2, 1)
    q = FileWorkQueue(str(tmp_path), boxes)
    assert q.try_claim(boxes[0], "w1") == 1
    assert q.try_claim(boxes[0], "w2") is None      # already claimed
    # the same directory is the JAX package's queue too
    jq = jmn.FileWorkQueue(str(tmp_path))
    assert [(b.ramin, b.ramax) for b in jq.boxes()] == [
        (b.ramin, b.ramax) for b in boxes]
    assert jq.try_claim(jq.boxes()[0], "w3") is None
    assert q.try_claim(boxes[1], "w2") == 1


def test_worker_completes_all_and_resumes(tmp_path):
    boxes = split_box(BoundingBox(0, 1, 0, 1), 2, 2)
    q = FileWorkQueue(str(tmp_path), boxes)
    done = run_worker(q, load_images=lambda b: [],
                      infer=lambda images, box: [_fake_result()])
    assert done == 4 and q.pending() == []
    assert run_worker(q, load_images=lambda b: [],
                      infer=lambda images, box: [_fake_result()]) == 0


def test_two_workers_share_the_queue(tmp_path):
    boxes = split_box(BoundingBox(0, 1, 0, 1), 3, 1)
    q1 = FileWorkQueue(str(tmp_path), boxes)
    q2 = FileWorkQueue(str(tmp_path))          # second worker, same dir
    n1 = run_worker(q1, load_images=lambda b: [],
                    infer=lambda i, b: [_fake_result()], max_boxes=1)
    n2 = run_worker(q2, load_images=lambda b: [],
                    infer=lambda i, b: [_fake_result()])
    assert n1 == 1 and n2 == 2 and q1.pending() == []


def test_failed_box_is_retried_then_abandoned(tmp_path):
    boxes = split_box(BoundingBox(0, 1, 0, 1), 1, 1)
    q = FileWorkQueue(str(tmp_path), boxes, max_attempts=2)
    calls = []

    def failing_infer(images, box):
        calls.append(1)
        raise RuntimeError("bad box")

    assert run_worker(q, load_images=lambda b: [], infer=failing_infer) == 0
    assert len(calls) == 2                      # retried max_attempts times
    assert q.try_claim(boxes[0], "w") is None   # exhausted
    assert len(q.pending()) == 1                # surfaced as not-done


def test_failure_then_success(tmp_path):
    boxes = split_box(BoundingBox(0, 1, 0, 1), 1, 1)
    q = FileWorkQueue(str(tmp_path), boxes, max_attempts=3)
    state = {"n": 0}

    def flaky_infer(images, box):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient")
        return [_fake_result()]

    assert run_worker(q, load_images=lambda b: [], infer=flaky_infer) == 1
    assert q.done(boxes[0])


def _strip_fields():
    """tests/test_multinode.py's three boxes: RA strips 16 px wide of one
    48 x 48 identity-WCS box, each its own field (drawn by the JAX
    package) with a star and a galaxy inside the strip."""
    boxes = split_box(BoundingBox(0.0, 48.0, 0.0, 48.0), 3, 1)
    fields = {}
    for i, b in enumerate(boxes):
        cx = 8.0 + 16.0 * i
        images = make_blank_images(H=48, W=48, sky_nmgy=0.05,
                                   nelec_per_nmgy=2000.0)
        truth = [sample_star(pos=(cx - 4.0, 14.0), r_flux=25.0),
                 sample_galaxy(pos=(cx + 4.0, 34.0), r_flux=35.0,
                               gal_radius_px=2.0)]
        gen_images(images, truth, seed=7 + i)
        fields[box_name(b)] = images
    return boxes, fields


DETECT = dict(thresh=6.0, boxsize=(48, 48), match_radius_deg=1.0)


def test_pipelined_worker_saves_what_the_pipeline_returns(tmp_path):
    """run_worker_pipelined over the three boxes, two a group, saves each
    box's results bit for bit as joint_infer_fields_pipelined gives them
    on the same groups (each box detected, its targets the sources inside
    it; the JAX package's detections); then resumes to nothing."""
    boxes, fields = _strip_fields()
    load = lambda b: convert.images(fields[box_name(b)])
    q = FileWorkQueue(str(tmp_path), boxes)
    groups_seen = []
    kw = dict(config=SHORT, newton_config=SHORT_NEWTON, **F64)
    done = run_worker_pipelined(q, load_images=load, group_boxes=2,
                                detect_kwargs=DETECT,
                                on_group=groups_seen.append, **kw)
    assert done == 3 and q.pending() == []
    assert [len(g["boxes"]) for g in groups_seen] == [2, 1]
    assert all(g["infer_s"] > 0 and g["detect_s"] > 0 for g in groups_seen)

    def field(b):
        images = load(b)
        catalog, det = detect_sources(images, **DETECT)
        jcat, _ = jax_detect(fields[box_name(b)], **DETECT)
        np.testing.assert_array_equal([c.pos for c in catalog],
                                      [c.pos for c in jcat])
        return {"catalog": catalog, "images": images,
                "active_boxes": detection_active_boxes(catalog, det, images),
                "target_sources": [i for i, ce in enumerate(catalog)
                                   if b.contains(*ce.pos)]}

    want = [r for res in joint_infer_fields_pipelined(
        [[field(b) for b in boxes[:2]], [field(boxes[2])]], **kw)
        for r in res]
    for b, w in zip(boxes, want):
        got = load_results(q._result_file(b))
        assert len(got) == len(w) == 2
        for g, x in zip(got, w):
            np.testing.assert_array_equal(g.vs, x.vs)
            np.testing.assert_array_equal(g.init_pos, x.init_pos)
            assert g.elbo == x.elbo and g.converged == x.converged
    assert run_worker_pipelined(q, load_images=load, **kw) == 0


def test_pipelined_failure_releases_the_group(tmp_path, monkeypatch):
    """A schedule that raises releases every claimed-but-unsaved box for
    another worker, and propagates outside production."""
    from celeste_jl_tpu_torch.parallel import run

    boxes, fields = _strip_fields()
    q = FileWorkQueue(str(tmp_path), boxes, stale_s=3600.0)

    def broken(*a, **k):
        raise RuntimeError("device fault")
        yield

    monkeypatch.setattr(run, "joint_infer_fields_pipelined", broken)
    monkeypatch.delenv("CELESTE_PROD", raising=False)
    with pytest.raises(RuntimeError, match="device fault"):
        run_worker_pipelined(q, load_images=lambda b: convert.images(
            fields[box_name(b)]), detect_kwargs=DETECT, **F64)
    assert q.pending() == boxes
    assert all(q.try_claim(b, "other") == 1 for b in boxes)


def _worker(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = worker.main(argv, config=SHORT, newton_config=SHORT_NEWTON,
                         device="cpu")
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sdss_field(tmp_path_factory):
    """tests/sdss_fixtures' field written once: (its basedir, the truth,
    the WCS)."""
    base = tmp_path_factory.mktemp("sdss")
    _, truth, wcs = make_sdss_field(base)
    return base, truth, wcs


@pytest.mark.parametrize("pipelined", [True, False])
def test_worker_cli_on_the_sdss_fixture(tmp_path, monkeypatch, sdss_field,
                                        pipelined):
    """The worker CLI over tests/sdss_fixtures' field, split 2 x 1 for the
    pipelined joint_vi loop and left whole for --no-pipeline with svi cut
    to 50 steps and the PSF fits (the field-center and the per-source
    ones, held to JAX in tests/test_torch_{io,psf_fit}.py) to 10 refresh
    cycles (the loop is tests/test_multinode.py's, above): every box
    saved, each true source found once across the boxes' files, within 1
    px, the summary line printed; a rerun completes nothing."""
    from celeste_jl_tpu_torch.models import psf_fit
    from celeste_jl_tpu_torch.parallel import run
    from celeste_jl_tpu_torch.vi.stochastic import SVIConfig

    monkeypatch.setattr(run, "SVIConfig", lambda: SVIConfig(steps=50))
    fit_psf = psf_fit._fit
    monkeypatch.setattr(psf_fit, "_fit", lambda stamps, K, config, plain:
                        fit_psf(stamps, K, config._replace(max_iters=10),
                                plain))
    base, truth, wcs = sdss_field
    lo, hi = wcs.pix_to_world([10.0, 10.0]), wcs.pix_to_world([90.0, 60.0])
    box = (min(lo[0], hi[0]), max(lo[0], hi[0]), min(lo[1], hi[1]),
           max(lo[1], hi[1]))
    argv = ["--workdir", str(tmp_path / "work"), "--basedir", str(base),
            "--box", ",".join(repr(float(v)) for v in box), "--grid",
            "2x1" if pipelined else "1x1", "--detect-thresh", "8"]
    if not pipelined:
        argv += ["--no-pipeline", "--method", "svi"]
    rc, summary = _worker(argv)
    n_boxes = 2 if pipelined else 1
    assert rc == 0 and summary["boxes"] == summary["boxes_done"] == n_boxes
    assert summary["pending"] == 0
    assert len(summary["groups"]) == (1 if pipelined else 0)
    # on the CPU no kernel launches, K3 at no D
    assert summary["tr_launches_by_dim"] == {}
    assert summary["kernel_launches"] == {"refresh": 0, "jacobi_sweep": 0,
                                          "tr_subproblem": 0}
    q = FileWorkQueue(str(tmp_path / "work"))
    saved = [wcs.world_to_pix(r.init_pos) for b in q.boxes()
             for r in load_results(q._result_file(b))]
    assert summary["sources_in_results"] == len(saved) == len(truth)
    for t in truth:
        d = [np.linalg.norm(p - wcs.world_to_pix(t.pos)) for p in saved]
        assert sum(x < 1.0 for x in d) == 1, d
    rc, again = _worker(argv)
    assert rc == 0 and again["boxes_done"] == 0


def test_distributed_worker_cli_on_the_sdss_fixture(tmp_path, monkeypatch,
                                                    capfd, sdss_field):
    """The worker CLI with --distributed on a pod of two Gloo ranks
    (parallel/mesh.spawn_pod) over tests/sdss_fixtures' field split 2 x 1:
    every box saved by rank 0; each target (a detection inside its box)
    saved once, its init_pos the catalog position (not the fitted vp[:2])
    and is_sky_bad run.bad_sky's; each true source found once within 1
    px; both ranks print the summary line with their rank, the pod's
    size and every rank's launches."""
    import functools

    from celeste_jl_tpu_torch.io.sdss import SDSSDataSet
    from celeste_jl_tpu_torch.parallel.mesh import spawn_pod
    from celeste_jl_tpu_torch.parallel.run import bad_sky

    base, truth, wcs = sdss_field
    lo, hi = wcs.pix_to_world([10.0, 10.0]), wcs.pix_to_world([90.0, 60.0])
    box = (min(lo[0], hi[0]), max(lo[0], hi[0]), min(lo[1], hi[1]),
           max(lo[1], hi[1]))
    workdir = str(tmp_path / "work")
    argv = ["--workdir", workdir, "--basedir", str(base), "--box",
            ",".join(repr(float(v)) for v in box), "--grid", "2x1",
            "--detect-thresh", "8", "--distributed"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # one thread a rank
    rank0 = functools.partial(worker.main, config=SHORT,
                              newton_config=SHORT_NEWTON, device="cpu")
    assert spawn_pod(2, rank0, argv, device="cpu", timeout_s=300.0) == 0
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith("{")]
    assert sorted(x["rank"] for x in lines) == [0, 1]
    for x in lines:
        assert x["world_size"] == 2 and x["boxes_done"] == 2
        assert x["pending"] == 0 and x["sources_in_results"] == len(truth)
        assert x["kernel_launches_by_rank"] == [
            {"refresh": 0, "jacobi_sweep": 0, "tr_subproblem": 0}] * 2

    q = FileWorkQueue(workdir)
    dataset = SDSSDataSet(str(base), device="cpu")
    saved = []
    for b in q.boxes():
        images = dataset.load_images(b)
        catalog, _ = detect_sources(images, thresh=8.0, boxsize=(
            min(256, images[0].H), min(256, images[0].W)))
        targets = [ce for ce in catalog if b.contains(*ce.pos)]
        results = load_results(q._result_file(b))
        assert len(results) == len(targets) > 0
        for r, ce in zip(results, targets):
            np.testing.assert_array_equal(r.init_pos, ce.pos)
            assert not np.array_equal(r.init_pos, r.vs[:2])
            assert r.is_sky_bad == bad_sky(ce, images)
            saved.append(wcs.world_to_pix(r.init_pos))
    for t in truth:
        d = [np.linalg.norm(p - wcs.world_to_pix(t.pos)) for p in saved]
        assert sum(x < 1.0 for x in d) == 1, d
