"""The port's fused joint schedule (parallel/fused.py,
packing.fused_color_classes, utils/flops.py) against the JAX package's,
f64 on the CPU, on the same numpy inputs:

- fused_color_classes and its cost model on random conflict graphs, with
  and without mixed tile maps: identical;
- the analytic FLOP model: identical;
- within the port, the fused schedule over the host schedule's classes
  (fused=False) against the host-driven loop (which a checkpoint_path
  selects) on tests/test_infer.py's three-overlapping scene:
  tests/test_infer.py's bars (every vs within 1e-8, ELBO within 1e-8
  relative, the same converged flags);
- the port's default against the JAX package's default (CELESTE_FUSED
  unset) on that scene: the same classes and classifications, ELBOs within
  1e-4 relative, the same fit count, and FLOPs, serial depth and busy time
  counted.

joint_infer_fields and its pipeline are held in
tests/test_torch_multifield.py.
"""

import numpy as np
import pytest
import torch

from celeste_jl_tpu.parallel import packing as jpack
from celeste_jl_tpu.parallel import run as jrun
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.utils import flops as jflops
from celeste_jl_tpu.utils import telemetry as jtelemetry
from celeste_jl_tpu.utils.config import Config as JaxConfig
from celeste_jl_tpu.ops.newton import NewtonConfig as JaxNewton
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel import packing, run
from celeste_jl_tpu_torch.parallel.run import one_node_joint_infer
from celeste_jl_tpu_torch.utils import flops, telemetry
from celeste_jl_tpu_torch.utils.config import Config

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# tests/test_infer.py's configs
JCFG = JaxConfig(num_joint_vi_iters=4)
CFG = convert.config(JCFG)
NEWTON = NewtonConfig(max_iters=30)
# every stage of the joint schedule at two refreshes a fit
SHORT = Config(num_joint_vi_iters=2, joint_step_refreshes=2,
               polish_refreshes=2, polish_sweeps=1, probe_refreshes=2)
SHORT_NEWTON = NewtonConfig(max_iters=12)


def _random_graph(rng, n=60, extent=40.0, reach=6.0):
    pos = rng.uniform(0, extent, (n, 2))
    nb = {s: [t for t in range(n) if t != s
              and np.max(np.abs(pos[s] - pos[t])) < reach] for s in range(n)}
    targets = sorted(rng.choice(n, size=n - 7, replace=False).tolist())
    tile = {s: int(rng.choice([16, 32, 64])) for s in range(n)}
    return targets, nb, tile


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_classes_match_jax(seed):
    targets, nb, tile = _random_graph(np.random.default_rng(seed))
    nb_t = {s: [n for n in nb[s] if n in set(targets)] for s in targets}
    # the isolated targets are split out before the packer, as run.py does
    cons = [s for s in targets if nb_t[s]]
    rng = lambda: np.random.default_rng(seed)
    for t in (None, tile):
        got = packing.fused_color_classes(cons, nb_t, rng(), tile=t)
        assert got == jpack.fused_color_classes(cons, nb_t, rng(), tile=t)
        assert sorted(sum(got, [])) == cons
        for cls in got:
            assert not any(n in cls for s in cls for n in nb_t[s])
    caps = {16: 2, 32: 4, 64: 1}
    assert (packing._try_color_capped(cons, nb_t, 7, caps, tile.get, rng())
            == jpack._try_color_capped(cons, nb_t, 7, caps, tile.get, rng()))
    for P in (0, 1, 16, 32, 64, 128):
        assert packing._lane_step_cost(P) == jpack._lane_step_cost(P)


def test_flop_model_matches_jax():
    rng = np.random.default_rng(5)
    iters = rng.integers(0, 60, 40)
    f_calls = iters + 1
    for P in (16, 32, 64, 128):
        for B in (1, 5):
            assert (flops.fit_flop_components_analytic(P, B)
                    == jflops.fit_flop_components_analytic(P, B))
            for h in (1, 6):
                assert (flops.fit_flops(iters, f_calls, P, B, h)
                        == jflops.fit_flops(iters, f_calls, P, B, h))
    assert flops._TR_STEP_FLOPS == jflops._TR_STEP_FLOPS
    # no peak on the CPU: no MFU
    assert flops.peak_flops("cpu") is None
    assert flops.mfu(1e9, 2.0, "cpu") == (5e8, None)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),   # the SXM card
    ("NVIDIA H100 PCIe", None),          # lower peaks, not listed
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_flops_is_keyed_on_the_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert flops.peak_flops("cuda") == peak
    assert flops.mfu(2e12, 2.0, "cuda") == (
        1e12, 1e12 / peak if peak else None)


def _three_overlapping():
    """tests/test_infer.py's scene, drawn by the JAX package: (JAX images,
    JAX truth, the port's images, the port's truth)."""
    images = make_blank_images(H=50, W=50, sky_nmgy=0.05,
                               nelec_per_nmgy=2000.0)
    truth = [sample_star(pos=(22.0, 22.0), r_flux=20.0),
             sample_star(pos=(25.0, 26.0), r_flux=30.0),
             sample_galaxy(pos=(30.0, 22.0), r_flux=25.0, gal_radius_px=1.0)]
    gen_images(images, truth, seed=11)
    return images, truth, convert.images(images), convert.catalog(truth)


@pytest.fixture(scope="module")
def scene():
    return _three_overlapping()


def _spy_classes(mp, module):
    """Record every fused_color_classes result of `module`'s schedules."""
    seen = []
    packer = module.fused_color_classes

    def spy(*a, **k):
        seen.append(packer(*a, **k))
        return seen[-1]

    mp.setattr(module, "fused_color_classes", spy)
    return seen


@pytest.fixture(scope="module")
def jax_default_run(scene):
    """JAX one_node_joint_infer's default (the fused schedule) on the
    scene: (results, its classes, its fit count)."""
    images, truth = scene[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CELESTE_FUSED", raising=False)
        mp.delenv("CELESTE_FUSED_PACK", raising=False)
        seen = _spy_classes(mp, jrun)
        res = jrun.one_node_joint_infer(truth, images, config=JCFG,
                                        newton_config=JaxNewton(max_iters=30),
                                        seed=42)
        return res, seen, jtelemetry.counters.sources_fit


def test_fused_schedule_matches_host_schedule(scene, tmp_path):
    """tests/test_infer.py::test_fused_schedule_matches_host_schedule on
    the port: the fused schedule over the host schedule's classes
    (fused=False) reproduces the host-driven loop (the same backgrounds,
    acceptance and update order), which a checkpoint_path selects. The
    schedule keeps its every stage (two warm sweeps, the probe, a polish
    sweep) at two refreshes a fit (SHORT): the bookkeeping, not the fit,
    is under test."""
    _, _, p_images, p_truth = scene
    kw = dict(config=SHORT, newton_config=SHORT_NEWTON, seed=42, **F64)
    res_fused = one_node_joint_infer(p_truth, p_images, fused=False, **kw)
    assert telemetry.counters.serial_steps > 0    # the fused path ran
    res_host = one_node_joint_infer(
        p_truth, p_images, fused=False,
        checkpoint_path=str(tmp_path / "joint.npz"), **kw)
    assert telemetry.counters.serial_steps == 0   # the host loop ran
    for rf, rh in zip(res_fused, res_host):
        assert np.max(np.abs(rf.vs - rh.vs)) < 1e-8, (rf.vs, rh.vs)
        assert abs(rf.elbo - rh.elbo) <= 1e-8 * max(1.0, abs(rh.elbo))
        assert rf.converged == rh.converged


def test_default_schedule_matches_jax_default(scene, jax_default_run):
    """The port's default joint schedule (fused, fused_color_classes)
    against the JAX package's default on the scene; the telemetry counts
    the schedule's FLOPs, serial depth and busy time
    (tests/test_infer.py::test_fused_joint_flop_telemetry)."""
    _, _, p_images, p_truth = scene
    want, want_classes, want_fits = jax_default_run
    with pytest.MonkeyPatch.context() as mp:
        seen = _spy_classes(mp, run)
        got = one_node_joint_infer(p_truth, p_images, config=CFG,
                                   newton_config=NEWTON, seed=42, **F64)
    assert seen == want_classes and len(seen) == 1
    c = telemetry.counters
    assert c.sources_fit == want_fits
    assert c.model_flops > 0 and c.serial_steps > 0 and c.busy_s() > 0
    assert c.failures == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.init_pos, w.init_pos)
        assert (g.vs[ids.is_star[0]] > 0.5) == (w.vs[ids.is_star[0]] > 0.5)
        assert abs(g.elbo - w.elbo) <= 1e-4 * abs(w.elbo), (g.elbo, w.elbo)
