"""The port's box inference (parallel/, models/patches, vi/elbo, the
newton-secular TR solve) against the JAX package's, f64 on the CPU, on the
same numpy inputs; and the whole slice, infer_box, on
tests/test_infer.py's three-overlapping-sources scene.

- schedules (Cyclades batches and waves, color classes, bucket widths) on
  random conflict graphs from one default_rng seed: identical;
- detection active boxes, make_patches_batched(active_boxes=...) and
  InferenceState's radii, tiles, neighbour tables and initial vps: equal;
- source_moment_grids, _render_neighbor_bg, _elbo_values: 1e-10 relative;
- the newton-secular TR solve on random eigenbases with hard-case lanes:
  1e-10;
- infer_box(joint_vi) on the port: test_infer.py's known-answer bars, and
  against JAX's host-driven schedule (CELESTE_FUSED=0) on the same images
  and catalog: the same classifications, ELBOs within 1e-4 relative (the
  fit bar of ROADMAP; f64 ridge lanes rule out bit-equality, queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celeste_jl_tpu.detection.detect import detect_sources as jax_detect
from celeste_jl_tpu.models.patches import (
    make_patches_batched as jax_make_patches, stack_patches as jax_stack)
from celeste_jl_tpu.ops.newton import NewtonConfig as JaxNewton
from celeste_jl_tpu.ops.newton import _solve_tr_eig
from celeste_jl_tpu.parallel import packing as jpack
from celeste_jl_tpu.parallel import partition as jpart
from celeste_jl_tpu.parallel.common import (_elbo_values as jax_elbo_values,
                                            _render_neighbor_bg as jax_bg)
from celeste_jl_tpu.parallel.run import one_node_joint_infer as jax_joint_infer
from celeste_jl_tpu.parallel.state import (
    InferenceState as JaxState, detection_active_boxes as jax_boxes)
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.utils.config import Config as JaxConfig
from celeste_jl_tpu.vi.elbo import source_moment_grids as jax_grids
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.models.patches import make_patches_batched
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.ops.tr import tr_subproblem_newton
from celeste_jl_tpu_torch.parallel import packing, partition
from celeste_jl_tpu_torch.parallel.common import (BASIN_MARGIN_REL,
                                                  _elbo_values,
                                                  _render_neighbor_bg)
from celeste_jl_tpu_torch.parallel.run import (infer_box,
                                               one_node_joint_infer,
                                               one_node_single_infer)
from celeste_jl_tpu_torch.parallel.state import (InferenceState,
                                                 detection_active_boxes)
from celeste_jl_tpu_torch.utils import telemetry
from celeste_jl_tpu_torch.utils.config import Config
from celeste_jl_tpu_torch.vi.elbo import source_moment_grids

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# tests/test_infer.py's configs
JCFG = JaxConfig(num_joint_vi_iters=4)
CFG = convert.config(JCFG)
NEWTON = NewtonConfig(max_iters=30)
DETECT = dict(thresh=6.0, boxsize=(50, 50), match_radius_deg=1.0)


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


def _random_graph(rng, n=60, extent=40.0, reach=6.0):
    pos = rng.uniform(0, extent, (n, 2))
    nb = {s: [t for t in range(n) if t != s
              and np.max(np.abs(pos[s] - pos[t])) < reach] for s in range(n)}
    targets = sorted(rng.choice(n, size=n - 7, replace=False).tolist())
    tile = {s: int(rng.choice([16, 32, 64])) for s in range(n)}
    return targets, nb, tile


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedules_match_jax(seed):
    targets, nb, tile = _random_graph(np.random.default_rng(seed))
    nb_t = {s: [n for n in nb[s] if n in set(targets)] for s in targets}
    rng = lambda: np.random.default_rng(seed)
    for bs in (7, 60):
        got = partition.partition_cyclades_dynamic(targets, nb_t, bs, rng())
        want = jpart.partition_cyclades_dynamic(targets, nb_t, bs, rng())
        assert got == want
        assert ([packing._waves(c) for c in got]
                == [jpack._waves(c) for c in want])
        assert (partition.partition_cyclades(3, targets, nb_t, bs, rng())
                == jpart.partition_cyclades(3, targets, nb_t, bs, rng()))
    costs = np.random.default_rng(seed).uniform(1, 10, len(targets))
    assert (partition.choose_batch_size_auto(targets, nb_t, costs, 4,
                                             rng=rng())
            == jpart.choose_batch_size_auto(targets, nb_t, costs, 4,
                                            rng=rng()))
    for t in (None, tile):
        got = packing.color_classes(targets, nb_t, rng(), tile=t)
        assert got == jpack.color_classes(targets, nb_t, rng(), tile=t)
        tile_of = lambda s: tile[s]
        assert (packing.fused_bucket_widths(got, tile_of)
                == jpack.fused_bucket_widths(got, tile_of))
    for P in (16, 32, 64, 128):
        assert packing._dual_chunk_cap(P) == jpack._dual_chunk_cap(P)
        assert (packing._pow2_chunks(targets, cap=packing._dual_chunk_cap(P))
                == jpack._pow2_chunks(targets, cap=jpack._dual_chunk_cap(P)))


def test_active_boxes_and_patches_match_jax(scene):
    images, truth, p_images, _ = scene
    catalog, det_boxes = jax_detect(images, **DETECT)
    p_catalog = convert.catalog(catalog)
    want = jax_boxes(catalog, det_boxes, images)
    got = detection_active_boxes(p_catalog, det_boxes, p_images)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    positions = [ce.pos for ce in catalog]
    radii = np.full(len(catalog), 9.0)
    for boxes in (None, want[0]):
        for g, w in zip(make_patches_batched(p_images, positions, radii, 32,
                                             active_boxes=boxes),
                        jax_make_patches(images, positions, radii, 32,
                                         active_boxes=boxes)):
            for name, a, b in zip(w._fields, g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(NotImplementedError):
        make_patches_batched(p_images, positions, radii, 32,
                             psfs=np.zeros((len(catalog), 5, 2, 6)))


def _states(scene, active=False):
    images, truth, p_images, p_truth = scene
    if active:
        catalog, det_boxes = jax_detect(images, **DETECT)
        boxes = jax_boxes(catalog, det_boxes, images)
        return (JaxState(catalog, images, JCFG, active_boxes=boxes),
                InferenceState(convert.catalog(catalog), p_images, CFG,
                               active_boxes=convert.active_boxes(*boxes),
                               **F64))
    return (JaxState(truth, images, JCFG, target_sources=[0, 2]),
            InferenceState(p_truth, p_images, CFG, target_sources=[0, 2],
                           **F64))


@pytest.mark.parametrize("active", [False, True])
def test_inference_state_matches_jax(scene, active, tmp_path):
    js, st = _states(scene, active)
    assert st.device.type == "cpu" and st.dtype == torch.float64
    assert st.targets == js.targets
    assert st.neighbor_map == js.neighbor_map
    for name in ("radii", "tile", "nb_idx", "nb_mask", "vps", "elbos"):
        np.testing.assert_array_equal(getattr(st, name), getattr(js, name),
                                      err_msg=name)
    idx = list(range(len(st.catalog)))
    counts_j = jax_stack([js.patch(s) for s in idx])
    patches, counts = st.stacked_patches(idx)
    for name, a, b in zip(patches._fields, patches, counts_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert counts.tolist() == [int(np.asarray(js.patch(s).mask).sum())
                               for s in idx]
    # the checkpoint round trip
    st.vps[0, 3] += 1.0
    st.elbos[:] = -5.0
    st.iters[1] = 7
    path = str(tmp_path / "box.npz")
    st.save(path, cursor=4)
    fresh = InferenceState(st.catalog, st.images, CFG,
                           target_sources=st.targets,
                           active_boxes=(st.active_boxes, st.radii)
                           if active else None, **F64)
    assert fresh.restore(path) == 4
    for name in ("vps", "elbos", "converged", "iters"):
        np.testing.assert_array_equal(getattr(fresh, name),
                                      getattr(st, name))


def test_state_defaults_to_the_card_and_refuses_a_psfmap(scene):
    images, truth, p_images, p_truth = scene
    st = InferenceState(p_truth, p_images, CFG)
    assert st.device == torch.device("cuda") and st.dtype == torch.float32
    if not torch.cuda.is_available():
        # no quiet move to the CPU: staging a launch needs the card
        with pytest.raises((RuntimeError, AssertionError)):
            st.stacked_patches([0])
    p_images[0].meta = {"psfmap": object()}
    try:
        st = InferenceState(p_truth, p_images, CFG, **F64)
        with pytest.raises(NotImplementedError):
            st.build_patches([0])
    finally:
        p_images[0].meta = {}


def test_moment_grids_background_and_elbos_match_jax(scene):
    js, st = _states(scene)
    idx = [0, 1, 2, 2]
    rng = np.random.default_rng(3)
    vps = st.vps.copy()
    vps[:, ids.pos] += rng.uniform(-0.5, 0.5, (len(vps), 2))
    patches, _ = st.stacked_patches(idx)
    jp = jax_stack([js.patch(s) for s in idx])
    nb_vps = vps[st.nb_idx[idx]]
    nb_mask = st.nb_mask[idx].copy()
    nb_mask[3, 1] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)

    def close(got, want):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * scale)

    for g, w in zip(source_moment_grids(t(vps[idx]), patches),
                    jax.jit(jax.vmap(jax_grids))(jnp.asarray(vps[idx]), jp)):
        close(g, w)
    bg = _render_neighbor_bg(t(nb_vps), t(nb_mask), patches)
    jbg = jax_bg(jnp.asarray(nb_vps), jnp.asarray(nb_mask), jp)
    for g, w in zip(bg, jbg):
        close(g, w)
    assert float(bg[0].abs().max()) > 0
    for bgs, jbgs in ((bg, jbg), ((None, None), (None, None))):
        close(_elbo_values(t(vps[idx]), patches, *bgs),
              jax_elbo_values(jnp.asarray(vps[idx]), jp, *jbgs))


def _tr_cases(rng, B=64, D=42):
    w = rng.standard_normal((B, D)) * 3.0
    w[: B // 3] = np.abs(w[: B // 3]) + 0.5
    gq = rng.standard_normal((B, D))
    gq[: B // 6] *= 1e-3
    delta = 10.0 ** rng.uniform(-3, 1, B)
    # hard case: no gradient along the bottom eigenvector, a long radius
    for k in (-1, -2):
        w[k] = np.linspace(3.0, 0.5, D)
        w[k, 5] = -2.0
        gq[k, 5] = 0.0 if k == -1 else 1e-9
        delta[k] = 5.0
    return gq, w, delta


@pytest.mark.parametrize("iters", [16, 48])
def test_newton_secular_tr_matches_jax(iters):
    gq, w, delta = _tr_cases(np.random.default_rng(11))
    p, pred = tr_subproblem_newton(*(torch.as_tensor(a) for a in
                                     (gq, w, delta)), iters)
    jp, jpred = jax.vmap(lambda g, ww, d: _solve_tr_eig(
        g, ww, d, iters, secular="newton"))(jnp.asarray(gq), jnp.asarray(w),
                                           jnp.asarray(delta))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-10,
                               atol=1e-10)
    # the exact hard case steps to the boundary along the bottom vector
    assert np.linalg.norm(p.numpy()[-1]) == pytest.approx(5.0, rel=1e-8)


def test_dual_init_launch_keeps_better_basin(scene):
    """tests/test_infer.py::test_dual_init_launch_keeps_better_basin on the
    port: dispatch_group(dual_init=True) ends each source at least as high
    as both its warm-only and its generic-only fit (same background)."""
    _, _, p_images, p_truth = scene
    idx = [0, 2]

    def fit(kw):
        st = InferenceState(p_truth, p_images, CFG, **F64)
        st.finish_group(st.dispatch_group(idx, NEWTON, use_bg=True, **kw))
        return st.elbos[idx], st.vps[idx]

    e_warm, _ = fit({})
    e_fresh, _ = fit({"fresh_init": True})
    e_dual, vp_dual = fit({"dual_init": True})
    best = np.maximum(e_warm, e_fresh)
    slack = 1e-6 + BASIN_MARGIN_REL * np.abs(best)
    assert np.all(e_dual >= best - slack), (e_dual, e_warm, e_fresh)
    assert np.all(np.isfinite(vp_dual))


def test_telemetry_counts_a_single_infer_run(scene):
    _, _, p_images, p_truth = scene
    # a short budget: the counts, not the fit, are under test
    res = one_node_single_infer(p_truth, p_images, target_sources=[1, 2],
                                config=CFG,
                                newton_config=NewtonConfig(max_iters=4),
                                **F64)
    c = telemetry.counters
    # one launch of the two targets (one 32-pixel bucket), no padding
    assert len(res) == 2 and c.sources_fit == 2 and c.launches == 1
    assert dict(c.lane_widths) == {2: 1}
    assert c.newton_iters > 2 and c.pixel_visits > 0 and c.failures == 0
    assert c.utilization() < 1.0 and c.busy_s() > 0
    assert c.model_flops == 0.0


def test_cyclades_schedule_resumes_from_its_checkpoint(scene, tmp_path):
    """The reference's Cyclades batch/wave schedule (batch_size) saves a
    checkpoint after every batch; a second call with the checkpoint starts
    at its cursor, past the last batch, and returns the saved state."""
    _, _, p_images, p_truth = scene
    short = Config(num_joint_vi_iters=1, joint_step_refreshes=2)
    path = str(tmp_path / "box.npz")
    kw = dict(config=short, batch_size=2, newton_config=NEWTON,
              checkpoint_path=path, restart_final=False, **F64)
    first = one_node_joint_infer(p_truth, p_images, **kw)
    # 3 targets in batches of 2: two Cyclades batches, one cursor step each
    assert int(np.load(path)["cursor"]) == 2
    assert telemetry.counters.launches >= 2
    again = one_node_joint_infer(p_truth, p_images, **kw)
    assert telemetry.counters.launches == 0
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.vs, b.vs)
        assert a.elbo == b.elbo and np.isfinite(a.elbo)


def test_infer_box_rejects_unported_methods(scene, monkeypatch):
    _, _, p_images, p_truth = scene
    with pytest.raises(NotImplementedError, match="Slice D"):
        infer_box(p_images, method="svi", catalog=p_truth, **F64)
    with pytest.raises(ValueError):
        infer_box(p_images, method="bogus", catalog=p_truth, **F64)
    from celeste_jl_tpu_torch.mcmc import infer as mcmc_infer

    calls = []
    monkeypatch.setattr(mcmc_infer, "one_node_mcmc_infer",
                        lambda *a, **kw: calls.append(kw) or ["ok"])
    assert infer_box(p_images, method="mcmc", catalog=p_truth,
                     **F64) == ["ok"]
    assert calls == [dict(F64)]


@pytest.fixture(scope="module")
def jax_host_run(scene):
    """tests/test_infer.py's host-schedule run: JAX one_node_joint_infer on
    the true catalog with CELESTE_FUSED=0, the schedule the port has."""
    images, truth = scene[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CELESTE_FUSED", "0")
        return jax_joint_infer(truth, images, config=JCFG,
                               newton_config=JaxNewton(max_iters=30), seed=42)


def _r_flux(vp, star):
    i = 0 if star else 1
    return np.exp(vp[ids.flux_loc[i]] + 0.5 * vp[ids.flux_scale[i]])


def test_infer_box_joint_vi_matches_jax(scene, jax_host_run):
    """infer_box on the true catalog: the fit the JAX run makes (on this
    scene the capped sweep, probe and polish budgets are below both
    max_iters, so NewtonConfig() and test_infer.py's max_iters=30 run the
    same schedule). Detection's part is held to JAX by the tests above; with
    the detection footprints the JAX package's own host run calls both
    stars galaxies, so the type bar is a true-catalog bar."""
    _, truth, p_images, p_truth = scene
    results = infer_box(p_images, method="joint_vi", catalog=p_truth,
                        config=CFG, **F64)
    # tests/test_infer.py's known answers
    assert len(results) == 3
    for res, ce in zip(results, truth):
        flux = _r_flux(res.vs, ce.is_star)
        truth_flux = (ce.star_fluxes if ce.is_star else ce.gal_fluxes)[2]
        assert abs(flux - truth_flux) / truth_flux < 0.15, (flux, truth_flux)
        assert (res.vs[ids.is_star[0]] > 0.5) == ce.is_star
        assert np.isfinite(res.elbo)
        assert not res.is_sky_bad
    # against the JAX package's host-driven schedule
    for g, w in zip(results, jax_host_run):
        np.testing.assert_array_equal(g.init_pos, w.init_pos)
        assert (g.vs[ids.is_star[0]] > 0.5) == (w.vs[ids.is_star[0]] > 0.5)
        assert abs(g.elbo - w.elbo) <= 1e-4 * abs(w.elbo), (g.elbo, w.elbo)
        assert g.is_sky_bad == w.is_sky_bad
