"""The port's sharded fit over a process mesh (parallel/mesh.py) on the
CPU, f64: tests/test_mesh.py's star batch (3 stars on 40 x 40 px, 16 x 16
tiles, 8 refresh cycles, eig) through one pod of four Gloo ranks
(mesh.spawn_pod, one thread a rank), held to the JAX package's own
sharded fit on conftest's 8 CPU devices and to the port's fit in one
process; then, in the same pod, the joint schedule with its fits sharded
on the mesh's src axis (one_node_joint_infer, joint_infer_fields and
joint_infer_fields_pipelined with mesh=) on tests/test_mesh.py:73's
three-source scene, held to the same calls at mesh=None in this process
and to the JAX package's one_node_joint_infer(mesh=).

The JAX package is imported inside the fixtures only: the pod's ranks
import this module to find their function, and need none of it. JAX's
joint schedule on its mesh runs in a process of its own (tests/_jax_ref),
beside the pod and the references computed here."""

import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.models.patches import SkyPatch
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel import mesh, run
from celeste_jl_tpu_torch.utils.config import Config
from celeste_jl_tpu_torch.vi.optimize import fit_sources
from _jax_ref import jax_reference

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
CFG = NewtonConfig(max_iters=8)     # tests/test_mesh.py:21
POD_TIMEOUT_S = 300.0
MESHES = ((2, 2), (4, 1))
# tests/test_mesh.py:91-92's schedule
JOINT = dict(config=Config(num_joint_vi_iters=2),
             newton_config=NewtonConfig(max_iters=20), seed=42, **F64)
# every stage (a warm sweep, the probe, a polish sweep) at one refresh a
# fit, for the multi-field calls and the narrow rows: there the sharding
# of the rows, not the fit, is under test
SHORT = dict(JOINT, config=Config(
    num_joint_vi_iters=1, joint_step_refreshes=1, polish_refreshes=1,
    polish_sweeps=1, probe_refreshes=1),
    newton_config=NewtonConfig(max_iters=1, hess_every=2))
# the calls of the (2, 2) mesh and their schedules: one_node_joint_infer
# at test_mesh.py's (JOINT), held to JAX's mesh run as well
WIDE_CALLS = {"one": JOINT, "fields": SHORT, "pipelined": SHORT}
# the (4, 1) mesh's, whose src axis is wider than the scene's rows
NARROW_CALLS = {"one": SHORT}


def _joint_calls(catalog, images, calls, mesh_=None):
    """The joint entry points of `calls` ({name: schedule keywords}) on
    the scene with mesh=mesh_: "one" one_node_joint_infer, "fields"
    joint_infer_fields on two copies of the field, "pipelined"
    joint_infer_fields_pipelined on one group of those two. Returns
    {name: results}."""
    fields = [{"catalog": catalog, "images": images}] * 2
    out = {}
    for name, kw in calls.items():
        if name == "one":
            out[name] = run.one_node_joint_infer(catalog, images, mesh=mesh_,
                                                 **kw)
        elif name == "fields":
            out[name] = run.joint_infer_fields(fields, mesh=mesh_, **kw)
        else:
            out[name], = run.joint_infer_fields_pipelined([fields],
                                                          mesh=mesh_, **kw)
    return out


def _failing_joint_run(catalog, images, rank):
    """one_node_joint_infer on the (4, 1) mesh with rank 2's fits raising:
    this rank's error message and seconds to it."""
    import time

    m = mesh.make_mesh(4, 1)
    fit = mesh.fit_sources

    def broken(*a, **k):
        raise FloatingPointError("rank 2's fit")

    t0 = time.perf_counter()
    try:
        if rank == 2:
            mesh.fit_sources = broken
        run.one_node_joint_infer(catalog, images, mesh=m, **SHORT)
        err = None
    except Exception as exc:
        err = f"{type(exc).__name__}: {exc}"
    finally:
        mesh.fit_sources = fit
    return err, time.perf_counter() - t0


def _mesh_rank(vp0s, patches, catalog, images):
    """One rank of the module's pod: fit_sources_sharded on each mesh of
    MESHES, with every rank's free vectors; then a tile of 15 rows on the
    (2, 2) mesh, which must raise before any collective; then the joint
    schedule on the scene (catalog, images): WIDE_CALLS on the (2, 2)
    mesh and NARROW_CALLS on the (4, 1) one, with every rank's results,
    and a run whose fit fails on one rank."""
    torch.set_num_threads(1)
    vp = convert.vp0s(vp0s, **F64)
    p = convert.sky_patch(patches, **F64)
    out = {}
    for shape in MESHES:
        res = mesh.fit_sources_sharded(vp, p, mesh.make_mesh(*shape),
                                       config=CFG)
        frees = [None] * dist.get_world_size()
        dist.all_gather_object(frees, res.free.numpy())
        out[shape] = dict(res={k: v.numpy() for k, v in
                               res._asdict().items()}, frees=frees)
    rows15 = p._replace(**{k: getattr(p, k)[..., :15, :]
                           for k in ("pixels", "mask", "sky", "iota")})
    try:
        mesh.fit_sources_sharded(vp, rows15, mesh.make_mesh(2, 2),
                                 config=CFG)
        out["odd_rows"] = None
    except ValueError as exc:
        out["odd_rows"] = str(exc)
    rank, world = dist.get_rank(), dist.get_world_size()
    for shape, calls in (((2, 2), WIDE_CALLS), ((4, 1), NARROW_CALLS)):
        got = _joint_calls(catalog, images, calls, mesh.make_mesh(*shape))
        ranks = [None] * world
        dist.all_gather_object(ranks, got)
        out[("joint",) + shape] = ranks
    ranks = [None] * world
    dist.all_gather_object(ranks, _failing_joint_run(catalog, images, rank))
    out["failing"] = ranks
    return out


@pytest.fixture(scope="module")
def star_batch():
    """tests/test_mesh.py's star_batch: (vp0s numpy, the JAX SkyPatch)."""
    from celeste_jl_tpu.models.patches import (make_patch_for_source,
                                               stack_patches)
    from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                          sample_star)
    from celeste_jl_tpu.vi.init import generic_init_source

    images = make_blank_images(H=40, W=40)
    positions = [(14.0, 14.0), (14.0, 26.0), (26.0, 14.0)]
    ces = [sample_star(pos=p, r_flux=30.0) for p in positions]
    gen_images(images, ces, seed=7)
    patches = stack_patches([
        make_patch_for_source(images, ce.pos, radius=8, tile_size=16)
        for ce in ces])
    vp0s = np.stack([generic_init_source(ce.pos) for ce in ces])
    return np.asarray(vp0s), patches


def _jax_scene():
    """tests/test_mesh.py:73's scene, drawn by the JAX package: (JAX
    images, JAX truth)."""
    from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                          sample_galaxy, sample_star)

    images = make_blank_images(H=50, W=50, sky_nmgy=0.05,
                               nelec_per_nmgy=2000.0)
    truth = [sample_star(pos=(22.0, 22.0), r_flux=20.0),
             sample_star(pos=(25.0, 26.0), r_flux=30.0),
             sample_galaxy(pos=(30.0, 22.0), r_flux=25.0, gal_radius_px=1.0)]
    gen_images(images, truth, seed=11)
    return images, truth


def _jax_joint_on_mesh():
    """The JAX package's one_node_joint_infer on the scene at
    test_mesh.py:73's settings on a (2, 2) mesh of conftest's CPU devices:
    each source's (init_pos, vs, elbo), numpy."""
    from celeste_jl_tpu.ops.newton import NewtonConfig as JaxNewton
    from celeste_jl_tpu.parallel.mesh import make_mesh
    from celeste_jl_tpu.parallel.run import one_node_joint_infer
    from celeste_jl_tpu.utils.config import Config as JaxConfig

    images, truth = _jax_scene()
    res = one_node_joint_infer(
        truth, images, config=JaxConfig(num_joint_vi_iters=2),
        newton_config=JaxNewton(max_iters=20),
        mesh=make_mesh(n_src=2, n_pix=2), seed=42)
    return [(np.asarray(r.init_pos), np.asarray(r.vs), float(r.elbo))
            for r in res]


@pytest.fixture(scope="module")
def scene():
    """_jax_scene's (JAX images, JAX truth, the port's images, the port's
    catalog)."""
    images, truth = _jax_scene()
    return images, truth, convert.images(images), convert.catalog(truth)


@pytest.fixture(scope="module")
def pod(star_batch, scene):
    """The pod's results by mesh (a future), started once for the module
    from a thread of this process, so that the JAX references and the
    one-process schedules run while the pod fits."""
    vp0s, patches = star_batch
    numpy_patch = SkyPatch(*(np.asarray(getattr(patches, f))
                             for f in SkyPatch._fields))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(mesh.spawn_pod, 4, _mesh_rank, vp0s, numpy_patch,
                        scene[3], scene[2], device="cpu",
                        timeout_s=POD_TIMEOUT_S)


@pytest.fixture(scope="module")
def references(star_batch, scene, pod):
    """What the pod is held to, computed while it runs: the JAX package's
    fit_sources_sharded of the star batch on a (2, 2) mesh of conftest's
    CPU devices and the port's joint entry points at mesh=None
    (WIDE_CALLS and NARROW_CALLS), in this process, and
    _jax_joint_on_mesh in a process of its own."""
    from celeste_jl_tpu.ops.newton import NewtonConfig as JaxNewton
    from celeste_jl_tpu.parallel.mesh import (fit_sources_sharded,
                                              make_mesh)

    with jax_reference(_jax_joint_on_mesh) as joint:
        vp0s, patches = star_batch
        fit = fit_sources_sharded(vp0s, patches,
                                  make_mesh(n_src=2, n_pix=2),
                                  config=JaxNewton(max_iters=8))
        return {"jax_fit": {"vp": np.asarray(fit.vp),
                            "elbo": np.asarray(fit.elbo),
                            "converged": np.asarray(fit.converged)},
                "port_joint": _joint_calls(scene[3], scene[2], WIDE_CALLS),
                "port_narrow": _joint_calls(scene[3], scene[2],
                                            NARROW_CALLS),
                "jax_joint": joint.result()}


@pytest.fixture(scope="module")
def one_process(star_batch):
    """The port's fit_sources of the batch in this process."""
    vp0s, patches = star_batch
    res = fit_sources(convert.vp0s(vp0s, **F64),
                      convert.sky_patch(patches, **F64), config=CFG)
    return {k: v.numpy() for k, v in res._asdict().items()}


def _same_fit(got, want, elbo_rtol):
    """test_mesh.py's bars (:60-63): vp to rtol 1e-4 / atol 1e-6, the ELBO
    to elbo_rtol, and the same star/galaxy type."""
    np.testing.assert_allclose(got["vp"], want["vp"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["elbo"], want["elbo"], rtol=elbo_rtol)
    assert np.array_equal(got["vp"][:, 26] > 0.5, want["vp"][:, 26] > 0.5)


def test_pixel_sharded_fit_matches_the_jax_sharded_fit(references, pod):
    """The (2, 2) pod against the JAX package's fit_sources_sharded on its
    own (2, 2) mesh of CPU devices: ELBO to 1e-8 relative."""
    want = references["jax_fit"]
    got = pod.result()[(2, 2)]["res"]
    assert got["vp"].shape == (3, 44)
    _same_fit(got, want, elbo_rtol=1e-8)
    np.testing.assert_array_equal(got["converged"], want["converged"])


def test_pixel_sharded_fit_matches_one_process(pod, one_process):
    """The (2, 2) pod against the port's fit in one process (ELBO 1e-8),
    with the same converged flags; every rank holds the same free
    vectors bit for bit (the pixel ranks took the same steps)."""
    got = pod.result()[(2, 2)]
    _same_fit(got["res"], one_process, elbo_rtol=1e-8)
    np.testing.assert_array_equal(got["res"]["converged"],
                                  one_process["converged"])
    for free in got["frees"]:
        np.testing.assert_array_equal(free, got["frees"][0])


def test_source_sharded_fit_pads_a_ragged_batch(pod, one_process):
    """The (4, 1) pod on S = 3 pads a lane, returns (3, 44), and each ELBO
    is within 1e-9 of the one-process fit (test_mesh.py:51)."""
    got = pod.result()[(4, 1)]["res"]
    assert got["vp"].shape == (3, 44) and got["elbo"].shape == (3,)
    _same_fit(got, one_process, elbo_rtol=1e-9)


def test_tile_rows_must_divide_over_the_pix_axis(pod):
    assert "not divisible by pix axis 2" in pod.result()["odd_rows"]


def test_a_mesh_of_one_is_the_one_process_fit_bit_for_bit(star_batch,
                                                         one_process,
                                                         monkeypatch):
    """In a pod of one (init_distributed with no pod asked for), the (1, 1)
    mesh's fit is fit_sources' (pixel_group=None) bit for bit; a mesh
    larger than the pod is refused."""
    from celeste_jl_tpu_torch.parallel.multinode import init_distributed

    for name in ("CELESTE_COORDINATOR", "CELESTE_NUM_PROCESSES",
                 "CELESTE_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    vp0s, patches = star_batch
    vp = convert.vp0s(vp0s, **F64)
    p = convert.sky_patch(patches, **F64)
    assert not dist.is_initialized()
    try:
        assert init_distributed(device="cpu") == (0, 1)
        one = mesh.fit_sources_sharded(vp, p, mesh.make_mesh(1, 1),
                                       config=CFG)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh.make_mesh(2, 1)
    finally:
        dist.destroy_process_group()
    for k, want in one_process.items():
        np.testing.assert_array_equal(getattr(one, k).numpy(), want)


def _same_results(got, want):
    """test_torch_fused.py:162's bars: every vs within 1e-8, the ELBO
    within 1e-8 relative, the same converged flags. (On the CPU the
    sharded schedule meets them bit for bit: mesh.row_block.)"""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.init_pos, w.init_pos)
        assert np.max(np.abs(g.vs - w.vs)) < 1e-8, (g.vs, w.vs)
        assert abs(g.elbo - w.elbo) <= 1e-8 * max(1.0, abs(w.elbo))
        assert g.converged == w.converged


def _flatten(results):
    """A call's results as one list (the multi-field calls give a list a
    field)."""
    return [r for part in results for r in
            (part if isinstance(part, list) else [part])]


def _ranks_equal(ranks, call):
    """Every rank's results of `call` are rank 0's bit for bit."""
    first = _flatten(ranks[0][call])
    for other in ranks[1:]:
        for g, w in zip(_flatten(other[call]), first, strict=True):
            np.testing.assert_array_equal(g.vs, w.vs)
            assert g.elbo == w.elbo and g.converged == w.converged


@pytest.mark.parametrize("call", ["one", "fields", "pipelined"])
def test_joint_schedule_on_a_mesh_matches_one_process(pod, references, call):
    """tests/test_mesh.py::test_fused_joint_schedule_on_mesh on the port:
    each entry point's schedule with its fits sharded over the (2, 2)
    mesh's src axis (the pix ranks repeat them) against the same call at
    mesh=None, at the fused schedule's own bar; every rank holds the same
    results bit for bit. one_node_joint_infer runs test_mesh.py's
    schedule, where the lanes converge: their freezing and the
    keep-better test must agree across the ranks."""
    ranks = pod.result()[("joint", 2, 2)]
    _ranks_equal(ranks, call)
    _same_results(_flatten(ranks[0][call]),
                  _flatten(references["port_joint"][call]))


def test_joint_schedule_rows_narrower_than_the_src_axis(pod, references):
    """On the (4, 1) mesh the scene's rows (one to three lanes) are
    narrower than the src axis: some ranks fit pad lanes only. The
    results are the one-process schedule's, at the same bar, on every
    rank bit for bit."""
    ranks = pod.result()[("joint", 4, 1)]
    _ranks_equal(ranks, "one")
    _same_results(ranks[0]["one"], references["port_narrow"]["one"])


def test_joint_schedule_fit_failure_raises_on_every_rank(pod):
    """A fit that raises on rank 2 of the (4, 1) mesh raises at the same
    step on every rank (mesh.fit_row_sharded's flag), long before the
    pod's group timeout: rank 2 its own error, the others a
    RuntimeError."""
    for rank, (err, seconds) in enumerate(pod.result()["failing"]):
        want = ("FloatingPointError: rank 2's fit" if rank == 2 else
                "RuntimeError: a fit failed on another rank of the mesh")
        assert err == want, (rank, err)
        assert seconds < POD_TIMEOUT_S / 10, (rank, seconds)


def test_joint_schedule_on_a_mesh_matches_jax(scene, pod, references):
    """The pod's one_node_joint_infer on the (2, 2) mesh against the JAX
    package's one_node_joint_infer(mesh=make_mesh(2, 2)) on conftest's
    CPU devices: the same star/galaxy flags as JAX and as the truth, the
    ELBO within 1e-4 relative (test_torch_fused.py:184's bar for the
    port's schedule against JAX's). The worst vs departure is printed
    beside test_mesh.py's rtol 1e-4 / atol 1e-3."""
    truth = scene[1]
    want = references["jax_joint"]
    got = pod.result()[("joint", 2, 2)][0]["one"]
    worst = 0.0
    for g, (w_pos, w_vs, w_elbo), ce in zip(got, want, truth, strict=True):
        np.testing.assert_array_equal(g.init_pos, w_pos)
        assert (g.vs[ids.is_star[0]] > 0.5) == (w_vs[ids.is_star[0]] > 0.5)
        assert (g.vs[ids.is_star[0]] > 0.5) == ce.is_star
        assert abs(g.elbo - w_elbo) <= 1e-4 * abs(w_elbo), (g.elbo, w_elbo)
        worst = max(worst, float(np.max(
            np.abs(g.vs - w_vs) / (1e-3 + 1e-4 * np.abs(w_vs)))))
    print(f"worst vs departure from JAX's mesh run: {worst:.3g} of "
          f"test_mesh.py's atol 1e-3 + rtol 1e-4")


def test_a_mesh_of_one_is_the_one_process_schedule_bit_for_bit(
        scene, references, monkeypatch):
    """In a pod of one, one_node_joint_infer(mesh=make_mesh(1, 1)) is the
    mesh=None schedule bit for bit (its src axis has one rank, so its
    fits are the one-process fits)."""
    from celeste_jl_tpu_torch.parallel.multinode import init_distributed

    for name in ("CELESTE_COORDINATOR", "CELESTE_NUM_PROCESSES",
                 "CELESTE_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    catalog, images = scene[3], scene[2]
    want = references["port_narrow"]["one"]
    assert not dist.is_initialized()
    try:
        init_distributed(device="cpu")
        got = run.one_node_joint_infer(catalog, images,
                                       mesh=mesh.make_mesh(1, 1), **SHORT)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.vs, w.vs)
        assert g.elbo == w.elbo and g.converged == w.converged
