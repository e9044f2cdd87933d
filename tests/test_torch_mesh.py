"""The port's sharded fit over a process mesh (parallel/mesh.py) on the
CPU, f64: tests/test_mesh.py's star batch (3 stars on 40 x 40 px, 16 x 16
tiles, 8 refresh cycles, eig) through one pod of four Gloo ranks
(mesh.spawn_pod, one thread a rank), held to the JAX package's own
sharded fit on conftest's 8 CPU devices and to the port's fit in one
process.

The JAX package is imported inside the fixtures only: the pod's ranks
import this module to find their function, and need none of it."""

import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.patches import SkyPatch
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel import mesh
from celeste_jl_tpu_torch.vi.optimize import fit_sources

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
CFG = NewtonConfig(max_iters=8)     # tests/test_mesh.py:21
POD_TIMEOUT_S = 300.0
MESHES = ((2, 2), (4, 1))


def _mesh_rank(vp0s, patches):
    """One rank of the module's pod: fit_sources_sharded on each mesh of
    MESHES, with every rank's free vectors; then a tile of 15 rows on the
    (2, 2) mesh, which must raise before any collective."""
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


@pytest.fixture(scope="module")
def pod(star_batch):
    """The pod's results by mesh (a future), started once for the module
    from a thread of this process, so that the JAX reference compiles
    while the pod fits."""
    vp0s, patches = star_batch
    numpy_patch = SkyPatch(*(np.asarray(getattr(patches, f))
                             for f in SkyPatch._fields))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(mesh.spawn_pod, 4, _mesh_rank, vp0s, numpy_patch,
                        device="cpu", timeout_s=POD_TIMEOUT_S)


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


def test_pixel_sharded_fit_matches_the_jax_sharded_fit(star_batch, pod):
    """The (2, 2) pod against the JAX package's fit_sources_sharded on its
    own (2, 2) mesh of CPU devices: ELBO to 1e-8 relative."""
    from celeste_jl_tpu.ops.newton import NewtonConfig as JaxNewtonConfig
    from celeste_jl_tpu.parallel.mesh import (fit_sources_sharded,
                                              make_mesh)

    vp0s, patches = star_batch
    ref = fit_sources_sharded(vp0s, patches, make_mesh(n_src=2, n_pix=2),
                              config=JaxNewtonConfig(max_iters=8))
    want = {"vp": np.asarray(ref.vp), "elbo": np.asarray(ref.elbo)}
    got = pod.result()[(2, 2)]["res"]
    assert got["vp"].shape == (3, 44)
    _same_fit(got, want, elbo_rtol=1e-8)
    np.testing.assert_array_equal(got["converged"], np.asarray(ref.converged))


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
