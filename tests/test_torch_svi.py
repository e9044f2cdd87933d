"""The port's stochastic VI (vi/stochastic.py, parallel/run's svi schedule)
against the JAX package's, f64 on the CPU:

- the written-out Adam over the cosine-decay schedule against optax.adam
  over optax.cosine_decay_schedule on a quadratic: every iterate within
  1e-12;
- svi_maximize fed the JAX package's Bernoulli masks (its per-source
  jax.random keys): the minibatch ELBO trace within 1e-8 relative, the
  final vp and full ELBO too; and with pixel_fraction 1 (no masks);
- infer_box(method="svi", device="cpu") on tests/test_stochastic_vi.py's
  star + galaxy scene: finite, converged, the star a star and the galaxy
  a galaxy; fit_sources_svi's draws follow its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celeste_jl_tpu.models.patches import make_patch_for_source, stack_patches
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.vi import stochastic as jsvi
from celeste_jl_tpu.vi.init import generic_init_source
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.parallel.run import infer_box
from celeste_jl_tpu_torch.utils.config import Config
from celeste_jl_tpu_torch.vi import stochastic as svi

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def test_adam_and_cosine_schedule_match_optax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 6))
    A = A @ A.T + np.eye(6)
    b = rng.normal(size=6)
    cfg = svi.SVIConfig(steps=40, learning_rate=0.1, final_lr_fraction=0.02)
    schedule = optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps,
                                           alpha=cfg.final_lr_fraction)
    opt = optax.adam(schedule)
    x = jnp.asarray(rng.normal(size=6))
    state = opt.init(x)
    xt = torch.as_tensor(np.asarray(x))
    adam = svi.AdamState.init(xt)
    grad = lambda v: A @ v - b
    for t in range(cfg.steps + 5):     # past the schedule's end too
        assert abs(svi.cosine_decay_lr(cfg, t) - float(schedule(t))) <= \
            1e-15 * cfg.learning_rate
        upd, state = opt.update(grad(x), state, x)
        x = optax.apply_updates(x, upd)
        step, adam = adam.update(torch.as_tensor(A) @ xt
                                 - torch.as_tensor(b),
                                 svi.cosine_decay_lr(cfg, t))
        xt = xt + step
        np.testing.assert_allclose(xt.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def batch():
    """Two sources of tests/test_stochastic_vi.py's kind on 16 x 16 tiles:
    (JAX patches, vp0s)."""
    images = make_blank_images(H=40, W=40)
    ces = [sample_star(pos=(20.0, 20.0), r_flux=30.0),
           sample_galaxy(pos=(12.0, 27.0), r_flux=20.0, gal_radius_px=1.5)]
    gen_images(images, ces, seed=3)
    patches = stack_patches([make_patch_for_source(images, ce.pos,
                                                   radius=7, tile_size=16)
                             for ce in ces])
    return patches, np.stack([generic_init_source(ce.pos) for ce in ces])


def _jax_masks(key, S, cfg, shape):
    """The Bernoulli draws of jsvi.fit_sources_svi, (steps, S, ...)."""
    keys = jax.random.split(key, S)
    return np.stack([np.stack([
        np.asarray(jax.random.bernoulli(k, cfg.pixel_fraction, shape))
        for k in jax.random.split(keys[s], cfg.steps)]) for s in range(S)],
        axis=1)


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_svi_maximize_matches_jax_on_its_masks(batch, fraction):
    patches, vp0s = batch
    cfg = jsvi.SVIConfig(steps=60, pixel_fraction=fraction)
    key = jax.random.PRNGKey(4)
    want = jsvi.fit_sources_svi(key, vp0s, patches, config=cfg)
    masks = (torch.as_tensor(_jax_masks(key, 2, cfg,
                                        np.shape(patches.mask)[1:]))
             if fraction < 1 else None)
    got = svi.svi_maximize(torch.as_tensor(vp0s),
                           convert.sky_patch(patches, "cpu", torch.float64),
                           config=svi.SVIConfig(*cfg), masks=masks)
    trace = np.asarray(want.elbo_trace)
    assert got.elbo_trace.shape == trace.shape == (2, 60)
    np.testing.assert_allclose(got.elbo_trace.numpy(), trace, rtol=1e-8,
                               atol=0)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo),
                               rtol=1e-8, atol=0)
    np.testing.assert_allclose(got.vp.numpy(), np.asarray(want.vp),
                               rtol=1e-8, atol=1e-12)


def _scene():
    images = make_blank_images(H=50, W=50, sky_nmgy=0.05,
                               nelec_per_nmgy=2000.0)
    truth = [sample_star(pos=(16.0, 16.0), r_flux=25.0),
             sample_galaxy(pos=(34.0, 34.0), r_flux=35.0,
                           gal_radius_px=2.0)]
    gen_images(images, truth, seed=5)
    return convert.images(images)


def test_infer_box_svi_on_the_cpu():
    images = _scene()
    kw = dict(method="svi", config=Config(), thresh=6.0, boxsize=(50, 50),
              match_radius_deg=1.0, device="cpu", dtype=torch.float64)
    results = infer_box(images, **kw)
    assert len(results) == 2
    by_star = sorted(results, key=lambda r: -r.vs[ids.is_star[0]])
    assert by_star[0].vs[ids.is_star[0]] > 0.5     # the star
    assert by_star[1].vs[ids.is_star[0]] < 0.5     # the galaxy
    for r in results:
        assert np.isfinite(r.elbo) and r.converged


def test_fit_sources_svi_draws_from_its_seed(batch):
    patches, vp0s = batch
    p = convert.sky_patch(patches, "cpu", torch.float64)
    cfg = svi.SVIConfig(steps=15)
    runs = [svi.fit_sources_svi(torch.as_tensor(vp0s), p, config=cfg,
                                seed=seed) for seed in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0].vp, runs[1].vp)
    assert not torch.equal(runs[0].elbo_trace, runs[2].elbo_trace)
    assert torch.all(torch.isfinite(runs[2].elbo_trace))
