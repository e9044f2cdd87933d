"""grad_mode="analytic" of the port (vi/optimize.py, models/mixture_derivs.py)
against the JAX package's, in float64 on the CPU:

- the mixture engine (mixture_values, mixture_value_jac_hess,
  mixture_grad_contract, band_shape_derivs) and the XLA refresh blocks
  (_band_lik_terms) to 1e-10 relative;
- _analytic_lik_value_grad on tests/test_analytic_grad.py's three cases
  against JAX's and against the port's own autograd through the render:
  f to 1e-12, the gradient scaled by its largest entry to 1e-9;
- a 4-lane fit with grad_mode="analytic" against "ad": the same
  classifications and ELBOs within 1e-6 relative
  (tests/test_analytic_grad.py:77).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from celeste_jl_tpu.models import mixture_derivs as jmd
from celeste_jl_tpu.models.patches import make_patch_for_source, stack_patches
from celeste_jl_tpu.ops import bijectors as jb
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.vi import optimize as jo
from celeste_jl_tpu.vi.init import catalog_init_source
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models import mixture_derivs as tmd
from celeste_jl_tpu_torch.models.patches import pixel_coord_grids
from celeste_jl_tpu_torch.ops import bijectors as tb
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.vi import optimize as to
from celeste_jl_tpu_torch.vi.elbo import elbo_likelihood

F64 = torch.float64
IS_STAR = 26
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _close(got, want, rtol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1.0),
                               err_msg=name)


def _band_inputs(seed=4, n_sources=2, tile=16):
    """The band functions' arguments (leading (S, B) axes) at the enforced
    starting point of a synthetic batch, as torch and as numpy."""
    vp0s, patches = _synthetic_batch(n_sources=n_sources, tile=tile,
                                     seed=seed)
    tp = convert.sky_patch(patches, "cpu", F64)
    t = torch.tensor(np.asarray(vp0s, np.float64))
    bounds = to._make_bounds(t[:, 0:2])
    free = tb.to_free(tb.enforce(t, bounds), bounds)
    rng = np.random.default_rng(seed)
    bg = torch.tensor(rng.uniform(0.0, 0.05, size=tp.sky.shape))
    args, _ = to._band_args(free, bounds, tp, bg, 0.2 * bg)
    return args, [a.contiguous().numpy() for a in args[:-1]]


def test_mixture_engine_matches_jax():
    """Per (source, band): values, jacobians and weight-contracted
    Hessians of the star and galaxy mixtures, and band_shape_derivs."""
    args, _ = _band_inputs()
    theta6, psf, jac, wc, pc, off = (args[0],) + args[3:8]
    P = args[-1]
    x1g, x2g = pixel_coord_grids(off, P, F64)
    x1, x2 = x1g.flatten(-2), x2g.flatten(-2)
    rng = np.random.default_rng(9)
    w0 = torch.tensor(rng.normal(size=x1.shape))
    w1 = torch.tensor(rng.normal(size=x1.shape))
    got = tmd.band_shape_derivs(theta6, psf, jac, wc, pc, x1, x2, w0, w1)
    sm = tmd.star_mixture(theta6, psf, jac, wc, pc)
    gm = tmd.galaxy_mixture(theta6, psf, jac, wc, pc)
    got_more = (tmd.mixture_values(x1, x2, *sm),
                tmd.mixture_values(x1, x2, *gm),
                tmd.mixture_grad_contract(x1, x2, *sm, w0),
                tmd.mixture_grad_contract(x1, x2, *gm, w1))

    def one(th, ps, jc, w, p, a1, a2, v0, v1):
        s = jmd.star_mixture(th, ps, jc, w, p)
        g = jmd.galaxy_mixture(th, ps, jc, w, p)
        return (jmd.band_shape_derivs(th, ps, jc, w, p, a1, a2, v0, v1),
                (jmd.mixture_values(a1, a2, *s),
                 jmd.mixture_values(a1, a2, *g),
                 jmd.mixture_grad_contract(a1, a2, *s, v0),
                 jmd.mixture_grad_contract(a1, a2, *g, v1)))

    j = lambda a: jnp.asarray(a.contiguous().numpy())
    want, want_more = jax.jit(jax.vmap(jax.vmap(one)))(
        *(j(a) for a in (theta6, psf, jac, wc, pc, x1, x2, w0, w1)))
    names = ("fs0", "fs1", "J0", "J1", "Hc0", "Hc1", "values star",
             "values galaxy", "grad star", "grad galaxy")
    for name, a, b in zip(names, tuple(got) + got_more,
                          tuple(want) + tuple(want_more)):
        _close(a, b, 1e-10, name)


def test_band_lik_terms_and_grad_match_jax():
    """The XLA refresh's blocks and the (f, g) evaluator's band terms, with
    neighbor background images."""
    args, np_args = _band_inputs(seed=5)
    P = args[-1]
    j = [jnp.asarray(a) for a in np_args]
    names = ("lik", "g_theta", "g_C", "H_tt", "H_tC", "H_CC")
    for fn, jfn in ((to._band_lik_terms, jo._band_lik_terms),
                    (to._band_lik_grad, jo._band_lik_grad)):
        got = fn(*args)
        want = jax.jit(jax.vmap(jax.vmap(partial(jfn, P=P))))(*j)
        for name, a, b in zip(names, got, want):
            _close(a, b, 1e-10, f"{fn.__name__} {name}")


def _setup(ce, seed=11):
    images = make_blank_images(H=40, W=40)
    gen_images(images, [ce], seed=seed)
    patch = make_patch_for_source(images, ce.pos, radius=10, tile_size=32)
    return stack_patches([patch])


@pytest.mark.parametrize("make_ce,with_bg", [
    (lambda: sample_star(pos=(20.0, 20.0), r_flux=40.0), False),
    (lambda: sample_galaxy(pos=(20.0, 19.0), r_flux=25.0,
                           gal_radius_px=2.5), False),
    (lambda: sample_star(pos=(20.0, 20.0), r_flux=40.0), True),
])
def test_analytic_value_grad_matches_jax_and_autograd(make_ce, with_bg):
    """tests/test_analytic_grad.py's cases, three random points each."""
    ce = make_ce()
    patches = _setup(ce)
    jpatch = jax.tree.map(lambda x: x[0], patches)
    tp = convert.sky_patch(patches, "cpu", F64)
    jbg = (0.3 * jpatch.sky, 0.05 * jpatch.sky) if with_bg else (None, None)
    tbg = (0.3 * tp.sky, 0.05 * tp.sky) if with_bg else (None, None)

    vp0 = np.asarray(catalog_init_source(ce), np.float64)
    jbounds = jo._make_bounds(jnp.asarray(vp0[0:2]))
    jfree0 = jb.to_free(jb.enforce(jnp.asarray(vp0), jbounds), jbounds)
    tbounds = to._make_bounds(torch.tensor(vp0[None, 0:2]))
    fg_jax = jax.jit(lambda fr: jo._analytic_lik_value_grad(
        fr, jbounds, jpatch, *jbg))

    def fg_ad(fr):
        fr = fr.clone().requires_grad_(True)
        f = elbo_likelihood(tb.to_bound(fr, tbounds), tp, *tbg)
        (g,) = torch.autograd.grad(f.sum(), fr)
        return f.detach(), g

    rng = np.random.default_rng(3)
    for trial in range(3):
        x = np.asarray(jfree0) + rng.normal(0, 0.3, jfree0.shape)
        f_j, g_j = fg_jax(jnp.asarray(x))
        f_t, g_t = to._analytic_lik_value_grad(torch.tensor(x[None]),
                                               tbounds, tp, *tbg)
        f_a, g_a = fg_ad(torch.tensor(x[None]))
        for label, f, g in (("jax", f_j, g_j), ("autograd", f_a, g_a)):
            f, g = np.asarray(f).reshape(-1), np.asarray(g).reshape(-1)
            np.testing.assert_allclose(f_t.numpy(), f, rtol=1e-12,
                                       err_msg=label)
            scale = max(np.abs(g).max(), 1.0)
            np.testing.assert_allclose(g_t.numpy()[0] / scale, g / scale,
                                       rtol=1e-9, atol=1e-11, err_msg=label)


def test_fit_under_analytic_grad_matches_ad():
    """Four lanes, f64, eig: the analytic mode ends where the autograd
    mode does (the paths part at f64 rounding, so the optima are
    compared)."""
    vp0s, patches = _synthetic_batch(n_sources=4, tile=16, seed=3)
    vp = convert.vp0s(vp0s, "cpu", F64)
    tp = convert.sky_patch(patches, "cpu", F64)
    cfg = NewtonConfig(max_iters=30)
    ad = to.fit_sources(vp, tp, config=cfg)
    an = to.fit_sources(vp, tp, config=cfg._replace(grad_mode="analytic"))
    np.testing.assert_array_equal(an.vp[:, IS_STAR].numpy() > 0.5,
                                  ad.vp[:, IS_STAR].numpy() > 0.5)
    np.testing.assert_allclose(an.elbo.numpy(), ad.elbo.numpy(), rtol=1e-6)
    assert bool(an.converged.all())
