"""The port's render, ELBO, bijectors, KL and synthetic batch against the
JAX package on the same inputs, in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from celeste_jl_tpu.ops import bijectors as jb
from celeste_jl_tpu.vi import elbo as je
from celeste_jl_tpu.vi.optimize import _make_bounds
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.ops import bijectors as tb
from celeste_jl_tpu_torch.vi import elbo as te

F64 = torch.float64
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _batch(n_sources=4, tile=16, seed=2):
    """The same seeded batch for both packages, float64."""
    vp0s, patches = _synthetic_batch(n_sources=n_sources, tile=tile,
                                     seed=seed)
    vp = np.asarray(vp0s, np.float64)
    jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64))
                      if np.asarray(x).dtype.kind == "f" else jnp.asarray(x),
                      patches)
    return vp, jp, convert.sky_patch(patches, "cpu", F64)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1.0))


@pytest.mark.parametrize("with_bg", [False, True])
def test_elbo_value_and_grad_match_jax(with_bg):
    """With and without fixed neighbor images (bg_E_G, bg_var_G)."""
    vp, jp, tp = _batch()
    bg = [None, None]
    if with_bg:
        rng = np.random.default_rng(8)
        bg = [rng.uniform(0.0, 0.05, size=tp.sky.shape) for _ in range(2)]
    jbg = [None if a is None else jnp.asarray(a) for a in bg]
    v, g = jax.jit(jax.vmap(jax.value_and_grad(je.elbo)))(
        jnp.asarray(vp), jp, *jbg)
    tv = torch.tensor(vp, requires_grad=True)
    e = te.elbo(tv, tp, *[None if a is None else torch.tensor(a) for a in bg])
    (tg,) = torch.autograd.grad(e.sum(), tv)
    _close(e.detach(), v, 1e-10)
    _close(tg, g, 1e-10)


def test_density_grids_match_jax():
    vp, jp, tp = _batch(seed=5)
    want = jax.jit(jax.vmap(je.source_fs_grids))(jnp.asarray(vp), jp)
    got = te.source_fs_grids(torch.tensor(vp), tp)
    for a, b in zip(got, want):
        _close(a, b, 1e-12)


def test_bijectors_match_jax():
    rng = np.random.default_rng(11)
    S = 6
    pos = 10.0 + rng.uniform(size=(S, 2))
    free = rng.normal(0.0, 2.0, size=(S, 41))
    jbounds = jax.vmap(_make_bounds)(jnp.asarray(pos))
    tbounds = tb.default_box_bounds(torch.tensor(pos))
    for a, b in zip(tbounds, jbounds):
        _close(a, b, 1e-15)

    vp_j = jax.vmap(jb.to_bound)(jnp.asarray(free), jbounds)
    vp_t = tb.to_bound(torch.tensor(free), tbounds)
    _close(vp_t, vp_j, 1e-12)
    _close(tb.to_free(vp_t, tbounds), jax.vmap(jb.to_free)(vp_j, jbounds),
           1e-12)

    # out-of-box and off-simplex values are projected inside
    wild = np.asarray(vp_j) * rng.uniform(0.0, 2.0, size=(S, 44))
    wild[:, 0:2] = pos + rng.normal(0.0, 1e-3, size=(S, 2))
    _close(tb.enforce(torch.tensor(wild), tbounds),
           jax.vmap(jb.enforce)(jnp.asarray(wild), jbounds), 1e-12)


def test_kl_matches_jax():
    vp, _, _ = _batch(seed=7)
    rng = np.random.default_rng(3)
    vp = vp.copy()
    vp[:, 6:10] += rng.normal(0.0, 0.3, size=(vp.shape[0], 4))
    vp[:, 10:18] += rng.normal(0.0, 0.5, size=(vp.shape[0], 8))
    want = jax.vmap(je.subtract_kl)(jnp.asarray(vp))
    _close(te.subtract_kl(torch.tensor(vp)), want, 1e-12)
    prior = convert.prior_constants(je.PRIOR, "cpu", F64)
    _close(te.subtract_kl(torch.tensor(vp), prior), want, 1e-12)


def test_synthetic_patch_batch_matches_jax():
    from celeste_jl_tpu.synthetic import synthetic_patch_batch as jsyn
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch as tsyn

    cat_j, vp_j, p_j = jsyn(4, tile=16, seed=2, dtype=np.float64)
    cat_t, vp_t, p_t = tsyn(4, tile=16, seed=2, dtype=np.float64,
                            device="cpu")
    np.testing.assert_array_equal(vp_t, vp_j)
    assert [c.is_star for c in cat_t] == [c.is_star for c in cat_j]
    for a, b in zip(cat_t, cat_j):
        np.testing.assert_array_equal(a.star_fluxes, b.star_fluxes)
        np.testing.assert_array_equal(a.gal_fluxes, b.gal_fluxes)
    for name, a, b in zip(p_t._fields, p_t, p_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
