"""The port's refresh pixel pass (ops/refresh.py) against the JAX
package's: the plain twin against `_pixel_terms_row`, the band blocks
against `_band_lik_terms`, and the chained (f, g, H) against
`_analytic_lik_fgh`, in float64 on the CPU to 1e-9 relative
(tests/test_pallas_refresh.py:69). The CUDA kernel is held to the twin in
test_torch_kernels.py."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from celeste_jl_tpu.ops import bijectors as jb
from celeste_jl_tpu.ops.pallas_refresh import _pixel_terms_row
from celeste_jl_tpu.vi import optimize as jo
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.ops import bijectors as tb
from celeste_jl_tpu_torch.ops import refresh
from celeste_jl_tpu_torch.vi import elbo as te
from celeste_jl_tpu_torch.vi import optimize as to

F64 = torch.float64
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)
NAMES = ("lik_core", "m15", "hcross", "htc", "hcc", "gc")

def _batch(n_sources=3, tile=16, seed=2):
    vp0s, patches = _synthetic_batch(n_sources=n_sources, tile=tile,
                                     seed=seed)
    vp = np.asarray(vp0s, np.float64)
    jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64))
                      if np.asarray(x).dtype.kind == "f" else jnp.asarray(x),
                      patches)
    return vp, jp, convert.sky_patch(patches, "cpu", F64)


def _close(got, want, rtol=1e-9, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1.0),
                               err_msg=name)


def _band_inputs(vp, tp):
    """(theta6, cl, cll) of every (source, band) and the patch fields, as
    _analytic_lik_fgh builds them, at the enforced starting point."""
    t = torch.tensor(vp)
    bounds = to._make_bounds(t[:, 0:2])
    v = tb.to_bound(tb.to_free(tb.enforce(t, bounds), bounds), bounds)
    S, B = v.shape[0], tp.pixels.shape[1]
    C20 = te.brightness_coeffs(v)
    zero = torch.zeros_like(tp.sky)
    return (v[:, None, 0:6].expand(S, B, 6), C20[:, :10].reshape(S, 5, 2),
            C20[:, 10:].reshape(S, 5, 2), tp.psf, tp.wcs_jacobian,
            tp.world_center, tp.pixel_center, tp.offset, tp.pixels, tp.mask,
            tp.sky, tp.iota, zero, zero)


def test_pixel_terms_plain_matches_jax_rows():
    vp, _, tp = _batch()
    rows, mix = refresh.band_pixel_rows(*_band_inputs(vp, tp))
    ks, pdims = mix[0], tuple(tp.pixels.shape[-2:])
    got = refresh.pixel_terms_plain(*rows, ks=ks, pdims=pdims)
    want = jax.jit(jax.vmap(partial(_pixel_terms_row, ks=ks, pdims=pdims)))(
        *(jnp.asarray(r.numpy()) for r in rows))
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, name=name)
    # the wrapper takes the twin for CPU tensors
    for name, a, b in zip(NAMES, refresh.pixel_terms(*rows, ks=ks,
                                                     pdims=pdims), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_band_lik_terms_match_jax():
    vp, _, tp = _batch(seed=4)
    args = _band_inputs(vp, tp)
    P = tuple(tp.pixels.shape[-2:])
    got = refresh.band_lik_terms_fused(*args, P, terms=refresh.pixel_terms)
    band = jax.vmap(jax.vmap(partial(jo._band_lik_terms, P=P)))
    want = jax.jit(band)(*(jnp.asarray(a.contiguous().numpy()) for a in args))
    for name, a, b in zip(("lik", "g_theta", "g_C", "H_tt", "H_tC", "H_CC"),
                          got, want):
        _close(a, b, name=name)


@pytest.mark.parametrize("with_bg", [False, True])
def test_analytic_lik_fgh_matches_jax(with_bg):
    """With and without fixed neighbor images (bg_E_G, bg_var_G)."""
    vp, jp, tp = _batch(seed=2)
    bg = [None, None]
    if with_bg:
        rng = np.random.default_rng(8)
        bg = [rng.uniform(0.0, 0.05, size=tp.sky.shape) for _ in range(2)]

    def jfgh(v, p, bE, bV):
        b = jo._make_bounds(v[0:2])
        fr = jb.to_free(jb.enforce(v, b), b)
        return jo._analytic_lik_fgh(fr, b, p, bE, bV, "xla")

    jbg = [None if a is None else jnp.asarray(a) for a in bg]
    want = jax.jit(jax.vmap(jfgh))(jnp.asarray(vp), jp, *jbg)
    tbg = [None if a is None else torch.tensor(a) for a in bg]
    t = torch.tensor(vp)
    bounds = to._make_bounds(t[:, 0:2])
    free = tb.to_free(tb.enforce(t, bounds), bounds)
    for kern in ("xla", "pallas"):
        got = to._analytic_lik_fgh(free, bounds, tp, *tbg,
                                   refresh_kernel=kern)
        for name, a, b in zip(("lik", "g", "H"), got, want):
            _close(a, b, name=f"{kern} {name}")


def test_pixel_terms_raises_off_cpu_and_cuda():
    vp, _, tp = _batch(n_sources=1)
    rows, mix = refresh.band_pixel_rows(*_band_inputs(vp, tp))
    meta = [r.to("meta") for r in rows]
    with pytest.raises(ValueError):
        refresh.pixel_terms(*meta, ks=mix[0], pdims=(16, 16))



def test_chain_coefficient_structural_zeros():
    """The refresh kernel skips the entries of P = chain R (pch, as
    band_pixel_rows builds it) that are structurally zero: star components
    reach theta rows 0, 1 through b = 1, 2 only; galaxy components rows
    0, 1 through b = 1, 2, row 2 through b = 0 and rows 3..5 through
    b = 0, 3, 4, 5 (the port-side copy of
    tests/test_pallas_refresh.py::test_chain_coefficient_sparsity). The
    live entries are not all zero."""
    pattern = {0: (1, 2), 1: (1, 2), 2: (0,), 3: (0, 3, 4, 5),
               4: (0, 3, 4, 5), 5: (0, 3, 4, 5)}
    for seed in (5, 6):
        vp, _, tp = _batch(n_sources=2, seed=seed)
        _, mix = refresh.band_pixel_rows(*_band_inputs(vp, tp))
        ks, pch = mix[0], mix[4].numpy()
        for P, pats in ((pch[..., :ks, :, :], {0: (1, 2), 1: (1, 2)}),
                        (pch[..., ks:, :, :], pattern)):
            for t in range(6):
                live = list(pats.get(t, ()))
                dead = [b for b in range(6) if b not in live]
                assert np.all(P[..., t, dead] == 0.0), (seed, t)
                if live:
                    assert np.any(P[..., t, live] != 0.0), (seed, t)
