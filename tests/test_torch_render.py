"""The port's fused render + Poisson score (ops/render.py, the twin of K4)
against the JAX package's ops/pallas_render: its XLA reference in f64 and
its Pallas kernel in interpret mode in f32. The CUDA kernel is held to the
twin in test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celeste_jl_tpu.ops import pallas_render as jr
from celeste_jl_tpu_torch.ops import render

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _mixture(rng, R, C, P):
    """R rows of a C-component mixture near the tile center, numpy."""
    means = P / 2 + rng.normal(0.0, 1.5, (R, C, 2))
    a = rng.uniform(0.5, 6.0, (R, C))
    d = rng.uniform(0.5, 6.0, (R, C))
    b = rng.uniform(-0.4, 0.4, (R, C)) * np.sqrt(a * d)
    covs = np.stack([np.stack([a, b], -1), np.stack([b, d], -1)], -2)
    weights = rng.dirichlet(np.ones(C), R)
    return means, covs, weights


def _inputs(rng, R, C, P):
    """Tiles, packed components and meta of R rows; row 1's mask is
    empty (a band with no active pixel)."""
    means, covs, weights = _mixture(rng, R, C, P)
    comps = np.array(jr.pack_mixture(*(jnp.asarray(a.reshape(
        (R * C,) + a.shape[2:])) for a in (means, covs, weights)))
    ).reshape(R, C, 6)
    off = rng.integers(-3, 40, (R, 2)).astype(np.float64)
    flux = rng.uniform(5.0, 50.0, R)
    meta = np.stack([off[:, 0] + 1.0, off[:, 1] + 1.0, flux, np.zeros(R)], 1)
    comps[:, :, :2] += off[:, None, :] + 1.0     # mixtures follow the tile
    mask = np.zeros((R, P, P))
    lo, hi = P // 4, P - P // 4
    mask[:, lo:hi, lo + 1:hi] = 1.0
    mask[1] = 0.0
    iota = rng.uniform(800.0, 1200.0, (R, P, P))
    bg = rng.uniform(0.05, 0.15, (R, P, P))
    pixels = rng.poisson(iota * (bg + 0.3)).astype(np.float64) * mask
    return pixels, mask, iota, bg, comps, meta


@pytest.mark.parametrize("C,P", [(2, 16), (2, 32), (28, 16), (28, 32)])
def test_plain_twin_matches_jax_reference(C, P):
    rng = np.random.default_rng(C * 100 + P)
    args = _inputs(rng, 6, C, P)
    ref = jax.jit(lambda *a: jr.mixture_poisson_ll(*a, use_pallas=False))
    want = np.asarray(ref(*(jnp.asarray(a) for a in args)))
    got = render.mixture_poisson_ll(*(torch.tensor(a) for a in args))
    assert want[1] == 0.0 and float(got[1]) == 0.0   # the empty band
    # f64, both sum the same terms in other orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("C", [2, 28])
def test_plain_twin_matches_pallas_interpret_f32(C):
    rng = np.random.default_rng(7 + C)
    args = _inputs(rng, 4, C, 32)
    a32 = [a.astype(np.float32) for a in args]
    ker = np.asarray(jr.mixture_poisson_ll(*(jnp.asarray(a) for a in a32),
                                           interpret=True))
    got = render.mixture_poisson_ll(*(torch.tensor(a) for a in a32))
    # both in f32: the bar of tests/test_pallas_render.py:70
    np.testing.assert_allclose(got.numpy(), ker, rtol=2e-4)


def test_pack_mixture_matches_jax():
    means, covs, weights = _mixture(np.random.default_rng(3), 1, 28, 32)
    want = np.asarray(jr.pack_mixture(jnp.asarray(means[0]),
                                      jnp.asarray(covs[0]),
                                      jnp.asarray(weights[0])))
    got = render.pack_mixture(torch.tensor(means), torch.tensor(covs),
                              torch.tensor(weights))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)


def test_tile_index_shares_tiles():
    """Rows that name a tile by index score as on copies of that tile."""
    rng = np.random.default_rng(11)
    pixels, mask, iota, bg, comps, meta = (torch.tensor(a) for a in
                                           _inputs(rng, 6, 28, 16))
    idx = torch.tensor([2, 0, 2, 5, 5, 3])
    shared = render.mixture_poisson_ll(pixels, mask, iota, bg, comps, meta,
                                       tile_index=idx)
    copies = render.mixture_poisson_ll(pixels[idx], mask[idx], iota[idx],
                                       bg[idx], comps, meta)
    torch.testing.assert_close(shared, copies, rtol=0, atol=0)
