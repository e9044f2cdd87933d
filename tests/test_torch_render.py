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


def _mixed(rng, P=16):
    """Ragged rows on 4 tiles (tile 2 without an active pixel): 5 star rows
    (C = 2) then 4 galaxy-sized rows (C = 28), numpy."""
    segments = ((5, 2), (4, 28))
    star, gal = _inputs(rng, 5, 2, P), _inputs(rng, 4, 28, P)
    tiles = [t[:4].copy() for t in star[:4]]
    tiles[1][2] = 0.0                        # mask of tile 2
    tiles[0] *= tiles[1]                     # pixels 0 where masked
    tile_index = np.array([0, 2, 1, 3, 0, 3, 2, 0, 1])
    comps = np.concatenate([star[4].reshape(-1, 6), gal[4].reshape(-1, 6)])
    meta = np.concatenate([star[5], gal[5]])
    return tiles, tile_index, segments, comps, meta


def test_ragged_plain_matches_per_model_and_jax():
    """Star and galaxy rows in one ragged call: each segment equals the
    single-model twin and JAX's XLA reference on the same rows (f64)."""
    tiles, idx, segments, comps, meta = _mixed(np.random.default_rng(5))
    t = [torch.tensor(a) for a in tiles]
    at = render.active_tiles(*t)
    plan = render.row_plan(at, torch.tensor(idx), segments)
    got = render.mixture_poisson_ll_ragged(at, plan, torch.tensor(comps),
                                           torch.tensor(meta))
    ref = jax.jit(lambda *a: jr.mixture_poisson_ll(*a, use_pallas=False))
    r0 = k0 = 0
    for n, C in segments:
        rows = slice(r0, r0 + n)
        seg = (comps[k0:k0 + n * C].reshape(n, C, 6), meta[rows])
        one = render.mixture_poisson_ll(*t, *(torch.tensor(a) for a in seg),
                                        tile_index=torch.tensor(idx[rows]))
        torch.testing.assert_close(got[rows], one, rtol=0, atol=0)
        want = np.asarray(ref(*(jnp.asarray(a[idx[rows]]) for a in tiles),
                              *(jnp.asarray(a) for a in seg)))
        np.testing.assert_allclose(got[rows].numpy(), want, rtol=1e-10)
        r0, k0 = r0 + n, k0 + n * C
    assert np.all(got.numpy()[idx == 2] == 0.0)   # the empty tile


@pytest.mark.parametrize("copies", [1, 3, 8])
def test_active_tiles_and_row_plan_rebuild_inputs(copies):
    """The active-pixel lists rebuild the masks and the pixel values, and
    the work items cover every row once, in blocks of at most `warps` <=
    K4_WARPS rows of one tile, heaviest first; rows past the tiles are
    grouped as -1. `copies` of the row set give tiles more rows than
    K4_WARPS, which then take several work items."""
    tiles, idx, segments, _, _ = _mixed(np.random.default_rng(6))
    idx = np.tile(np.concatenate([idx[:4], [4], idx[4:], [-1]]), copies)
    segments = ((6, 2), (5, 28)) * copies
    at = render.active_tiles(*(torch.tensor(a) for a in tiles))
    T, P = tiles[1].shape[:2]
    mask = np.zeros((T, P, P))
    x, iota, bg = (np.zeros((T, P, P)) for _ in range(3))
    ptr, pos = at.ptr.numpy(), at.pos.numpy()
    for t in range(T):
        p = pos[ptr[t]:ptr[t + 1]]
        mask[t, p >> 16, p & 0xffff] = 1.0
        for dst, src in ((x, at.x), (iota, at.iota_a), (bg, at.bg_a)):
            dst[t, p >> 16, p & 0xffff] = src.numpy()[ptr[t]:ptr[t + 1]]
    np.testing.assert_array_equal(mask, tiles[1])
    assert ptr[3] == ptr[2]                                # tile 2 empty
    on = tiles[1] > 0
    for got, want in ((x, tiles[0]), (iota, tiles[2]), (bg, tiles[3])):
        np.testing.assert_array_equal(got[on], want[on])

    plan = render.row_plan(at, torch.tensor(idx), segments)
    assert 1 <= plan.warps <= render.K4_WARPS and plan.n_tiles == T
    groups, counts = np.unique(np.where((idx >= 0) & (idx < T), idx, -1),
                               return_counts=True)
    # a tile's rows take the fewest items of at most K4_WARPS rows each
    assert len(plan.work) == sum(-(-c // plan.warps) for c in counts)
    assert (len(plan.work) > len(groups)) == (counts.max() > render.K4_WARPS)
    seen = np.zeros(len(idx), int)
    order = plan.order.numpy()
    C = np.repeat([C for _, C in segments], [n for n, _ in segments])
    n_act = np.diff(ptr)
    cost = []
    for tile, b, e in plan.work.numpy():
        rows = order[b:e]
        assert 0 < e - b <= plan.warps
        seen[rows] += 1
        want = np.where((idx[rows] >= 0) & (idx[rows] < T), idx[rows], -1)
        assert np.all(want == tile)
        cost.append(0 if tile < 0 else int((C[rows] * n_act[tile]).sum()))
    assert np.all(seen == 1)
    assert cost == sorted(cost, reverse=True)
    np.testing.assert_array_equal(np.diff(plan.comp_ptr.numpy()), C)
