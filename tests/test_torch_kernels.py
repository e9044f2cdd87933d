"""The port's CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device and nvcc, is marked `cuda`, and skips
without a device. The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from celeste_jl_tpu_torch.mcmc import log_prob
from celeste_jl_tpu_torch.ops import eigh, refresh, render, tr
from celeste_jl_tpu_torch.ops.bijectors import enforce, to_bound, to_free
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
from celeste_jl_tpu_torch.vi.elbo import brightness_coeffs
from celeste_jl_tpu_torch.vi.optimize import _make_bounds, fit_sources

F64 = torch.float64
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(device, n_sources=8, tile=16, seed=3):
    _, vp0s, p = synthetic_patch_batch(n_sources, tile=tile, seed=seed,
                                       dtype=np.float64, device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    bounds = _make_bounds(vp0[:, 0:2])
    vp = to_bound(to_free(enforce(vp0, bounds), bounds), bounds)
    S, B = vp.shape[0], p.pixels.shape[1]
    C20 = brightness_coeffs(vp)
    zero = torch.zeros_like(p.sky)
    rows, mix = refresh.band_pixel_rows(
        vp[:, None, 0:6].expand(S, B, 6), C20[:, :10].reshape(S, 5, 2),
        C20[:, 10:].reshape(S, 5, 2), p.psf, p.wcs_jacobian, p.world_center,
        p.pixel_center, p.offset, p.pixels, p.mask, p.sky, p.iota, zero,
        zero)
    return rows, mix[0], (tile, tile)


@pytest.mark.parametrize("tile", [16, 40])
def test_refresh_kernel_matches_plain(cuda, tile):
    rows, ks, pdims = _rows(cuda, tile=tile)
    n0 = refresh.pixel_terms.launches
    got = refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
    want = refresh.pixel_terms_plain(*rows, ks=ks, pdims=pdims)
    assert refresh.pixel_terms.launches == n0 + 1
    for a, b in zip(got, want):
        scale = b.abs().amax(dim=0, keepdim=True).clamp(min=1e-30)
        assert float(((a - b).abs() / scale).max()) < 1e-9


def test_sweep_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    V, _ = np.linalg.qr(rng.standard_normal((42, 42)))
    H = (V * np.logspace(-5, 3, 42)) @ V.T
    H = H + 1e-3 * rng.standard_normal((64, 42, 42))
    A = torch.tensor(0.5 * (H + H.transpose(0, 2, 1)), device=cuda)
    Q = torch.eye(42, dtype=F64, device=cuda).expand_as(A)
    n0 = eigh.jacobi_sweep.launches
    Ak, Qk = eigh.jacobi_sweep(A, Q)
    Ap, Qp = eigh.jacobi_sweep_plain(A, Q)
    assert eigh.jacobi_sweep.launches == n0 + 1
    norm = torch.linalg.matrix_norm(A)[:, None, None]
    assert float(((Ak - Ap).abs() / norm).max()) < 1e-9
    assert float((Qk - Qp).abs().max()) < 1e-9


def test_tr_kernel_matches_plain(cuda):
    rng = np.random.default_rng(7)
    B, D = 1000, 42
    w = rng.standard_normal((B, D)) * 3.0
    w[: B // 3] = np.abs(w[: B // 3]) + 0.5
    gq = rng.standard_normal((B, D))
    delta = 10.0 ** rng.uniform(-3, 1, B)
    gq, w, delta = (torch.tensor(a, device=cuda) for a in (gq, w, delta))
    n0 = tr.tr_subproblem.launches
    p_k, pred_k = tr.tr_subproblem(gq, w, delta, 48)
    p_p, pred_p = tr.tr_subproblem_plain(gq, w, delta, 48)
    assert tr.tr_subproblem.launches == n0 + 1
    torch.testing.assert_close(p_k, p_p, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(pred_k, pred_p, rtol=1e-9, atol=1e-9)


def _spectrum_batch(device, B=64, seed=1):
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((42, 42)))
    H = (V * np.logspace(-5, 3, 42)) @ V.T
    H = H + 1e-3 * rng.standard_normal((B, 42, 42))
    return torch.tensor(0.5 * (H + H.transpose(0, 2, 1)), device=device)


def test_split_sweep_kernels_match_plain_and_fused(cuda):
    A = _spectrum_batch(cuda)
    Q = torch.eye(42, dtype=F64, device=cuda).expand_as(A)
    na, nq = eigh.jacobi_sweep_a.launches, eigh.jacobi_replay_q.launches
    Ak, Qk = eigh.jacobi_sweep_split(A, Q)
    assert (eigh.jacobi_sweep_a.launches, eigh.jacobi_replay_q.launches) == (
        na + 1, nq + 1)
    norm = torch.linalg.matrix_norm(A)[:, None, None]
    for Ap, Qp in (eigh.jacobi_sweep_split_plain(A, Q),
                   eigh.jacobi_sweep(A, Q)):
        assert float(((Ak - Ap).abs() / norm).max()) < 1e-11
        assert float((Qk - Qp).abs().max()) < 1e-11


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("is_star", [True, False])
def test_render_kernel_matches_plain(cuda, P, is_star):
    """K4 on 4 sources x 3 AIS lanes of prior draws, f64, per row."""
    from celeste_jl_tpu_torch.mcmc.infer import chunk_target
    from celeste_jl_tpu_torch.synthetic import ais_bench_scene
    from celeste_jl_tpu_torch.vi.elbo import default_prior

    images, cat = ais_bench_scene(4, device=cuda)
    tgt, _ = chunk_target(cat, images, list(range(4)), {}, [8.0] * 4, P,
                          device=cuda, dtype=F64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    sample = (log_prob.sample_star_prior if is_star
              else log_prob.sample_gal_prior)
    th = sample(gen, 12, default_prior(cuda, F64))
    src = torch.arange(4, device=cuda).repeat_interleave(3)
    args = log_prob.fused_rows(log_prob.lanes(tgt, src), th, is_star)
    n0 = render.mixture_poisson_ll.launches
    got = render.mixture_poisson_ll(*args)
    want = render.mixture_poisson_ll_plain(*args)
    assert render.mixture_poisson_ll.launches == n0 + 1
    assert float(((got - want).abs() / want.abs()).max()) < 1e-10


def test_render_kernel_many_components(cuda):
    """C = 100 > the kernel's 32-component chunk, tiles far from the image
    origin (offsets ~400 px), f64, per row."""
    rng = np.random.default_rng(4)
    R, C, P = 6, 100, 32
    t = lambda a: torch.tensor(a, device=cuda)
    off = rng.integers(380, 420, (R, 2)).astype(np.float64)
    means = off[:, None, :] + 1.0 + P / 2 + rng.normal(0.0, 2.0, (R, C, 2))
    a, d = rng.uniform(0.5, 6.0, (2, R, C))
    b = rng.uniform(-0.4, 0.4, (R, C)) * np.sqrt(a * d)
    covs = np.stack([np.stack([a, b], -1), np.stack([b, d], -1)], -2)
    comps = render.pack_mixture(t(means), t(covs),
                                t(rng.dirichlet(np.ones(C), R)))
    meta = t(np.stack([off[:, 0] + 1.0, off[:, 1] + 1.0,
                       rng.uniform(5.0, 50.0, R), np.zeros(R)], 1))
    mask = np.zeros((R, P, P))
    mask[:, 8:25, 8:25] = 1.0
    iota = rng.uniform(800.0, 1200.0, (R, P, P))
    bg = rng.uniform(0.05, 0.15, (R, P, P))
    pixels = rng.poisson(iota * (bg + 0.3)) * mask
    args = (t(pixels), t(mask), t(iota), t(bg), comps, meta)
    got = render.mixture_poisson_ll(*args)
    want = render.mixture_poisson_ll_plain(*args)
    assert float(((got - want).abs() / want.abs()).max()) < 1e-10


def _k4_mixed(device, P, copies=1, dtype=F64, seed=0):
    """K4's ragged inputs on 5 P x P tiles (tile 0 without an active pixel,
    tile 1 all active, the others a disk of radius P / 3): `copies` times
    7 star rows (C = 2) then 9 galaxy-sized rows (C = 28); rows 3 and 10
    have a tile index out of range (5). Three copies give a tile more rows
    than render.K4_WARPS, so it takes several blocks."""
    rng = np.random.default_rng(seed + P)
    T = 5
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    disk = ((ii - P / 2) ** 2 + (jj - P / 2) ** 2 < (P / 3) ** 2) * 1.0
    mask = np.stack([np.zeros((P, P)), np.ones((P, P))] + [disk] * (T - 2))
    iota = rng.uniform(800.0, 1200.0, (T, P, P))
    bg = rng.uniform(0.05, 0.15, (T, P, P))
    pixels = rng.poisson(iota * (bg + 0.3)) * mask
    segments = ((7, 2), (9, 28)) * copies
    R = sum(n for n, _ in segments)
    tile_index = rng.integers(0, T, R)
    tile_index[[3, 10]] = T
    off = rng.integers(-3, 400, (R, 2)).astype(np.float64)
    comps = []
    for n, C in segments:
        means = P / 2 + rng.normal(0.0, 2.0, (n, C, 2))
        a, d = rng.uniform(0.5, 6.0, (2, n, C))
        b = rng.uniform(-0.4, 0.4, (n, C)) * np.sqrt(a * d)
        covs = np.stack([np.stack([a, b], -1), np.stack([b, d], -1)], -2)
        comps.append(render.pack_mixture(
            *(torch.tensor(v) for v in (means, covs,
                                         rng.dirichlet(np.ones(C), n)))))
    comps = torch.cat([c.reshape(-1, 6) for c in comps])
    # mixtures follow their row's tile offset
    per_comp = np.repeat(np.arange(R), [C for n, C in segments
                                        for _ in range(n)])
    comps[:, :2] += torch.tensor(off[per_comp] + 1.0)
    meta = np.stack([off[:, 0] + 1.0, off[:, 1] + 1.0,
                     rng.uniform(5.0, 50.0, R), np.zeros(R)], 1)
    t = lambda v: torch.as_tensor(v, device=device).to(dtype)
    tiles = render.active_tiles(t(pixels), t(mask), t(iota), t(bg))
    idx = torch.as_tensor(tile_index, device=device)
    return tiles, idx, segments, t(comps), t(meta)


@pytest.mark.parametrize("P", [16, 32, 64])
def test_render_kernel_mixed_launch(cuda, P):
    """K4 on one launch of star and galaxy rows against its twin, per row
    (f64, 1e-10): an empty tile gives 0, a full tile and disks are scored,
    out-of-range rows are NaN; two launches are bit-identical. Once with a
    block a tile and once with tiles of several blocks."""
    for copies in (1, 3):
        tiles, idx, segments, comps, meta = _k4_mixed(cuda, P, copies)
        plan = render.row_plan(tiles, idx, segments)
        T = tiles.ptr.numel() - 1
        counts = torch.bincount(idx.clamp(max=T), minlength=T + 1)
        assert (plan.work.shape[0] > int((counts > 0).sum())) == (
            int(counts.max()) > render.K4_WARPS)
        n0 = render.mixture_poisson_ll.launches
        got = render.mixture_poisson_ll_ragged(tiles, plan, comps, meta)
        again = render.mixture_poisson_ll_ragged(tiles, plan, comps, meta)
        assert render.mixture_poisson_ll.launches == n0 + 2
        assert torch.equal(torch.isnan(got), idx == 5)
        assert torch.equal(got[~torch.isnan(got)], again[~torch.isnan(again)])
        ok = idx < 5
        want = render.mixture_poisson_ll_ragged_plain(
            tiles, plan._replace(tile_index=torch.where(ok, idx, 0)), comps,
            meta)
        assert torch.all(got[ok & (idx == 0)] == 0)
        rel = (got - want).abs() / want.abs().clamp(min=1e-300)
        assert float(rel[ok & (idx > 0)].max()) < 1e-10


def test_refresh_kernel_masked_rows(cuda):
    """K1 on a fully masked row (every output exactly 0) and on rows with a
    scattered mask against its twin (f64, 1e-9 of each output's scale);
    two launches are bit-identical."""
    rows, ks, pdims = _rows(cuda, n_sources=4, tile=32)
    rows = list(rows)
    mask = rows[7].clone()
    mask[0] = 0.0
    gen = torch.Generator(device=cuda).manual_seed(1)
    mask[1:5] *= (torch.rand(mask[1:5].shape, device=cuda, generator=gen)
                  > 0.3).to(mask.dtype)
    rows[7] = mask
    got = refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
    again = refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
    want = refresh.pixel_terms_plain(*rows, ks=ks, pdims=pdims)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        assert torch.all(a[0] == 0)
        scale = b.abs().amax(dim=0, keepdim=True).clamp(min=1e-30)
        assert float(((a - b).abs() / scale).max()) < 1e-9


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    x = torch.zeros(4, 42, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        tr.tr_subproblem(x, x, x[:, 0], 48)
    A = torch.zeros(2, 41, 41, dtype=F64, device=cuda)
    with pytest.raises(ValueError):
        eigh.jacobi_sweep(A, A)
    with pytest.raises(ValueError):
        eigh.jacobi_sweep_a(A)
    t = torch.zeros(3, 8, 8, dtype=F64, device=cuda)
    comps = torch.zeros(4, 2, 6, dtype=F64, device=cuda)
    meta = torch.zeros(4, 4, dtype=F64, device=cuda)
    with pytest.raises(ValueError):     # 4 rows, 3 tiles, no index
        render.mixture_poisson_ll(t, t, t, t, comps, meta)
    # an index past the tiles: that row is NaN, the others are scored
    out = render.mixture_poisson_ll(t, t, t, t, comps, meta,
                                    torch.tensor([0, 3, 2, -1], device=cuda))
    assert torch.isnan(out).tolist() == [False, True, False, True]
    # the ragged entry: a plan or tiles on the host, indices of another
    # type, or a plan made for other tiles raise before any launch
    tiles, idx, segments, comps, meta = _k4_mixed(cuda, 16)
    plan = render.row_plan(tiles, idx, segments)
    host = lambda nt: nt._replace(**{f: getattr(nt, f).cpu() for f in
                                     nt._fields
                                     if isinstance(getattr(nt, f),
                                                   torch.Tensor)})
    other = render.active_tiles(*(x[:4] for x in (
        tiles.pixels, tiles.mask, tiles.iota, tiles.bg)))
    n0 = render.mixture_poisson_ll.launches
    for bad_tiles, bad_plan in (
            (tiles, host(plan)), (host(tiles), plan),
            (tiles, plan._replace(order=plan.order.long())),
            (tiles._replace(x=tiles.x.float()), plan), (other, plan)):
        with pytest.raises(ValueError):
            render.mixture_poisson_ll_ragged(bad_tiles, bad_plan, comps, meta)
    with pytest.raises(ValueError):     # comps of other rows than plan's
        render.mixture_poisson_ll_ragged(tiles, plan, comps[:-1], meta)
    assert render.mixture_poisson_ll.launches == n0


def test_kernel_fit_matches_plain_fit(cuda):
    _, vp0s, p = synthetic_patch_batch(4, tile=16, seed=2, dtype=np.float64,
                                       device=cuda)
    vp = torch.as_tensor(vp0s, device=cuda)
    cfg = NewtonConfig(tr_solver="pjacobi", jacobi_max_sweeps=4,
                       tr_kernel="pallas", refresh_kernel="pallas",
                       max_iters=12)
    rk = fit_sources(vp, p, config=cfg)
    rp = fit_sources(vp, p, config=cfg, plain=True)
    np.testing.assert_array_equal(rk.vp[:, 26].cpu().numpy() > 0.5,
                                  rp.vp[:, 26].cpu().numpy() > 0.5)
    e = rp.elbo.cpu().numpy()
    assert np.all((rk.elbo.cpu().numpy() - e) / np.abs(e) > -1e-4)
