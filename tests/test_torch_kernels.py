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


def _misaligned(x):
    """A copy of x whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("D", [4, 6, 42, 64])
def test_split_sweep_kernels_match_plain_and_fused(cuda, D):
    """K2a and K2b against their twins and against K2, at D = 4, 6, 42, 64
    and B = 1, 129, 1024, 2000 (partial blocks of K2b's several matrices a
    block, and a second wave), on a dense orthogonal Q:
    - K2a + K2b give K2's bits, A, log and Q, in f64 and f32 (the same
      arithmetic in the same order), and two launches give the same bits;
    - f64: A within 1e-9 of ||H||, the log and Q within 1e-9 of the twins
      (at D = 42, B = 64 and Q = I, A and Q within 1e-11);
    - f32: K2b on K2a's log within 1e-5 of its twin on that log (a replay
      amplifies no rounding: every step is an orthogonal rotation; K2a's
      one f32 sweep does, so it is held through K2's bits, and K2 through
      the eigensolver's bars in test_sweep_kernel_sizes_and_batches);
    - Q and a log that do not start on 16 bytes give the same bits."""
    if D == 42:
        A = _spectrum_batch(cuda)
        Q = torch.eye(42, dtype=F64, device=cuda).expand_as(A)
        na, nq = eigh.jacobi_sweep_a.launches, eigh.jacobi_replay_q.launches
        Ak, Qk = eigh.jacobi_sweep_split(A, Q)
        assert (eigh.jacobi_sweep_a.launches,
                eigh.jacobi_replay_q.launches) == (na + 1, nq + 1)
        norm = torch.linalg.matrix_norm(A)[:, None, None]
        for Ap, Qp in (eigh.jacobi_sweep_split_plain(A, Q),
                       eigh.jacobi_sweep(A, Q)):
            assert float(((Ak - Ap).abs() / norm).max()) < 1e-11
            assert float((Qk - Qp).abs().max()) < 1e-11
    rng = np.random.default_rng(100 + D)
    for B in (1, 129, 1024, 2000):
        H64, _ = _spectrum(rng, B, D)
        Q64 = np.linalg.qr(rng.standard_normal((B, D, D)))[0]
        for dtype in (F64, torch.float32):
            H = torch.tensor(H64, dtype=dtype, device=cuda)
            Q = torch.tensor(Q64, dtype=dtype, device=cuda)
            na = eigh.jacobi_sweep_a.launches
            nq = eigh.jacobi_replay_q.launches
            Ak, cs = eigh.jacobi_sweep_a(H)
            Ak2, cs2 = eigh.jacobi_sweep_a(H)
            Qk = eigh.jacobi_replay_q(Q, cs)
            Qk2 = eigh.jacobi_replay_q(Q, cs)
            assert (eigh.jacobi_sweep_a.launches,
                    eigh.jacobi_replay_q.launches) == (na + 2, nq + 2)
            assert cs.shape == (B, D - 1, 2, D // 2)
            assert torch.equal(Ak, Ak2) and torch.equal(cs, cs2)
            assert torch.equal(Qk, Qk2)
            Af, Qf = eigh.jacobi_sweep(H, Q)
            assert torch.equal(Ak, Af) and torch.equal(Qk, Qf), (D, B, dtype)
            assert torch.equal(
                eigh.jacobi_replay_q(_misaligned(Q), _misaligned(cs)), Qk)
            if dtype == F64:
                Ap, csp = eigh.jacobi_sweep_a_plain(H)
                Qp = eigh.jacobi_replay_q_plain(Q, csp)
                norm = torch.linalg.matrix_norm(H)[:, None, None]
                assert float(((Ak - Ap).abs() / norm).max()) < 1e-9, (D, B)
                assert float((cs - csp).abs().max()) < 1e-9, (D, B)
                assert float((Qk - Qp).abs().max()) < 1e-9, (D, B)
            else:
                Qp = eigh.jacobi_replay_q_plain(Q, cs)
                assert float((Qk - Qp).abs().max()) < 1e-5, (D, B)


def _replay_q_fma(Q, cs):
    """jacobi_replay_q_plain with K2b's rounding: each rotated entry is
    fma(c, own, sgn_s * other) (csrc/jacobi_round.cuh), emulated in f64
    (c * own is exact there) and rounded once more to f32."""
    from celeste_jl_tpu_torch.ops.jacobi import _round_robin_perm

    B, D, _ = Q.shape
    perm = torch.as_tensor(_round_robin_perm(D), device=Q.device)
    for r in range(cs.shape[1]):
        c, s = cs[:, r, 0][:, None], cs[:, r, 1][:, None]
        y = Q.reshape(B, D, D // 2, 2)
        y0, y1 = y[..., 0], y[..., 1]
        q0 = (c.double() * y0.double() + ((-s) * y1).double()).float()
        q1 = (c.double() * y1.double() + (s * y0).double()).float()
        Q = torch.stack([q0, q1], dim=-1).reshape(B, D, D)[:, :, perm]
    return Q


def test_split_replay_and_twin_are_deterministic(cuda):
    """chip_smoke.py phase 5's f32 input (1024 wide-spectrum matrices, K2a's
    log replayed on an expanded identity): K2b and its twin each give the
    same bytes on two calls; they differ (K2b rounds each rotated entry
    once, in an fma, the twin its two products and their sum) by at most
    a few f32 ulps of |q| <= 1, and K2b is the twin with the fma's
    rounding to all but a few entries (the emulation rounds twice)."""
    import chip_smoke

    H = torch.as_tensor(chip_smoke.wide_spectrum_batch(
        np.random.default_rng(0), 1024), dtype=torch.float32, device=cuda)
    eye = torch.eye(42, dtype=torch.float32, device=cuda).expand_as(H)
    _, cs = eigh.jacobi_sweep_a(H)
    kernel = [eigh.jacobi_replay_q(eye, cs) for _ in range(2)]
    twin = [eigh.jacobi_replay_q_plain(eye, cs) for _ in range(2)]
    assert torch.equal(kernel[0], kernel[1])
    assert torch.equal(twin[0], twin[1])
    diff = (kernel[0] - twin[0]).abs()
    assert 0 < float(diff.max()) <= 1e-6
    emulated = _replay_q_fma(eye.contiguous(), cs)
    assert int((emulated != kernel[0]).sum()) <= 100
    assert float((emulated - kernel[0]).abs().max()) <= 1e-6


def test_split_kernels_reject_unsupported_sizes_and_logs(cuda):
    """K2a and K2b take even D in [4, 64], and K2b a (B, D-1, 2, D/2) log:
    anything else raises ValueError before a launch."""
    na, nq = eigh.jacobi_sweep_a.launches, eigh.jacobi_replay_q.launches
    for D in (2, 41, 66):
        A = torch.zeros(3, D, D, dtype=F64, device=cuda)
        log = torch.zeros(3, D - 1, 2, D // 2, dtype=F64, device=cuda)
        with pytest.raises(ValueError):
            eigh.jacobi_sweep_a(A)
        with pytest.raises(ValueError):
            eigh.jacobi_replay_q(A, log)
    Q = torch.zeros(3, 42, 42, dtype=F64, device=cuda)
    for shape in ((3, 42, 2, 21), (3, 41, 21, 2), (2, 41, 2, 21),
                  (3, 41, 2, 20)):
        with pytest.raises(ValueError):
            eigh.jacobi_replay_q(Q, torch.zeros(shape, dtype=F64,
                                                device=cuda))
    assert (eigh.jacobi_sweep_a.launches,
            eigh.jacobi_replay_q.launches) == (na, nq)


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


def _spectrum(rng, B, D):
    """B jittered copies of a symmetric D x D matrix with eigenvalues
    spanning 1e-5 to 1e3 and a negative tail (as chip_smoke.py's K2 batch),
    and their reference eigenvalues."""
    n_neg = max(1, D // 7)
    w = np.concatenate([-np.logspace(-4, 1, n_neg),
                        np.logspace(-5, 3, D - n_neg)])
    V, _ = np.linalg.qr(rng.standard_normal((D, D)))
    H = (V * w) @ V.T + 1e-3 * rng.standard_normal((B, D, D))
    H = 0.5 * (H + H.transpose(0, 2, 1))
    return H, np.linalg.eigvalsh(H)


@pytest.mark.parametrize("D", [4, 6, 42, 64])
def test_sweep_kernel_sizes_and_batches(cuda, D):
    """K2 against its twin at D = 4, 6, 42, 64 and B = 1, 129, 1024, 2000
    (a partial wave and a second one): f64 within 1e-9 of ||H|| (Q within
    1e-9); f32 through jacobi_eigh's quality bars (chip_smoke.EIGH_BARS),
    since one f32 sweep amplifies rounding; two launches bit-identical."""
    rng = np.random.default_rng(D)
    for B in (1, 129, 1024, 2000):
        H64, w_ref = _spectrum(rng, B, D)
        for dtype in (F64, torch.float32):
            H = torch.tensor(H64, dtype=dtype, device=cuda)
            eye = torch.eye(D, dtype=dtype, device=cuda).expand_as(H)
            n0 = eigh.jacobi_sweep.launches
            Ak, Qk = eigh.jacobi_sweep(H, eye)
            Ak2, Qk2 = eigh.jacobi_sweep(H, eye)
            assert eigh.jacobi_sweep.launches == n0 + 2
            assert torch.equal(Ak, Ak2) and torch.equal(Qk, Qk2)
            if dtype == F64:
                Ap, Qp = eigh.jacobi_sweep_plain(H, eye)
                norm = torch.linalg.matrix_norm(H)[:, None, None]
                assert float(((Ak - Ap).abs() / norm).max()) < 1e-9, (D, B)
                assert float((Qk - Qp).abs().max()) < 1e-9, (D, B)
                continue
            w, Q, _ = eigh.jacobi_eigh(H, tol=1e-6, max_sweeps=10)
            w = w.double().cpu().numpy()
            Q = Q.double().cpu().numpy()
            dw = np.max(np.abs(np.sort(w, -1) - w_ref))
            orth = np.max(np.abs(np.einsum("bji,bjk->bik", Q, Q)
                                 - np.eye(D)))
            resid = (np.max(np.abs(np.einsum("bij,bjk->bik", H64, Q)
                                   - w[:, None, :] * Q))
                     / np.linalg.norm(H64[0]))
            assert dw < 5e-3 and orth < 1e-4 and resid < 1e-4, (D, B)


def _tr_lanes(rng, B, D):
    """K3's cases: positive-definite (interior) and indefinite (boundary)
    lanes, a hard-case lane (gq orthogonal to the bottom eigenvector), a
    lane whose minimum of w is tied (the first index is the bottom), the
    same tie in the hard case, and a lane with a NaN in gq."""
    w = rng.standard_normal((B, D)) * 3.0
    w[: B // 3] = np.abs(w[: B // 3]) + 0.5
    gq = rng.standard_normal((B, D))
    delta = 10.0 ** rng.uniform(-3, 1, B)
    w[-1] = np.linspace(3.0, 0.5, D)
    w[-1, -1] = -2.0
    gq[-1, -1] = 0.0
    delta[-1] = 5.0
    if D > 3:
        for lane, g_bottom in ((-2, 1.0), (-3, 0.0)):
            w[lane] = np.abs(w[lane]) + 1.0
            w[lane, [1, D - 2]] = -2.5
            gq[lane, [1, D - 2]] = g_bottom
            delta[lane] = 4.0
    gq[-4, D // 2] = np.nan
    return gq, w, delta


@pytest.mark.parametrize("D", [1, 7, 42, 64])
def test_tr_kernel_sizes_and_cases(cuda, D):
    """K3 against its twin in f64 (1e-9), on 1001 lanes (not a multiple of
    a block's lanes): interior, boundary, hard-case and tied-minimum lanes
    (the first index wins), and a NaN in gq (a NaN step and pred, as the
    twin gives); two launches are bit-identical."""
    gq, w, delta = (torch.tensor(a, device=cuda)
                    for a in _tr_lanes(np.random.default_rng(D), 1001, D))
    n0 = tr.tr_subproblem.launches
    p_k, pred_k = (x.clone() for x in tr.tr_subproblem(gq, w, delta, 48))
    p_k2, pred_k2 = tr.tr_subproblem(gq, w, delta, 48)
    assert tr.tr_subproblem.launches == n0 + 2
    assert torch.equal(p_k.nan_to_num(7.0), p_k2.nan_to_num(7.0))
    assert torch.equal(pred_k.nan_to_num(7.0), pred_k2.nan_to_num(7.0))
    p_p, pred_p = tr.tr_subproblem_plain(gq, w, delta, 48)
    torch.testing.assert_close(p_k, p_p, rtol=1e-9, atol=1e-9,
                               equal_nan=True)
    torch.testing.assert_close(pred_k, pred_p, rtol=1e-9, atol=1e-9,
                               equal_nan=True)
    assert bool(torch.isnan(pred_k[-4])) and bool(torch.isnan(p_k[-4]).all())
    if D > 3:   # the tied hard-case lane steps along index 1, not D - 2
        assert abs(float(p_k[-3, 1])) > 0.1 and float(p_k[-3, D - 2]) == 0.0


def test_fit_kernels_reject_unsupported_sizes(cuda):
    """K2 takes even D in [4, 64], K3 D in [1, 64]: any other size raises
    ValueError before a launch."""
    n2, n3 = eigh.jacobi_sweep.launches, tr.tr_subproblem.launches
    for D in (2, 41, 66):
        A = torch.zeros(3, D, D, dtype=F64, device=cuda)
        with pytest.raises(ValueError):
            eigh.jacobi_sweep(A, A)
    for D in (0, 65):
        x = torch.zeros(3, D, dtype=F64, device=cuda)
        with pytest.raises(ValueError):
            tr.tr_subproblem(x, x, x[:, 0] if D else torch.ones(
                3, dtype=F64, device=cuda), 48)
    assert (eigh.jacobi_sweep.launches, tr.tr_subproblem.launches) == (n2, n3)


def _ieee_fast_checks():
    """csrc/tests/ieee_fast_check.cu, built apart from the kernel library:
    call(name, *args) runs celeste_ieee_fast_<name> on the current stream
    and asserts the launch succeeded."""
    import ctypes
    import os

    from celeste_jl_tpu_torch.ops import _build

    lib = ctypes.CDLL(_build.build(
        [os.path.join(_build.CSRC, "tests", "ieee_fast_check.cu")],
        "ieee_fast_check"))
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = {"check": [P] * 4 + [I] * 2 + [P], "rcp_scaling": [P, P],
                "exhaustive": [I, I, P, P]}

    def call(name, *args):
        fn = getattr(lib, f"celeste_ieee_fast_{name}")
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        assert fn(*args, torch.cuda.current_stream().cuda_stream) == 0, name

    return call


def test_fast_division_is_ieee(cuda):
    """csrc/ieee_fast.cuh in f32 (K3's division). Its fast division, where
    |b| and a nonzero |a| lie in [2^-60, 2^60]: the bits of IEEE division
    (`/`) on 2^22 pairs of random sign, mantissa and exponent over that
    range, and a zero for a = 0. Its checked division: the bits of `/` on
    2^22 pairs over every exponent, with zeros of either sign, infinities
    and NaN."""
    call = _ieee_fast_checks()
    gen = torch.Generator(device=cuda).manual_seed(11)
    n = 1 << 22
    rnd = lambda lo, hi: (torch.rand(n, device=cuda, generator=gen,
                                     dtype=F64) * (hi - lo) + lo)
    sign = lambda: torch.where(torch.rand(n, device=cuda, generator=gen) < 0.5,
                               -1.0, 1.0).to(F64)
    fast, ieee = (torch.empty(n, device=cuda) for _ in range(2))

    a = (sign() * torch.exp2(rnd(-60.0, 60.0))).float()
    b = (sign() * torch.exp2(rnd(-60.0, 60.0))).float()
    a[: n // 64] = 0.0
    a[n // 64: n // 32] = -0.0
    # mantissas next to 1, where the rounding is closest to a tie
    b[-n // 64:] = 1.0 + torch.arange(n // 64, device=cuda) * 2.0 ** -23
    call("check", a, b, fast, ieee, n, 0)
    nz = a != 0
    assert torch.equal(fast[nz].view(torch.int32), ieee[nz].view(torch.int32))
    assert bool((fast[~nz] == 0).all())

    a = (sign() * torch.exp2(rnd(-160.0, 140.0))).float()
    b = (sign() * torch.exp2(rnd(-160.0, 140.0))).float()
    a[:6] = torch.tensor([0.0, -0.0, float("inf"), float("nan"), 1.0, -0.0])
    b[:6] = torch.tensor([3.0, 3.0, 2.0, 1.0, 0.0, -0.0])
    call("check", a, b, fast, ieee, n, 1)
    nan = torch.isnan(ieee)
    assert torch.equal(torch.isnan(fast), nan)
    assert torch.equal(fast[~nan].view(torch.int32),
                       ieee[~nan].view(torch.int32))


def test_fast_division_exhaustive(cuda):
    """The proof by exhaustion csrc/ieee_fast.cuh's header relies on: the
    reciprocal estimate of +-m 2^k is +-rcp(m) 2^-k for every significand m
    and every k in [-60, 60], and the fast division gives the bits of `/`
    for all 2^46 pairs a, b in [1, 2) (~1 min on an H100)."""
    call = _ieee_fast_checks()
    out = torch.zeros(3, dtype=torch.int64, device=cuda)
    call("rcp_scaling", out)
    torch.cuda.synchronize()
    assert int(out[0]) == 0, f"b bits {int(out[2]):#x}"
    chunk = 1 << 16
    for b_first in range(0, 1 << 23, chunk):
        call("exhaustive", b_first, chunk, out)
    torch.cuda.synchronize()
    assert int(out[0]) == 0, (f"{int(out[0])} pairs differ, e.g. a bits "
                              f"{int(out[1]):#x}, b bits {int(out[2]):#x}")


def test_psf_fits_run_k3_not_its_twin(cuda, monkeypatch):
    """The PSF fits (D = 12) on the card step through K3 and never its
    plain twin; the fitted mixture matches the twin route's."""
    from celeste_jl_tpu_torch.models import psf_fit
    from celeste_jl_tpu_torch.models.psf import make_psf, render_psf
    from celeste_jl_tpu_torch.ops import newton

    psf = make_psf([0.6, 0.4], [[0.3, -0.2], [0.0, 0.1]],
                   [np.array([[2.0, 0.3], [0.3, 1.5]]),
                    np.array([[6.0, -0.5], [-0.5, 7.0]])])
    stamps = np.stack([render_psf(psf, 25).numpy(),
                       render_psf(psf, 25).numpy() * 0.9])
    plain, _ = psf_fit.fit_psfs_batched(stamps, device=cuda, plain=True)

    def refuse(*args, **kw):
        raise AssertionError("the plain TR twin ran on the card's path")

    monkeypatch.setattr(newton, "tr_subproblem_plain", refuse)
    before = tr.tr_subproblem.launches
    got, errs = psf_fit.fit_psfs_batched(stamps, device=cuda)
    assert tr.tr_subproblem.launches > before
    assert np.all(np.isfinite(errs))
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-9 * np.abs(plain).max())


def test_fused_schedule_is_deterministic(cuda, monkeypatch):
    """The fused joint schedule (joint_infer_fields) run twice on chip_smoke
    phase 14's first field (8 sources on 128 x 128 px, seed 7) under
    torch.use_deterministic_algorithms gives the same bits, through the
    kernels."""
    from celeste_jl_tpu_torch.benchmark.multifield import build_field
    from celeste_jl_tpu_torch.parallel.run import joint_infer_fields
    from celeste_jl_tpu_torch.utils import telemetry

    # cuBLAS's deterministic workspace, asked for by the deterministic mode
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    field = build_field(7, 8, 128, device=cuda)[0]
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            k1 = refresh.pixel_terms.launches
            runs.append(joint_infer_fields([field], device=cuda)[0])
            assert telemetry.counters.serial_steps > 0   # the fused path
            assert refresh.pixel_terms.launches > k1
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs[0]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.vs, b.vs)
        assert a.elbo == b.elbo and a.converged == b.converged
