"""The port's parallel-Jacobi eigensolver (ops/eigh.py): the plain sweep,
fused and split, against the JAX package's Pallas sweeps (interpret mode),
jacobi_eigh at the bars of tests/test_pallas_eigh.py:46-54, the same rows
at two batch sizes, and a fit through the split sweep; the sweep kernels'
schedules (K2 with K2a's log, K2b) replayed in numpy and their size list.
The CUDA sweeps are held to the plain ones in test_torch_kernels.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celeste_jl_tpu.ops.pallas_eigh import D, _one_sweep
from celeste_jl_tpu_torch.ops import eigh
from celeste_jl_tpu_torch.ops.jacobi import _round_robin_perm, pad_to_even

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _wide_spectrum_batch(rng, B, noise=1e-3):
    """As tests/test_pallas_eigh.py: B jittered copies of a symmetric
    matrix whose spectrum spans ~8 decades with a negative tail."""
    w_true = np.concatenate([-np.logspace(-4, 1, 6),
                             np.logspace(-5, 3, D - 6)])
    V, _ = np.linalg.qr(rng.standard_normal((D, D)))
    A0 = (V * w_true) @ V.T
    A0 = 0.5 * (A0 + A0.T)
    batch = np.stack([A0 + noise * rng.standard_normal((D, D))
                      for _ in range(B)])
    return (0.5 * (batch + batch.transpose(0, 2, 1))).astype(np.float32)


def test_round_robin_perm_matches_jax():
    from celeste_jl_tpu.ops.jacobi import _round_robin_perm as jperm

    for n in (4, 8, 42):
        np.testing.assert_array_equal(_round_robin_perm(n), jperm(n))


def test_one_sweep_matches_jax_kernel():
    """A after one f32 sweep agrees to 1e-4 of ||H||. A sweep amplifies
    rounding in the rotation angles of near-decoupled pairs, so the f32
    bases differ by up to ~5e-4 (each is as far from the f64 sweep); both
    are held to Q'HQ = A, and the f64 sweeps agree to roundoff."""
    batch = _wide_spectrum_batch(np.random.default_rng(0), 16)
    eye = np.broadcast_to(np.eye(D, dtype=np.float32), batch.shape)
    norm = np.linalg.norm(batch, axis=(1, 2))[:, None, None]
    Aj, Qj = _one_sweep(jnp.asarray(batch), jnp.asarray(eye), interpret=True)
    At, Qt = eigh.jacobi_sweep_plain(torch.tensor(batch), torch.tensor(eye))
    assert np.max(np.abs(At.numpy() - np.asarray(Aj)) / norm) < 1e-4
    assert np.max(np.abs(Qt.numpy() - np.asarray(Qj))) < 1e-3
    H64 = batch.astype(np.float64)
    for A, Q in ((At.numpy(), Qt.numpy()), (np.asarray(Aj), np.asarray(Qj))):
        Q = Q.astype(np.float64)
        R = np.einsum("bji,bjk,bkl->bil", Q, H64, Q)
        assert np.max(np.abs(R - A) / norm) < 1e-6

    eye64 = eye.astype(np.float64)
    Aj, Qj = _one_sweep(jnp.asarray(H64), jnp.asarray(eye64), interpret=True)
    At, Qt = eigh.jacobi_sweep_plain(torch.tensor(H64), torch.tensor(eye64))
    assert np.max(np.abs(At.numpy() - np.asarray(Aj)) / norm) < 1e-12
    assert np.max(np.abs(Qt.numpy() - np.asarray(Qj))) < 1e-11


def _quality(batch, w, Q):
    w = w.double().numpy()
    Q = Q.double().numpy()
    w64 = np.linalg.eigvalsh(batch.astype(np.float64))
    err = np.max(np.abs(np.sort(w, axis=-1) - w64))
    orth = np.max(np.abs(np.einsum("bji,bjk->bik", Q, Q) - np.eye(D)))
    resid = np.einsum("bij,bjk->bik", batch.astype(np.float64), Q) \
        - w[:, None, :] * Q
    return err, orth, np.max(np.abs(resid)) / np.linalg.norm(batch[0])


def test_jacobi_eigh_wide_spectrum():
    batch = _wide_spectrum_batch(np.random.default_rng(0), 16)
    w, Q, sweeps = eigh.jacobi_eigh(torch.tensor(batch), max_sweeps=10,
                                    tol=1e-6, sweep=eigh.jacobi_sweep_plain)
    err, orth, rel = _quality(batch, w, Q)
    assert err < 5e-3, err
    assert orth < 1e-4, orth
    assert rel < 1e-4, rel
    assert 1 <= sweeps <= 10


def test_jacobi_eigh_rows_do_not_depend_on_batch_size():
    """The same rows alone and inside a wider batch: identical eigenpairs
    when both runs take the same number of sweeps (the stopping rule looks
    at the whole batch)."""
    batch = _wide_spectrum_batch(np.random.default_rng(3), 16)
    w_a, Q_a, s_a = eigh.jacobi_eigh(torch.tensor(batch[:5]), max_sweeps=10)
    w_b, Q_b, s_b = eigh.jacobi_eigh(torch.tensor(batch), max_sweeps=10)
    assert s_a == s_b < 10
    np.testing.assert_allclose(w_a.numpy(), w_b[:5].numpy(), rtol=0,
                               atol=1e-6 * np.abs(batch).max())
    np.testing.assert_allclose(Q_a.numpy(), Q_b[:5].numpy(), rtol=0,
                               atol=1e-6)
    err, orth, rel = _quality(batch[:5], w_a, Q_a)
    assert err < 5e-3 and orth < 1e-4 and rel < 1e-4, (err, orth, rel)


def test_warm_start_and_padding():
    """A 41x41 Hessian padded to 42 with the Gershgorin entry, warm-started
    from a nearby basis: the padded eigenvalue is the largest, and the
    others are the unpadded matrix's."""
    rng = np.random.default_rng(5)
    H = _wide_spectrum_batch(rng, 4)[:, :41, :41].astype(np.float64)
    Hp, gp = pad_to_even(torch.tensor(H), torch.ones(4, 41, dtype=torch.float64))
    assert Hp.shape == (4, 42, 42) and gp.shape == (4, 42)
    assert torch.all(gp[:, 41] == 0)
    _, Q0 = torch.linalg.eigh(Hp + 1e-3 * torch.eye(42, dtype=torch.float64))
    w, Q, sweeps = eigh.jacobi_eigh(Hp, Q0, tol=1e-10, max_sweeps=10)
    w = np.sort(w.numpy(), axis=-1)
    np.testing.assert_allclose(w[:, :41], np.linalg.eigvalsh(H),
                               atol=1e-8 * np.abs(H).max())
    assert np.all(w[:, 41] == Hp[:, 41, 41].numpy())



def test_split_sweep_twin_matches_fused_and_jax():
    """The split sweep's plain twin (A phase, then the Q replay of its
    (c, s) log) equals the fused sweep, and JAX's split route
    (CELESTE_EIGH_FUSED=0: _sweep_a_kernel + _sweep_q_kernel, interpret
    mode). f64, to 1e-12 of ||H||: the same rotations in the same order."""
    import os

    batch = _wide_spectrum_batch(np.random.default_rng(2), 8)
    H = batch.astype(np.float64)
    eye = np.broadcast_to(np.eye(D), H.shape).copy()
    norm = np.linalg.norm(H, axis=(1, 2))[:, None, None]
    A_s, cs = eigh.jacobi_sweep_a_plain(torch.tensor(H))
    assert cs.shape == (8, D - 1, 2, D // 2)
    Q_s = eigh.jacobi_replay_q_plain(torch.tensor(eye), cs)
    A_f, Q_f = eigh.jacobi_sweep_plain(torch.tensor(H), torch.tensor(eye))
    assert np.max(np.abs(A_s.numpy() - A_f.numpy()) / norm) < 1e-12
    assert np.max(np.abs(Q_s.numpy() - Q_f.numpy())) < 1e-12
    # the split route is chosen while _one_sweep is traced
    prev = os.environ.get("CELESTE_EIGH_FUSED")
    os.environ["CELESTE_EIGH_FUSED"] = "0"
    _one_sweep.clear_cache()
    try:
        Aj, Qj = _one_sweep(jnp.asarray(H), jnp.asarray(eye), interpret=True)
    finally:
        if prev is None:
            os.environ.pop("CELESTE_EIGH_FUSED")
        else:
            os.environ["CELESTE_EIGH_FUSED"] = prev
        _one_sweep.clear_cache()
    assert np.max(np.abs(A_s.numpy() - np.asarray(Aj)) / norm) < 1e-12
    assert np.max(np.abs(Q_s.numpy() - np.asarray(Qj))) < 1e-12


def test_fit_with_split_sweep_matches_fused(monkeypatch):
    """NewtonConfig.eigh_fused=False (the split sweep) fits as the fused
    sweep does: the same iterations per lane, the same ELBOs (f64)."""
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources

    _, vp0s, p = synthetic_patch_batch(2, tile=16, seed=4, dtype=np.float64,
                                       device="cpu")
    vp = torch.tensor(vp0s)
    cfg = NewtonConfig(tr_solver="pjacobi", jacobi_max_sweeps=4,
                       tr_kernel="pallas", refresh_kernel="pallas",
                       max_iters=3)
    fused = fit_sources(vp, p, config=cfg)
    calls = []
    a_phase = eigh.jacobi_sweep_a_plain
    monkeypatch.setattr(eigh, "jacobi_sweep_a_plain",
                        lambda A: calls.append(1) or a_phase(A))
    split = fit_sources(vp, p, config=cfg._replace(eigh_fused=False))
    assert calls                      # the fit went through the split sweep
    assert torch.equal(fused.iters, split.iters)
    np.testing.assert_allclose(split.elbo.numpy(), fused.elbo.numpy(),
                               rtol=1e-12)


def _kernel_sweep(A, Q):
    """csrc/jacobi_sweep.cu's schedule in numpy, with the kernel's index
    formulas: A ping-pongs between two buffers, each source 2x2 block is
    rotated and written to its permuted place (pinv); the next round's
    (c, s) come from entries recomputed out of the round's source blocks;
    Q's columns sit in label order and each pair slot's two labels step
    down by one a round (mod D-1). Returns (A, Q, the (B, D-1, 2, K) log of
    each round's (c, s), as the split sweep's K2a writes it)."""
    B, D, _ = A.shape
    K, m = D // 2, D - 1
    perm = lambda j: ((j >> 1 if j >> 1 < 2 else j - 2) if j % 2 == 0
                      else (j + 2 if j >> 1 < K - 1 else D - 2))
    pinv = lambda i: (0 if i == 0 else 2 if i == 1 else i - 2 if i % 2
                      else D - 1 if i == D - 2 else i + 2)
    label0 = np.array([D - 1 - (j >> 1) if j % 2 else j >> 1
                       for j in range(D)])
    rot = lambda own, other, c, sgn_s: c * own + sgn_s * other

    def round_cs(app, aqq, apq):
        # the twin's (c, s) of 2x2 blocks [[app, apq], [apq, aqq]] (torch's
        # CPU sqrt, as the twin takes it)
        blocks = np.stack([np.stack([app, apq], -1),
                           np.stack([apq, aqq], -1)], -2)
        c, s = eigh._round_cs(torch.tensor(blocks.reshape(-1, 2, 2)))
        return np.stack([c.numpy(), s.numpy()], -1).reshape(app.shape + (2,))

    def entry(a, cs, x, y):
        """Entry (x, y) of the next round's A, from its source block."""
        ka, kb = x >> 1, y >> 1
        ca, cb = cs[:, ka], cs[:, kb]
        sa = np.where(x % 2 == 1, ca[..., 1], -ca[..., 1])
        sb = np.where(y % 2 == 1, cb[..., 1], -cb[..., 1])
        bi = np.arange(a.shape[0])[:, None]
        t0 = rot(a[bi, x, 2 * kb], a[bi, x ^ 1, 2 * kb], ca[..., 0], sa)
        t1 = rot(a[bi, x, 2 * kb + 1], a[bi, x ^ 1, 2 * kb + 1], ca[..., 0],
                 sa)
        return np.where(y % 2 == 1, rot(t1, t0, cb[..., 0], sb),
                        rot(t0, t1, cb[..., 0], sb))

    ks = np.arange(K)
    log = np.empty((B, D - 1, 2, K))
    a = [A.copy(), np.empty_like(A)]
    q = np.empty_like(Q)
    q[:, :, label0] = Q
    cs = round_cs(A[:, 2 * ks, 2 * ks], A[:, 2 * ks + 1, 2 * ks + 1],
                  A[:, 2 * ks, 2 * ks + 1])
    pa = np.array([perm(2 * k) for k in ks])
    qb = np.array([perm(2 * k + 1) for k in ks])
    pl, ql = ks.copy(), D - 1 - ks
    k1, k2 = np.meshgrid(ks, ks, indexing="ij")
    r0 = np.vectorize(pinv)(2 * k1)
    r1 = np.vectorize(pinv)(2 * k1 + 1)
    c0 = np.vectorize(pinv)(2 * k2)
    c1 = np.vectorize(pinv)(2 * k2 + 1)
    for r in range(D - 1):
        log[:, r] = cs.transpose(0, 2, 1)     # K2a's log: warp 0's (c, s)
        src, dst = a[r % 2], a[(r + 1) % 2]
        if r < D - 2:
            nxt = round_cs(entry(src, cs, pa, pa), entry(src, cs, qb, qb),
                           entry(src, cs, pa, qb))
        ca, cb = cs[:, k1], cs[:, k2]
        x00, x01 = src[:, 2 * k1, 2 * k2], src[:, 2 * k1, 2 * k2 + 1]
        x10, x11 = src[:, 2 * k1 + 1, 2 * k2], src[:, 2 * k1 + 1, 2 * k2 + 1]
        t00 = rot(x00, x10, ca[..., 0], -ca[..., 1])
        t01 = rot(x01, x11, ca[..., 0], -ca[..., 1])
        t10 = rot(x10, x00, ca[..., 0], ca[..., 1])
        t11 = rot(x11, x01, ca[..., 0], ca[..., 1])
        dst[:, r0, c0] = rot(t00, t01, cb[..., 0], -cb[..., 1])
        dst[:, r0, c1] = rot(t01, t00, cb[..., 0], cb[..., 1])
        dst[:, r1, c0] = rot(t10, t11, cb[..., 0], -cb[..., 1])
        dst[:, r1, c1] = rot(t11, t10, cb[..., 0], cb[..., 1])
        x, y = q[:, :, pl], q[:, :, ql]
        c, s = cs[:, None, :, 0], cs[:, None, :, 1]
        q[:, :, pl], q[:, :, ql] = rot(x, y, c, -s), rot(y, x, c, s)
        pl = np.where(ks == 0, 0, np.where(pl == 1, m, pl - 1))
        ql = np.where(ql == 1, m, ql - 1)
        if r < D - 2:
            # the recomputed entries are the ones the round stored
            want = round_cs(dst[:, 2 * ks, 2 * ks],
                            dst[:, 2 * ks + 1, 2 * ks + 1],
                            dst[:, 2 * ks, 2 * ks + 1])
            assert np.array_equal(nxt, want)
            cs = nxt
    return a[(D - 1) % 2], q[:, :, label0], log


def test_kernel_schedule_is_the_plain_sweep():
    """The fused sweep kernel's index formulas (its permutation and inverse,
    Q's label columns and their counters, the next round's (c, s) from
    recomputed entries), replayed in numpy in f64, give the plain twin's
    bits at D = 4, 6, 42 and 64: the permutation has order D-1, so Q's
    labels are back in place after a sweep."""
    rng = np.random.default_rng(5)
    for n in (4, 6, 42, 64):
        x = rng.standard_normal((3, n, n))
        A = x + x.transpose(0, 2, 1)
        Q = np.linalg.qr(rng.standard_normal((3, n, n)))[0]
        Ak, Qk, _ = _kernel_sweep(A, Q)
        Ap, Qp = eigh.jacobi_sweep_plain(torch.tensor(A), torch.tensor(Q))
        assert np.array_equal(Ak, Ap.numpy()), n
        assert np.array_equal(Qk, Qp.numpy()), n


def test_kernel_log_is_the_plain_log():
    """K2a runs K2's round engine and logs the (c, s) its warp 0 computes
    each round (round 0's from A, later ones from recomputed entries): that
    log, in the kernel's replay above, is jacobi_sweep_a_plain's bit for bit
    at D = 4, 6, 42 and 64 (f64)."""
    rng = np.random.default_rng(6)
    for n in (4, 6, 42, 64):
        x = rng.standard_normal((2, n, n))
        A = x + x.transpose(0, 2, 1)
        Ak, _, log = _kernel_sweep(A, np.eye(n)[None].repeat(2, 0))
        Ap, csp = eigh.jacobi_sweep_a_plain(torch.tensor(A))
        assert np.array_equal(Ak, Ap.numpy()), n
        assert np.array_equal(log, csp.numpy()), n


def _kernel_replay(Q, cs, pairs):
    """csrc/jacobi_sweep_split.cu's K2b in numpy, with the kernel's index
    formulas: blocks of M = 128 // D matrices; each block's log staged as
    (c, s) pairs into rows padded to `pairs` pairs (2 in f32, 1 in f64);
    a thread a row of Q, label 0 in q0 and labels 1..D-1 round-relative in
    u (u[i] is label 1 + (i - r) mod (D-1) in round r): pair 0 is (q0,
    u[L-1]) and pair k > 0 (u[k-1], u[L-1-k]) in every round, each result
    one place up in v, the next round's layout, then stored back through
    label0."""
    B, D, _ = Q.shape
    K, L, M = D // 2, D - 1, 128 // D
    stride = -(-2 * K // (2 * pairs)) * 2 * pairs
    label0 = [D - 1 - (j >> 1) if j % 2 else j >> 1 for j in range(D)]
    out = np.empty_like(Q)
    for b0 in range(0, B, M):
        nm = min(M, B - b0)
        src = cs[b0:b0 + nm].reshape(-1, 2)      # the block's log, in pairs
        ls = np.full(M * L * stride, np.nan)
        for v in range(nm * L * K):
            row, e = v // K, 2 * (v - (v // K) * K)
            ls[row * stride + 2 * (e % K) + e // K] = src[v, 0]
            ls[row * stride + 2 * ((e + 1) % K) + (e + 1) // K] = src[v, 1]
        rows = Q[b0:b0 + nm].reshape(nm * D, D)  # thread t: row t
        m = np.arange(nm * D) // D
        q0, u = np.empty(nm * D), np.empty((nm * D, L))
        for j in range(D):
            if label0[j] == 0:
                q0 = rows[:, j].copy()
            else:
                u[:, label0[j] - 1] = rows[:, j]
        for r in range(L):
            v = np.full_like(u, np.nan)
            for k in range(K):
                at = m * L * stride + r * stride + 2 * k
                c, s = ls[at], ls[at + 1]
                x, y = (q0 if k == 0 else u[:, k - 1]), u[:, L - 1 - k]
                xn = c * x + (-s) * y
                if k == 0:
                    q0 = xn
                else:
                    v[:, k] = xn
                v[:, (L - k) % L] = c * y + s * x
            u = v
        rows = np.stack([q0 if label0[j] == 0 else u[:, label0[j] - 1]
                         for j in range(D)], axis=1)
        out[b0:b0 + nm] = rows.reshape(nm, D, D)
    return out


def test_replay_kernel_schedule_is_the_plain_replay():
    """K2b's index formulas (its blocks of several matrices, the log's
    staging into padded (c, s) rows for either type's loads, Q's labels in
    the round-relative layout and its shift by one place a round), replayed
    in numpy in f64 on a log of the plain A phase, give
    jacobi_replay_q_plain's bits at D = 4, 6, 42 and 64, with the last
    block part full: after D-1 rounds the labels are back in place."""
    rng = np.random.default_rng(8)
    for n in (4, 6, 42, 64):
        B = 128 // n + 1
        x = rng.standard_normal((B, n, n))
        _, cs = eigh.jacobi_sweep_a_plain(torch.tensor(x + x.transpose(0, 2,
                                                                       1)))
        Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
        want = eigh.jacobi_replay_q_plain(torch.tensor(Q), cs).numpy()
        for pairs in (2, 1):
            assert np.array_equal(_kernel_replay(Q, cs.numpy(), pairs),
                                  want), (n, pairs)


def test_sweep_sizes_match_the_kernel_dispatch():
    """SWEEP_DIMS is the list of sizes jacobi_sweep.cuh's dispatch
    instantiates (K2, K2a and K2b), and the wrappers' check takes exactly
    those."""
    import re

    cu = os.path.join(os.path.dirname(eigh.__file__), "..", "csrc",
                      "jacobi_sweep.cuh")
    with open(cu) as f:
        src = f.read()
    macro = src[src.index("#define CELESTE_SWEEP_DIMS"):]
    macro = macro[:macro.index("\n\n")]
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", macro)) == (
        eigh.SWEEP_DIMS)
    for n in range(0, 70):
        A = torch.zeros(2, n, n)
        if n in eigh.SWEEP_DIMS:
            assert eigh._check_batch("x", A, A) == (2, n)
        else:
            with pytest.raises(ValueError):
                eigh._check_batch("x", A, A)
