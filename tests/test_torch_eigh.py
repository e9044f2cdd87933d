"""The port's parallel-Jacobi eigensolver (ops/eigh.py): the plain sweep,
fused and split, against the JAX package's Pallas sweeps (interpret mode),
jacobi_eigh at the bars of tests/test_pallas_eigh.py:46-54, the same rows
at two batch sizes, and a fit through the split sweep. The CUDA sweeps are
held to the plain ones in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
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
