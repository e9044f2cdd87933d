"""Batched symmetric eigensolver by warm-started parallel Jacobi (port of
celeste_jl_tpu/ops/pallas_eigh.py, the tr_solver="pjacobi" path).

One sweep is D-1 rounds of D/2 simultaneous rotations on the pairs at
positions (2k, 2k+1), each applied to the rows and columns of A and the
columns of Q, followed by the circle-method permutation
(ops/jacobi._round_robin_perm). `jacobi_sweep` launches the CUDA kernel
csrc/jacobi_sweep.cu on CUDA tensors and runs `jacobi_sweep_plain`, its
plain torch twin, on CPU tensors.

`jacobi_sweep_split` is the same sweep in two launches (the JAX package's
CELESTE_EIGH_FUSED=0 route, NewtonConfig.eigh_fused=False):
`jacobi_sweep_a` rotates A through the rounds and writes a (B, D-1, 2, K)
log of each round's (c, s), and `jacobi_replay_q` replays the log on Q
(csrc/jacobi_sweep_split.cu; plain twins `jacobi_sweep_a_plain`,
`jacobi_replay_q_plain`). Same rotation formula and permutation as the
fused sweep: the split kernels give the fused kernel's bits, the split
twins the fused twin's.

`jacobi_eigh` drives the sweeps like JAX `pallas_jacobi_eigh`: a warm
start M = Q0' H Q0, then per sweep the kernel, one Newton-Schulz step on Q
and the re-formation M = Q' H Q as f32 (never TF32) matmuls, until no
matrix in the batch has off-diagonal norm above tol ||H|| or after
max_sweeps. Eigenvalues come back unsorted.
"""

import torch

from . import _build
from .jacobi import _round_robin_perm


def _rotate_pairs(y0, y1, c, s):
    """(c y0 - s y1, c y1 + s y0), the rotation of one pair of rows or
    columns, written as the JAX kernel's fma chain."""
    return c * y0 + (-s) * y1, c * y1 + s * y0


def _round_cs(A):
    """(c, s) of one round's rotations, each (B, K), from the round's
    starting A: zero angle where |a_pq| <= 1e-30."""
    D = A.shape[-1]
    ev = torch.arange(0, D, 2, device=A.device)
    od = ev + 1
    app, aqq, apq = A[:, ev, ev], A[:, od, od], A[:, ev, od]   # (B, K)
    live = torch.abs(apq) > 1e-30
    tau = (aqq - app) / (2.0 * torch.where(live, apq, 1.0))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(live, t, 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _rotate_a(A, c, s, perm):
    """Rows, then columns of A rotated by one round's (c, s), then both
    permuted."""
    B, D, _ = A.shape
    K = D // 2
    y = A.reshape(B, K, 2, D)                        # row pairs
    r0, r1 = _rotate_pairs(y[:, :, 0], y[:, :, 1], c[..., None],
                           s[..., None])
    A = torch.stack([r0, r1], dim=2).reshape(B, D, D)
    y = A.reshape(B, D, K, 2)                        # column pairs
    c0, c1 = _rotate_pairs(y[..., 0], y[..., 1], c[:, None], s[:, None])
    A = torch.stack([c0, c1], dim=-1).reshape(B, D, D)
    return A[:, perm][:, :, perm]


def _rotate_q(Q, c, s, perm):
    """Columns of Q rotated by one round's (c, s), then permuted."""
    B, D, _ = Q.shape
    y = Q.reshape(B, D, D // 2, 2)
    q0, q1 = _rotate_pairs(y[..., 0], y[..., 1], c[:, None], s[:, None])
    return torch.stack([q0, q1], dim=-1).reshape(B, D, D)[:, :, perm]


def jacobi_sweep_plain(A, Q):
    """One cyclic parallel-Jacobi sweep of a (B, D, D) batch, D even, in
    eager torch. Returns new (A, Q)."""
    perm = torch.as_tensor(_round_robin_perm(A.shape[-1]), device=A.device)
    for _ in range(A.shape[-1] - 1):
        c, s = _round_cs(A)
        A = _rotate_a(A, c, s, perm)
        Q = _rotate_q(Q, c, s, perm)
    return A, Q


def jacobi_sweep_a_plain(A):
    """The A half of a sweep: returns (A after the sweep, the (c, s) log
    (B, D-1, 2, K) of its rounds)."""
    perm = torch.as_tensor(_round_robin_perm(A.shape[-1]), device=A.device)
    log = []
    for _ in range(A.shape[-1] - 1):
        c, s = _round_cs(A)
        A = _rotate_a(A, c, s, perm)
        log.append(torch.stack([c, s], dim=1))
    return A, torch.stack(log, dim=1)


def jacobi_replay_q_plain(Q, cs):
    """The Q half of a sweep: the rounds of the (B, D-1, 2, K) log `cs`
    replayed on Q."""
    perm = torch.as_tensor(_round_robin_perm(Q.shape[-1]), device=Q.device)
    for r in range(cs.shape[1]):
        Q = _rotate_q(Q, cs[:, r, 0], cs[:, r, 1], perm)
    return Q


def jacobi_sweep_split_plain(A, Q):
    """`jacobi_sweep_plain` as its A phase, then its Q replay."""
    A, cs = jacobi_sweep_a_plain(A)
    return A, jacobi_replay_q_plain(Q, cs)


# the sizes the sweep kernels are compiled for (jacobi_sweep.cuh's
# CELESTE_SWEEP_DIMS): every even D in [4, 64]
SWEEP_DIMS = tuple(range(4, 65, 2))


def _check_batch(name, A, Q):
    B, D = A.shape[0], A.shape[-1]
    if A.shape != (B, D, D) or Q.shape != A.shape or D not in SWEEP_DIMS:
        raise ValueError(f"{name}: A {tuple(A.shape)}, Q "
                         f"{tuple(Q.shape)}; needs (B, D, D), even D in "
                         f"[4, 64]")
    return B, D


def jacobi_sweep(A, Q):
    """One sweep, same contract as `jacobi_sweep_plain`:
    csrc/jacobi_sweep.cu on CUDA tensors (f32 or f64, D in SWEEP_DIMS), the
    plain twin on CPU tensors. Anything else raises."""
    if A.device.type == "cpu":
        return jacobi_sweep_plain(A, Q)
    _build.check_cuda(A.dtype, A.device)
    B, D = _check_batch("jacobi_sweep", A, Q)
    A = A.contiguous()
    Q = Q.to(A.dtype).contiguous()
    Ao = torch.empty_like(A)
    Qo = torch.empty_like(Q)
    if B:
        _build.launch("jacobi_sweep", A.dtype, A, Q, Ao, Qo, B, D)
        jacobi_sweep.launches += 1
    return Ao, Qo


jacobi_sweep.launches = 0


def jacobi_sweep_a(A):
    """The A phase of a split sweep, same contract as
    `jacobi_sweep_a_plain`: csrc/jacobi_sweep_split.cu (K2a) on CUDA
    tensors, the plain twin on CPU tensors."""
    if A.device.type == "cpu":
        return jacobi_sweep_a_plain(A)
    _build.check_cuda(A.dtype, A.device)
    B, D = _check_batch("jacobi_sweep_a", A, A)
    A = A.contiguous()
    Ao = torch.empty_like(A)
    cs = torch.empty((B, D - 1, 2, D // 2), dtype=A.dtype, device=A.device)
    if B:
        _build.launch("jacobi_sweep_a", A.dtype, A, Ao, cs, B, D)
        jacobi_sweep_a.launches += 1
    return Ao, cs


jacobi_sweep_a.launches = 0


def jacobi_replay_q(Q, cs):
    """The Q replay of a split sweep, same contract as
    `jacobi_replay_q_plain`: csrc/jacobi_sweep_split.cu (K2b) on CUDA
    tensors, the plain twin on CPU tensors."""
    if Q.device.type == "cpu":
        return jacobi_replay_q_plain(Q, cs)
    _build.check_cuda(Q.dtype, Q.device)
    B, D = _check_batch("jacobi_replay_q", Q, Q)
    if cs.shape != (B, D - 1, 2, D // 2):
        raise ValueError(f"jacobi_replay_q: log {tuple(cs.shape)}, needs "
                         f"{(B, D - 1, 2, D // 2)}")
    # K2b loads Q and the log in 16-byte vectors from where they start
    Q, cs = (t if t.data_ptr() % 16 == 0 else t.clone()
             for t in (Q.contiguous(), cs.to(Q.dtype).contiguous()))
    Qo = torch.empty_like(Q)
    if B:
        _build.launch("jacobi_replay_q", Q.dtype, Q, cs, Qo, B, D)
        jacobi_replay_q.launches += 1
    return Qo


jacobi_replay_q.launches = 0


def jacobi_sweep_split(A, Q):
    """One sweep in two launches, K2a then K2b; same contract as
    `jacobi_sweep`."""
    A, cs = jacobi_sweep_a(A)
    return A, jacobi_replay_q(Q.to(A.dtype), cs)


def offdiag_norm(M):
    # an explicit diagonal mask: sum(M^2) - sum(diag^2) cancels in f32
    off = M * (1.0 - torch.eye(M.shape[-1], dtype=M.dtype, device=M.device))
    return torch.sqrt(torch.sum(off * off, dim=(-1, -2)))


def jacobi_eigh(H, Q0=None, tol=1e-6, max_sweeps=10, sweep=jacobi_sweep):
    """Batched (B, D, D) symmetric eigendecomposition, warm-startable from
    Q0. Returns (w (B, D) unsorted, Q (B, D, D), sweeps).

    The stopping rule looks at the whole batch, frozen lanes included
    (one device-to-host read per sweep), as JAX pallas_jacobi_eigh does."""
    D = H.shape[-1]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    if Q0 is None:
        M = H
        Q = eye.expand(H.shape)
    else:
        M = Q0.mT @ H @ Q0
        Q = Q0
    ref = torch.sqrt(torch.sum(H * H, dim=(-1, -2)))
    sweeps = 0
    while sweeps < max_sweeps and bool(torch.any(offdiag_norm(M) > tol * ref)):
        M, Q = sweep(M.contiguous(), Q.contiguous())
        QtQ = Q.mT @ Q
        Q = Q @ (1.5 * eye - 0.5 * QtQ)
        M = Q.mT @ H @ Q
        sweeps += 1
    return torch.diagonal(M, dim1=-2, dim2=-1), Q, sweeps
