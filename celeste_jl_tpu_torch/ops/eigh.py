"""Batched symmetric eigensolver by warm-started parallel Jacobi (port of
celeste_jl_tpu/ops/pallas_eigh.py, the tr_solver="pjacobi" path).

One sweep is D-1 rounds of D/2 simultaneous rotations on the pairs at
positions (2k, 2k+1), each applied to the rows and columns of A and the
columns of Q, followed by the circle-method permutation
(ops/jacobi._round_robin_perm). `jacobi_sweep` launches the CUDA kernel
csrc/jacobi_sweep.cu on CUDA tensors and runs `jacobi_sweep_plain`, its
plain torch twin, on CPU tensors.

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


def jacobi_sweep_plain(A, Q):
    """One cyclic parallel-Jacobi sweep of a (B, D, D) batch, D even, in
    eager torch. Returns new (A, Q)."""
    B, D, _ = A.shape
    K = D // 2
    perm = torch.as_tensor(_round_robin_perm(D), device=A.device)
    ev = torch.arange(0, D, 2, device=A.device)
    od = ev + 1
    for _ in range(D - 1):
        app, aqq, apq = A[:, ev, ev], A[:, od, od], A[:, ev, od]   # (B, K)
        live = torch.abs(apq) > 1e-30
        tau = (aqq - app) / (2.0 * torch.where(live, apq, 1.0))
        sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
        t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(live, t, 0.0)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c

        y = A.reshape(B, K, 2, D)                        # row pairs
        r0, r1 = _rotate_pairs(y[:, :, 0], y[:, :, 1], c[..., None],
                               s[..., None])
        A = torch.stack([r0, r1], dim=2).reshape(B, D, D)
        y = A.reshape(B, D, K, 2)                        # column pairs
        c0, c1 = _rotate_pairs(y[..., 0], y[..., 1], c[:, None], s[:, None])
        A = torch.stack([c0, c1], dim=-1).reshape(B, D, D)
        A = A[:, perm][:, :, perm]

        y = Q.reshape(B, D, K, 2)
        q0, q1 = _rotate_pairs(y[..., 0], y[..., 1], c[:, None], s[:, None])
        Q = torch.stack([q0, q1], dim=-1).reshape(B, D, D)[:, :, perm]
    return A, Q


def jacobi_sweep(A, Q):
    """One sweep, same contract as `jacobi_sweep_plain`:
    csrc/jacobi_sweep.cu on CUDA tensors (f32 or f64, even D <= 64), the
    plain twin on CPU tensors. Anything else raises."""
    if A.device.type == "cpu":
        return jacobi_sweep_plain(A, Q)
    _build.check_cuda(A.dtype, A.device)
    B, D = A.shape[0], A.shape[-1]
    if (A.shape != (B, D, D) or Q.shape != A.shape or D % 2 or not
            4 <= D <= 64):
        raise ValueError(f"jacobi_sweep: A {tuple(A.shape)}, Q "
                         f"{tuple(Q.shape)}; needs (B, D, D), even D <= 64")
    A = A.contiguous()
    Q = Q.to(A.dtype).contiguous()
    Ao = torch.empty_like(A)
    Qo = torch.empty_like(Q)
    if B:
        _build.launch("jacobi_sweep", A.dtype, A, Q, Ao, Qo, B, D)
        jacobi_sweep.launches += 1
    return Ao, Qo


jacobi_sweep.launches = 0


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
