"""Batched trust-region subproblem in the eigenbasis (port of
celeste_jl_tpu/ops/pallas_tr.py and newton._solve_tr_eig).

Per lane: argmin gq.p + 0.5 p' diag(w) p subject to ||p|| <= delta, by an
interior Newton-step check, `bisect_iters` bisections of the secular
equation ||(w + lam)^-1 gq|| = delta, and the hard-case ridge along the
bottom eigenvector (first index on ties, as argmin). w need not be sorted.

`tr_subproblem` launches the CUDA kernel csrc/tr_subproblem.cu on CUDA
tensors and runs `tr_subproblem_plain`, its plain torch twin, on CPU
tensors. `tr_subproblem_newton` solves the secular equation by
safeguarded Newton instead of bisection, in torch on every device.
"""

import torch

from . import _build


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def tr_subproblem_plain(gq, w, delta, bisect_iters=48):
    """gq, w (B, D), delta (B,) -> (p (B, D), predicted reduction (B,) >= 0)
    in eager torch."""
    D = gq.shape[-1]
    bottom = torch.argmin(w, dim=-1)
    lam_min = torch.gather(w, -1, bottom[:, None])[:, 0]
    eps = 1e-12

    safe_w = torch.where(w > eps, w, 1.0)
    p_newton = -(gq / safe_w)
    interior = (lam_min > eps) & (_norm(p_newton) <= delta)

    shift = torch.clamp(-lam_min, min=0.0)
    lo = shift + eps
    hi = torch.maximum(lo * 2.0 + 1.0,
                       _norm(gq) / torch.clamp(delta, min=eps) + shift + 1.0)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        too_big = _norm(gq / (w + mid[:, None])) > delta   # need larger lam
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    p_boundary = -(gq / (w + lam[:, None]))

    # Hard case: gq has (almost) no component along the bottom eigenvector,
    # so ||p(lam)|| stays short of delta; move along it to the boundary.
    bnorm = _norm(p_boundary)
    tau = torch.sqrt(torch.clamp(delta ** 2 - bnorm ** 2, min=0.0))
    hard = (bnorm < 0.9 * delta) & (lam_min < eps)
    e0 = torch.nn.functional.one_hot(bottom, D).to(gq.dtype)
    p = torch.where(interior[:, None], p_newton,
                    torch.where(hard[:, None], p_boundary + tau[:, None] * e0,
                                p_boundary))
    pred = -(torch.sum(gq * p, dim=-1) + 0.5 * torch.sum(p * (w * p), dim=-1))
    return p, torch.clamp(pred, min=0.0)


def tr_subproblem_newton(gq, w, delta, iters=16):
    """The same subproblem with `iters` safeguarded Newton iterations on the
    secular equation 1/delta - 1/||p(lam)|| = 0 in place of bisection (JAX
    newton._solve_tr_eig, secular="newton"; More-Sorensen / Nocedal-Wright
    Alg. 4.3 in the eigenbasis). The JAX package computes it outside its
    TR kernel, so this is plain torch on every device.
    gq, w (B, D), delta (B,) -> (p (B, D), predicted reduction (B,) >= 0)."""
    D = gq.shape[-1]
    bottom = torch.argmin(w, dim=-1)
    lam_min = torch.gather(w, -1, bottom[:, None])[:, 0]
    eps = 1e-12

    safe_w = torch.where(w > eps, w, 1.0)
    p_newton = -(gq / safe_w)
    interior = (lam_min > eps) & (_norm(p_newton) <= delta)

    shift = torch.clamp(-lam_min, min=0.0)
    lo = shift + eps
    hi = torch.maximum(lo * 2.0 + 1.0,
                       _norm(gq) / torch.clamp(delta, min=eps) + shift + 1.0)
    lam = 0.5 * (lo + hi)
    for _ in range(iters):
        q = gq / (w + lam[:, None])
        n2 = torch.sum(q * q, dim=-1)                 # ||p(lam)||^2
        n = torch.sqrt(n2)
        too_big = n > delta                           # need larger lam
        lo = torch.where(too_big, lam, lo)
        hi = torch.where(too_big, hi, lam)
        s3 = torch.sum(q * (q / (w + lam[:, None])), dim=-1)
        step = ((n / torch.clamp(delta, min=eps) - 1.0) * n2
                / torch.clamp(s3, min=eps))
        nxt = lam + step
        # inclusive bracket: a converged iterate sits on an edge
        good = torch.isfinite(nxt) & (nxt >= lo) & (nxt <= hi)
        lam = torch.where(good, nxt, 0.5 * (lo + hi))
    p_boundary = -(gq / (w + lam[:, None]))

    bnorm = _norm(p_boundary)
    tau = torch.sqrt(torch.clamp(delta ** 2 - bnorm ** 2, min=0.0))
    hard = (bnorm < 0.9 * delta) & (lam_min < eps)
    e0 = torch.nn.functional.one_hot(bottom, D).to(gq.dtype)
    p = torch.where(interior[:, None], p_newton,
                    torch.where(hard[:, None], p_boundary + tau[:, None] * e0,
                                p_boundary))
    pred = -(torch.sum(gq * p, dim=-1) + 0.5 * torch.sum(p * (w * p), dim=-1))
    return p, torch.clamp(pred, min=0.0)


def tr_subproblem(gq, w, delta, bisect_iters=48):
    """Same contract as `tr_subproblem_plain`: csrc/tr_subproblem.cu on
    CUDA tensors (f32 or f64, 1 <= D <= 64), the plain twin on CPU tensors.
    Anything else raises."""
    if gq.device.type == "cpu":
        return tr_subproblem_plain(gq, w, delta, bisect_iters)
    dtype = gq.dtype
    _build.check_cuda(dtype, gq.device)
    B, D = gq.shape
    if w.shape != (B, D) or delta.shape != (B,) or not 1 <= D <= 64:
        raise ValueError(f"tr_subproblem: gq {tuple(gq.shape)}, w "
                         f"{tuple(w.shape)}, delta {tuple(delta.shape)}")
    if not gq.is_contiguous():
        gq = gq.contiguous()
    if w.dtype != dtype or not w.is_contiguous():
        w = w.to(dtype).contiguous()
    if delta.dtype != dtype or not delta.is_contiguous():
        delta = delta.to(dtype).contiguous()
    p = torch.empty_like(gq)
    pred = torch.empty_like(delta)
    if B:
        _build.launch("tr_subproblem", dtype, gq, w, delta, p, pred, B, D,
                      bisect_iters)
        tr_subproblem.launches += 1
    return p, pred


tr_subproblem.launches = 0
