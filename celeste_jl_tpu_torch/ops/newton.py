"""Batched Newton trust-region minimizer (port of
celeste_jl_tpu/ops/newton.py, for tr_solver "eig" and "pjacobi").

The JAX package vmaps a lax.while_loop over lanes. Under vmap, a lane
whose condition is false keeps its whole carry, so this port runs each
refresh cycle (Hessian refresh, eigendecomposition, hess_every
trust-region steps) on every lane and then keeps the new state only for
the lanes that were active at the start of the cycle:
active = ~converged & (hess_calls < max_iters). The loop stops when no
lane is active, one device-to-host read per cycle. The accept, radius and
freeze logic of each step is the reference's (newton.py:509-543).
"""

from typing import Callable, NamedTuple, Optional

import torch

from .eigh import (jacobi_eigh, jacobi_sweep, jacobi_sweep_plain,
                   jacobi_sweep_split, jacobi_sweep_split_plain)
from .jacobi import pad_to_even
from .tr import tr_subproblem, tr_subproblem_newton, tr_subproblem_plain


class NewtonConfig(NamedTuple):
    """The JAX NewtonConfig's fields and defaults. The port runs
    tr_solver "eig" (torch.linalg.eigh, the f64 parity route) and "pjacobi"
    (ops/eigh.py) with secular "bisect" or "newton" (bisect_iters
    iterations either way). refresh_kernel and tr_kernel "pallas" select
    the CUDA kernels' wrappers (ops/refresh.pixel_terms,
    ops/tr.tr_subproblem; the latter for "bisect" only), "xla" their plain
    twins. eigh_fused (the
    JAX package's CELESTE_EIGH_FUSED, a field here) picks the pjacobi
    sweep: the fused kernel (True) or the split pair (False)."""
    max_iters: int = 50
    initial_delta: float = 1.0
    delta_hat: float = 1e9
    eta: float = 0.1
    rho_lower: float = 0.25
    rho_upper: float = 0.75
    xtol_abs: float = 1e-7
    ftol_rel: float = 1e-6
    gtol_abs: float = 1e-8
    bisect_iters: int = 48
    secular: str = "bisect"
    hess_every: int = 6
    tr_solver: str = "eig"
    grad_mode: str = "ad"
    cg_iters: int = 41
    ms_iters: int = 12
    jacobi_tol: float = 1e-6
    jacobi_max_sweeps: int = 12
    tr_kernel: str = "xla"
    refresh_kernel: str = "xla"
    eigh_fused: bool = True


class NewtonState(NamedTuple):
    x: torch.Tensor            # (S, D)
    f: torch.Tensor            # (S,)
    g: torch.Tensor            # (S, D)
    delta: torch.Tensor        # (S,)
    iters: torch.Tensor        # (S,) int32, TR steps attempted
    f_calls: torch.Tensor
    hess_calls: torch.Tensor
    converged: torch.Tensor    # (S,) bool


def _tr_step(st: NewtonState, w, Q, config, fg, tr_solve):
    """One trust-region step on every lane with the (possibly stale)
    eigendecomposition (w, Q) — Q may be padded one dimension past D —
    and the fresh gradient in st. A no-op on converged lanes."""
    S, D = st.g.shape
    g = torch.nn.functional.pad(st.g, (0, Q.shape[-1] - D))
    gq = (Q.mT @ g[..., None])[..., 0]
    p_eig, pred = tr_solve(gq, w, st.delta, config.bisect_iters)
    p = (Q @ p_eig[..., None])[..., 0][:, :D]
    x_new = st.x + p
    f_new, g_new = fg(x_new)

    rho = torch.where(pred > 0.0, (st.f - f_new) / pred, -1.0)
    # a trial point with non-finite f or g is rejected
    bad = ~torch.isfinite(f_new) | ~torch.all(torch.isfinite(g_new), dim=-1)
    rho = torch.where(bad, -1.0, rho)
    accept = (rho >= config.eta) & ~st.converged

    pnorm = torch.linalg.vector_norm(p, dim=-1)
    delta = torch.where(
        rho < config.rho_lower, st.delta * 0.25,
        torch.where((rho > config.rho_upper) & (pnorm >= 0.99 * st.delta),
                    torch.clamp(2.0 * st.delta, max=config.delta_hat),
                    st.delta))
    delta = torch.where(st.converged, st.delta, delta)

    x = torch.where(accept[:, None], x_new, st.x)
    f = torch.where(accept, f_new, st.f)
    g = torch.where(accept[:, None], g_new, st.g)

    x_conv = accept & (torch.amax(torch.abs(p), dim=-1) < config.xtol_abs)
    f_conv = accept & (torch.abs(f_new - st.f)
                       < config.ftol_rel * torch.abs(st.f))
    g_conv = torch.amax(torch.abs(g), dim=-1) < config.gtol_abs
    tiny_tr = delta < 1e-14
    converged = st.converged | x_conv | f_conv | g_conv | tiny_tr
    step = (~st.converged).to(st.iters.dtype)
    return NewtonState(x=x, f=f, g=g, delta=delta, iters=st.iters + step,
                       f_calls=st.f_calls + step, hess_calls=st.hess_calls,
                       converged=converged)


def minimize_newton_tr(fgh: Callable, x0: torch.Tensor,
                       config: NewtonConfig = NewtonConfig(),
                       fg: Optional[Callable] = None,
                       delta0: Optional[torch.Tensor] = None,
                       converged0: Optional[torch.Tensor] = None,
                       plain: bool = False):
    """Minimize, lane by lane, fgh's value over a batch x0 (S, D) with
    lagged-Hessian trust-region Newton.

    fgh(x) -> (f (S,), g (S, D), H (S, D, D)); fg(x) -> (f, g), the cheap
    evaluator of the hess_every - 1 steps between refreshes (default: fgh
    without its H). delta0 / converged0 (S,): warm-resume state; converged
    lanes stay frozen. plain=True runs every kernel's plain twin instead of
    its wrapper, whatever the config says. Returns the final NewtonState.
    """
    if config.tr_solver not in ("eig", "pjacobi"):
        raise NotImplementedError(f"tr_solver={config.tr_solver!r}")
    if config.secular not in ("bisect", "newton"):
        raise NotImplementedError(f"secular={config.secular!r}")
    if fg is None:
        fg = lambda x: fgh(x)[:2]
    # K3 serves the bisection alone, as the JAX package's TR kernel does
    if config.secular == "newton":
        tr_solve = tr_subproblem_newton
    elif config.tr_kernel == "pallas" and not plain:
        tr_solve = tr_subproblem
    else:
        tr_solve = tr_subproblem_plain
    if config.eigh_fused:
        sweep = jacobi_sweep_plain if plain else jacobi_sweep
    else:
        sweep = jacobi_sweep_split_plain if plain else jacobi_sweep_split

    S, D = x0.shape
    kw = dict(dtype=x0.dtype, device=x0.device)
    ikw = dict(dtype=torch.int32, device=x0.device)
    f0, g0 = fg(x0)
    st = NewtonState(
        x=x0, f=f0, g=g0,
        delta=(torch.full((S,), config.initial_delta, **kw) if delta0 is None
               else torch.as_tensor(delta0, **kw).expand(S).clone()),
        iters=torch.zeros(S, **ikw), f_calls=torch.ones(S, **ikw),
        hess_calls=torch.zeros(S, **ikw),
        converged=(torch.zeros(S, dtype=torch.bool, device=x0.device)
                   if converged0 is None
                   else torch.as_tensor(converged0, device=x0.device)
                   .to(torch.bool).expand(S).clone()))

    pjacobi = config.tr_solver == "pjacobi"
    Dp = D + D % 2
    Q = torch.eye(Dp, **kw).expand(S, Dp, Dp) if pjacobi else None

    while True:
        active = ~st.converged & (st.hess_calls < config.max_iters)
        if not bool(torch.any(active)):
            return st
        f, g, H = fgh(st.x)
        if pjacobi:
            Hp, _ = pad_to_even(H)
            w, Qc, _ = jacobi_eigh(Hp, Q, tol=config.jacobi_tol,
                                   max_sweeps=config.jacobi_max_sweeps,
                                   sweep=sweep)
        else:
            w, Qc = torch.linalg.eigh(H)
        cyc = st._replace(f=f, g=g, hess_calls=st.hess_calls + 1)
        for _ in range(max(config.hess_every, 1)):
            cyc = _tr_step(cyc, w, Qc, config, fg, tr_solve)
        st = NewtonState(*(
            torch.where(active.reshape((S,) + (1,) * (new.ndim - 1)), new, old)
            for new, old in zip(cyc, st)))
        if pjacobi:
            Q = torch.where(active[:, None, None], Qc, Q)
