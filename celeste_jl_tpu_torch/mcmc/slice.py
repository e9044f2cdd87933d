"""Batched component-wise slice sampler (port of celeste_jl_tpu/mcmc/slice.py,
mcmc/slicesample.jl rebuilt).

Neal (2003)'s linear stepping-out, capped at max_steps_out per side, then
shrinkage toward the current point, capped at max_shrink draws. The JAX
package vmaps lax.while_loops over lanes; here each loop is a masked loop
over all lanes: a lane whose loop has ended keeps its carry, and the loop
runs until no lane is active (one device-to-host read per iteration,
counted in `slicesample.host_reads`), as under vmap. The lower and upper
step-outs are independent given the slice height, so they run in one
loop, both ends scored in one evaluation.

Lanes may differ in dimension (the AIS runs star lanes, D = 7, beside
galaxy lanes, D = 11, padded to 11): `ndim` (L,) gives each lane's, and a
sweep runs max(ndim) coordinate steps, lane l taking part in the first
ndim[l]. A density is an `evaluate(x) -> parts` (a tuple of (L,) tensors,
e.g. the log-likelihood and the log-prior) and a `combine(parts) -> (L,)`
log density; the sampler carries the parts of the current point, so the
value at the current point is never re-evaluated.

Random numbers: each sweep draws, before any evaluation, a (L, D) uniform
whose argsort is each lane's shuffled coordinate order, then per
coordinate step an Exp(1) slice-height offset, the bracket's uniform and
max_shrink shrinkage uniforms per lane. How often a loop runs therefore
never moves the generator, so two runs with the same seed see the same
numbers whichever route scores the likelihood.
"""

import torch


def _where(mask, new, old):
    return tuple(torch.where(mask, n, o) for n, o in zip(new, old))


def _dir_slice(draws, x, parts, direction, act, evaluate, combine, sigma,
               max_steps_out, max_shrink):
    """One directional update x' = x + z* direction on the lanes `act`
    (the others keep x and parts). draws: (E (L,), U (L,), Us (L,
    max_shrink)). Returns (x', parts')."""
    E, U, Us = draws
    L = x.shape[0]
    llh_s = combine(parts) - E                      # log slice height
    upper = sigma * U
    lower = upper - sigma

    # linear stepping out on both sides at once, capped
    lo_act, hi_act = act.clone(), act.clone()
    for _ in range(max_steps_out):
        ends = torch.cat([lower, upper])[:, None] * direction.repeat(2, 1)
        f = combine(evaluate(x.repeat(2, 1) + ends))
        lo_act = lo_act & (f[:L] > llh_s)
        hi_act = hi_act & (f[L:] > llh_s)
        lower = torch.where(lo_act, lower - sigma, lower)
        upper = torch.where(hi_act, upper + sigma, upper)
        slicesample.host_reads += 1
        if not bool(torch.any(lo_act | hi_act)):
            break

    # shrinkage: z ~ U(lower, upper); accept if above the slice, else
    # shrink the violated side toward 0 (the current point)
    z = torch.zeros_like(lower)
    pending = act.clone()
    for n in range(max_shrink):
        if n:
            slicesample.host_reads += 1
            if not bool(torch.any(pending)):
                break
        z_new = lower + (upper - lower) * Us[:, n]
        p_new = evaluate(x + z_new[:, None] * direction)
        ok = pending & (combine(p_new) > llh_s)
        lower = torch.where(pending & ~ok & (z_new < 0.0), z_new, lower)
        upper = torch.where(pending & ~ok & (z_new >= 0.0), z_new, upper)
        z = torch.where(ok, z_new, z)
        parts = _where(ok, p_new, parts)
        pending = pending & ~ok
    return x + z[:, None] * direction, parts


def slicesample(gen, x, parts, ndim, evaluate, combine, sigma=1.0,
                max_steps_out=10, max_shrink=50, shuffle=True):
    """One full component-wise sweep (slicesample.jl:20-231 semantics:
    compwise, shuffled component order per lane) of the (L, D) lanes x
    whose current parts are `parts`. Returns (x', parts', lnpdf(x'))."""
    L, D = x.shape
    kw = dict(generator=gen, dtype=x.dtype, device=x.device)
    steps = torch.arange(D, device=x.device)
    if shuffle:
        keys = torch.rand(L, D, **kw)
        keys = torch.where(steps < ndim[:, None], keys, 2.0)
        order = torch.argsort(keys, dim=-1)
    else:
        order = steps.expand(L, D)
    E = torch.empty(D, L, dtype=x.dtype, device=x.device).exponential_(
        generator=gen)
    U = torch.rand(D, L, **kw)
    Us = torch.rand(D, L, max_shrink, **kw)
    for j in range(D):
        act = j < ndim
        direction = (order[:, j, None] == steps).to(x.dtype)
        direction = direction * act[:, None].to(x.dtype)
        x, parts = _dir_slice((E[j], U[j], Us[j]), x, parts, direction, act,
                              evaluate, combine, sigma, max_steps_out,
                              max_shrink)
    return x, parts, combine(parts)


slicesample.host_reads = 0   # device-to-host reads of the loops' any(active)


def slicesample_chain(gen, x0, parts0, ndim, evaluate, combine, n_samples,
                      sigma=1.0, **kwargs):
    """n_samples sequential sweeps (slicesample.jl:209-231). Returns
    (samples (n_samples, L, D), lnpdf (n_samples, L), final parts)."""
    x, parts = x0, parts0
    samps, lls = [], []
    for _ in range(n_samples):
        x, parts, ll = slicesample(gen, x, parts, ndim, evaluate, combine,
                                   sigma=sigma, **kwargs)
        samps.append(x)
        lls.append(ll)
    return torch.stack(samps), torch.stack(lls), parts
