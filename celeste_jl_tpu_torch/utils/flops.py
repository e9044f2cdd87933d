"""Model-FLOP accounting: fits priced in operations of the model, so a
throughput can be set against the card's peak (the port's copy of the
analytic part of celeste_jl_tpu/utils/flops.py).

    F_fit ~= f_calls * F_fg  +  refreshes * (F_H + F_eigh)  +  iters * F_tr

F_fg is one ELBO value and gradient, F_H the likelihood Hessian with the
KL Hessian and the free-space chain rule, F_eigh the (41, 41)
eigendecomposition and F_tr one trust-region step in the eigenbasis. The
per-(pixel x band) coefficients are the JAX package's constants, counted
by XLA's cost analysis of its own programs at tile 32, 5 bands: operation
counts of the model, not times, so they hold on any device. The JAX
package's probe-based variant (fit_flop_components, XLA's cost analysis of
live programs) has no torch counterpart and is not carried over.

"Useful" means the work a perfectly ragged single-source fit would do:
padding lanes and masked-out pixels are left out (telemetry counts them as
padded_visits). MFU = model FLOP/s over the card's dense BF16 tensor-core
peak, the way the JAX package sets its fits against the TPU's bf16 peak;
an unknown card or the CPU has no peak (None).
"""

import numpy as np
import torch

# dense BF16 tensor-core peak FLOP/s by torch.cuda.get_device_name:
# NVIDIA's H100 SXM datasheet (989 TFLOP/s without sparsity), keyed on the
# SXM card's name; the PCIe and NVL cards have lower peaks and are not
# listed (None) until theirs are added
PEAK_FLOPS_BY_NAME = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

# per-(pixel x band) operation counts of the model (the JAX package's
# calibrated constants)
_FG_PER_PXB = 1516.0      # ELBO value + gradient (reverse mode)
_H_PER_PXB = 6369.0       # analytic likelihood Hessian blocks + chain rule
_EIGH_FLOPS = 35301.0     # eigendecomposition of (41, 41)
_TR_STEP_FLOPS = 3.0e4    # eigenbasis secular solve + bookkeeping per step


def fit_flop_components_analytic(P, B=5):
    """(F_fg, F_H, F_eigh) model FLOPs per lane per call at tile P, B
    bands."""
    n = float(P * P * B)
    return (_FG_PER_PXB * n, _H_PER_PXB * n, _EIGH_FLOPS)


def fit_flops(iters, f_calls, P, B=5, hess_every=6):
    """Model FLOPs of fits with the given per-fit TR step and f-call counts
    (scalars or arrays; the summed total). A fit refreshes its Hessian once
    per hess_every TR steps (ops/newton.minimize_newton_tr), so refreshes
    is ceil(iters / hess_every)."""
    F_fg, F_H, F_eigh = fit_flop_components_analytic(int(P), int(B))
    iters = np.asarray(iters, np.float64)
    f_calls = np.asarray(f_calls, np.float64)
    refreshes = np.ceil(iters / max(hess_every, 1))
    per_fit = (f_calls * F_fg
               + refreshes * (F_H + F_eigh)
               + iters * _TR_STEP_FLOPS)
    return float(per_fit.sum())


def peak_flops(device=None):
    """Dense BF16 peak FLOP/s of the card `device` (default: CUDA device
    0 when there is one), or None for the CPU or an unknown card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return PEAK_FLOPS_BY_NAME.get(torch.cuda.get_device_name(dev))


def mfu(total_flops, wall_s, device=None):
    """(achieved FLOP/s, fraction of the card's peak or None)."""
    achieved = total_flops / wall_s if wall_s > 0 else 0.0
    peak = peak_flops(device)
    return achieved, (achieved / peak if peak else None)
