"""Shared constants and helpers of the schedulers (port of
celeste_jl_tpu/parallel/common.py).

The JAX package's pad_floor is not carried over: its 32-lane floor bounds
XLA's compile keys on the TPU, which torch does not have, and on the CPU it
is 1. Launches pad to a power of two on every device (`_next_pow2`), so a
CPU run of the port sees the JAX package's CPU lanes.
"""

import math
import os

import torch

from ..vi.elbo import elbo, source_moment_grids

# Patch tile sizes sources bucket into (the JAX package's default ladder;
# its CELESTE_TILE_BUCKETS override is not carried over).
TILE_BUCKETS = (16, 32, 64, 128)
MAX_PATCH_RADIUS = 25.0

# Basin-acceptance margin of every better-ELBO reduction (dual-init lanes,
# keep_better): a challenger replaces the incumbent only when it wins by
# this relative margin. Two fits of one source at different launch widths
# agree only to rounding amplified over ~50 trust-region steps (~1e-9
# relative on near-tied basins); genuine basin gaps are orders of magnitude
# larger, so the margin makes the reduction independent of packing.
BASIN_MARGIN_REL = 1e-8


def _beats(challenger, incumbent):
    """True where the `challenger` ELBO beats `incumbent` by more than the
    relative rounding margin (numpy arrays or tensors)."""
    return challenger > incumbent + BASIN_MARGIN_REL * abs(incumbent)


def is_production_run():
    """In production (CELESTE_PROD set), per-launch failures are logged and
    skipped; otherwise they raise (ParallelRun.jl:419)."""
    return os.environ.get("CELESTE_PROD", "") not in ("", "0", "false")


def _tile_for_radius(radius):
    need = int(2 * math.ceil(radius) + 6)
    for P in TILE_BUCKETS:
        if P >= need:
            return P
    return TILE_BUCKETS[-1]


def _next_pow2(n):
    return 1 << max(0, (n - 1).bit_length())


def _render_neighbor_bg(nb_vps, nb_mask, patches, n_slots=None):
    """Sum of the neighbors' E[G] and Var[G] images on each lane's patch.

    nb_vps (W, NB, 44); nb_mask (W, NB), 1 for a real neighbor; patches a
    SkyPatch with leading W. Returns (bg_E_G, bg_var_G), each (W, B, P, P).
    Slot k of every lane renders in one batched call; slots past the most
    neighbors any lane has are all masked and skipped. n_slots: that
    count, when the caller knows it on the host (otherwise it is read from
    nb_mask, one device read)."""
    with torch.no_grad():
        if n_slots is None:
            n_slots = (int((nb_mask > 0).sum(dim=1).max())
                       if nb_mask.numel() else 0)
        bg_E = torch.zeros_like(patches.sky)
        bg_V = torch.zeros_like(patches.sky)
        for k in range(n_slots):
            E, V = source_moment_grids(nb_vps[:, k], patches)
            w = nb_mask[:, k, None, None, None]
            bg_E = bg_E + E * w
            bg_V = bg_V + V * w
        return bg_E, bg_V


def _elbo_values(vps, patches, bg_E, bg_V):
    """ELBO of each lane at fixed params (W,): the keep-better pass's
    incumbents re-evaluated against the launch's own background."""
    with torch.no_grad():
        return elbo(vps, patches, bg_E, bg_V)
