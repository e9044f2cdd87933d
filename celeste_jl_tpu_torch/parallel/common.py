"""Tile buckets of the schedulers (port of the host helpers of
celeste_jl_tpu/parallel/common.py)."""

import math

# Patch tile sizes sources bucket into (the JAX package's default ladder;
# its CELESTE_TILE_BUCKETS override is not carried over).
TILE_BUCKETS = (16, 32, 64, 128)
MAX_PATCH_RADIUS = 25.0


def _tile_for_radius(radius):
    need = int(2 * math.ceil(radius) + 6)
    for P in TILE_BUCKETS:
        if P >= need:
            return P
    return TILE_BUCKETS[-1]
