"""Conflict-free class packers of the joint schedules (port of
celeste_jl_tpu/parallel/packing.py): greedy coloring (the host-driven
schedule), the width-capped lane-step-cost packer (the fused schedule,
parallel/fused.py), Cyclades wave scheduling, power-of-two work chunking
and the per-bucket launch widths.
"""

import numpy as np

from .common import _next_pow2


def _waves(components):
    """Round-robin the sources of each connected component: wave w = the
    w-th source of every CC. No two sources in a wave conflict."""
    out, w = [], 0
    while True:
        wave = [c[w] for c in components if len(c) > w]
        if not wave:
            return out
        out.append(wave)
        w += 1


def color_classes(targets, neighbor_map, rng=None, tile=None):
    """Greedy coloring of the conflict graph: a partition of `targets` into
    conflict-free classes, each as WIDE as possible.

    The reference's Cyclades component-waves give the same safety guarantee
    (conflicting sources never run concurrently) but terrible launch width
    on TPU: a chain of k overlapping sources serializes into k near-empty
    waves. Greedy coloring needs only ~(max degree + 1) classes, and sparse
    sky fields have small degree — measured on a 128-source field
    end-to-end: 60 -> 20 launches and 252 -> 145 s (1.7x). Between classes
    each fit still reads the freshest neighbor vps, so the
    serial-equivalence argument of Cyclades (partition.jl:85-236) carries
    over unchanged.

    Class sizes are BALANCED: only conflicted sources are pinned to
    distinct classes; the (typically majority) conflict-free sources can go
    anywhere, and each is placed where it least grows the padded-launch
    cost (launches pad to a power of two per tile bucket, so a greedy
    class-0 dump pads the first class up a power while the tail classes
    pad up to the 32-lane floor — pure idle lanes both ways). `tile`:
    optional {source: tile_size} so balancing happens within the per-class
    per-bucket groups one_node_joint_infer actually launches.
    """
    rng = rng or np.random.default_rng(42)
    order = list(targets)
    rng.shuffle(order)
    tile_of = (lambda s: tile[s]) if tile is not None else (lambda s: 0)

    constrained = [s for s in order if neighbor_map.get(s)]
    free = [s for s in order if not neighbor_map.get(s)]

    def pad_cost(n):
        # the JAX package's balancing cost, its TPU 32-lane floor included:
        # the classes are the schedule, kept the same on every device
        return 0 if n == 0 else max(_next_pow2(n), 32)

    color = {}
    # per-(color, tile) group sizes
    sizes = []

    def grow(c, s):
        color[s] = c
        while c >= len(sizes):
            sizes.append({})
        t = tile_of(s)
        sizes[c][t] = sizes[c].get(t, 0) + 1

    def placement_cost(c, s):
        """(padded-lane increase, resulting group size) of adding s to c —
        prefer fills that stay within the current power-of-two pad, then
        smaller groups."""
        n = sizes[c].get(tile_of(s), 0) if c < len(sizes) else 0
        return (pad_cost(n + 1) - pad_cost(n), n)

    for s in constrained:
        used = {color[n] for n in neighbor_map.get(s, ()) if n in color}
        cands = [c for c in range(len(sizes)) if c not in used]
        if not cands:
            grow(len(sizes), s)
        else:
            grow(min(cands, key=lambda c: placement_cost(c, s)), s)
    if not sizes:
        sizes.append({})
    for s in free:
        grow(min(range(len(sizes)), key=lambda c: placement_cost(c, s)), s)

    classes = [[] for _ in range(len(sizes))]
    for s in order:
        classes[color[s]].append(s)
    # widest first: the big classes amortize launch overhead best
    classes.sort(key=len, reverse=True)
    return classes


# The JAX package's per-TR-step cost of a batched sub-fit, measured on its
# TPU (tools/knee_probe.py over a (W lanes, P tile) grid):
#
#     wall / serialized step  ~=  W * (16.5 us + P^2 * 7 ns)
#
# linear in lane count W, with an affine per-lane cost in tile pixels. The
# constants are kept as they are on every device: the class partition the
# packer picks is part of the schedule, so the port picks the JAX
# package's classes from the same seed. (Their H100 values are not
# measured; a change would be a change of schedule.)
LANE_STEP_US_FLOOR = 16.5
LANE_STEP_NS_PER_PX = 7.0


def _lane_step_cost(t):
    """The cost model's per-TR-step cost (us) of ONE lane at tile size t."""
    return LANE_STEP_US_FLOOR + max(t, 1) ** 2 * LANE_STEP_NS_PER_PX * 1e-3


def fused_color_classes(targets, neighbor_map, rng=None, tile=None):
    """Conflict-free classes minimizing the fused schedule's total
    LANE-STEP COST under the linear cost model (_lane_step_cost).

    The fused schedule runs, per sweep, one sub-fit per (class, tile
    bucket) group, each padded to that bucket's power-of-two width W_t and
    running every lane until the slowest converges. With per-step cost
    W * c(P), a sweep costs ~ k * sum_t W_t * c(t) * steps, so the packer
    searches class counts k and keeps the smallest feasible

        cost(k) = k * sum_t width_t(t, k) * _lane_step_cost(t),

    where width_t is the padded per-(class, bucket) width at an even
    spread. Fewer classes is NOT cheaper once the max class pads up a
    power of two; more classes is NOT cheaper once every class pays the
    32-lane floor of the model.

    tile: optional {source: tile_size}. Per-(class, bucket) group sizes
    are capped at that bucket's padded width, so a class cannot hoard the
    large-tile sources and widen the priciest lane grid."""
    rng = rng or np.random.default_rng(42)
    n = len(targets)
    tile_of = (lambda s: int(tile[s])) if tile is not None else (lambda s: 0)
    n_t = {}
    for s in targets:
        t = tile_of(s)
        n_t[t] = n_t.get(t, 0) + 1

    def width_t(t, k):
        # the cost model's 32-lane floor, the same on every device: the
        # partition is part of the schedule (the staged launch widths,
        # fused_bucket_widths, have no floor)
        floor = min(32, _next_pow2(max(n_t[t], 1)))
        return max(floor, _next_pow2(-(-n_t[t] // k)))

    def cost(k):
        return k * sum(width_t(t, k) * _lane_step_cost(t) for t in n_t)

    ks = sorted(range(1, n + 1), key=lambda k: (cost(k), k))
    for k in ks:
        classes = _try_color_capped(targets, neighbor_map, k,
                                    {t: width_t(t, k) for t in n_t},
                                    tile_of, rng)
        if classes is not None:
            return classes
    return color_classes(targets, neighbor_map, rng)  # unreachable fallback


def _try_color_capped(targets, neighbor_map, k, caps, tile_of, rng):
    """Greedy k-coloring of `targets` with per-(class, tile) group sizes
    capped at caps[t], highest-degree-first with a few shuffle retries.
    None if infeasible at this k."""
    for _ in range(4):
        order = list(targets)
        rng.shuffle(order)
        order.sort(key=lambda s: -len(neighbor_map.get(s, ())))
        classes = [[] for _ in range(k)]
        members = [set() for _ in range(k)]
        counts = [dict() for _ in range(k)]
        ok = True
        for s in order:
            nbs = neighbor_map.get(s, ())
            t = tile_of(s)
            cands = [c for c in range(k)
                     if counts[c].get(t, 0) < caps[t]
                     and not any(nb in members[c] for nb in nbs)]
            if not cands:
                ok = False
                break
            c = min(cands, key=lambda c: (counts[c].get(t, 0),
                                          len(classes[c])))
            classes[c].append(s)
            members[c].add(s)
            counts[c][t] = counts[c].get(t, 0) + 1
        if ok:
            return [c for c in classes if c]
    return None


def _pow2_chunks(seq, floor=32, cap=None):
    """Split a work list into power-of-two-sized chunks, largest first.
    Padding a just-over-a-power batch costs ~2x device work (516 lanes pad
    to 1024); 512 + a 32-padded tail costs ~1x and keeps the compile-key
    set to O(log n) distinct widths (which the bench programs already
    populate). Only valid for INDEPENDENT fits — chunks of one conflict
    class would still be conflict-free, but the isolated fits are the only
    caller that needs it."""
    out, i, n = [], 0, len(seq)
    while n - i >= floor:
        size = 1 << ((n - i).bit_length() - 1)
        if cap:
            size = min(size, cap)
        out.append(seq[i:i + size])
        i += size
    if i < n:
        out.append(seq[i:])
    return out


def _dual_chunk_cap(P):
    """Chunk-size cap for dual-init isolated launches: lanes double to 2n,
    so bound 2n x P^2 lane-pixels at ~2^21 — the widest P<=32 launches keep
    the bench's 1024-lane program shape while P=128 stagings stay inside
    the device/upload budget."""
    return max(32, (1 << 21) // (2 * P * P))


def fused_bucket_widths(classes, tile_of):
    """Per-tile lane width of one sweep schedule over conflict-free
    `classes`: the power of two of the largest (class, bucket) group. The
    joint schedule's class launches of a bucket all take this width (the
    JAX package's fused and host-driven schedules share it; on the CPU its
    pad floor is 1, as here on every device)."""
    grp_max = {}
    for cls in classes:
        sizes = {}
        for s in cls:
            t = tile_of(s)
            sizes[t] = sizes.get(t, 0) + 1
        for t, k in sizes.items():
            grp_max[t] = max(grp_max.get(t, 0), k)
    return {t: _next_pow2(k) for t, k in grp_max.items()}
