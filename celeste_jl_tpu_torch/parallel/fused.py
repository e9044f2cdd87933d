"""The fused joint-VI schedule (port of celeste_jl_tpu/parallel/fused.py):
warm Gauss-Seidel sweeps over conflict-free classes, the wide fresh-init
probe and the polish sweeps, over one or more fields, with the schedule's
state resident on the device; and its host staging and finish.

In the JAX package the whole schedule is one XLA program (a fori_loop over
class steps, a lax.cond per tile bucket) enqueued at once. The port's fit
reads the host once per refresh cycle (ops/newton.minimize_newton_tr), so
its schedule cannot be one launch. It keeps the JAX schedule and its data
flow:

- The merged vps, ELBOs, converged flags and iteration counts live on the
  device for the whole schedule, in float64 as the host-driven path keeps
  them (fits run in the state's dtype; their results are widened, so
  every keep-better test compares in float64 as that path does). Each
  tile bucket's unique patches are stacked and uploaded once.
- A class step gathers its lanes by lane_src and lane_pat, renders the
  neighbors' background from the device vps, runs the fit that the
  host-driven path's dispatch_group launches at that width
  (state.fit_for_width), and accepts and scatters on the device.
- The host knows which (class, bucket) groups are empty and skips them:
  no zero-lane fit is launched.
- The device is read by the fits' own per-cycle convergence test and once
  in _fused_joint_finish, nowhere else: the telemetry sums stay on the
  device until then.

Scatters write the real lanes only (the first n of a lane row, n known on
the host), so no index repeats within a scatter: no result depends on
which duplicate wins, the gain table holds every real lane's gain (JAX's
pad lanes repeat their group's first source with bit-identical inputs, so
the same values land there), and the float sums are plain reductions, no
atomics.

The XLA compile-key pads are not carried over: the class count padded to
max(next_pow2, 8), the state padded to a power-of-two row count, the
unique-patch rows padded to a power of two and the TPU's pad_floor. None
changes a result. The staging budget is still JAX's estimate (rows counted
at their power of two), so the schedule falls back where JAX's does.

_fused_joint_dispatch stages (host gathers, uploads, lane tables) and
returns a handle; _fused_joint_finish runs the schedule and applies it.
JAX enqueues the schedule at dispatch and blocks on it at finish; here
nothing can be enqueued ahead of the fit's host loop, so the schedule runs
where JAX waits for it, and a failure surfaces where JAX's does.

With a mesh (parallel/mesh.make_mesh over a pod) every rank runs the whole
schedule on the same staged inputs, and each sub-fit's lanes are split
over the mesh's src axis (mesh.fit_row_sharded, JAX's shard_map branch):
each rank fits its block and the results are all-gathered, so every rank
issues the same gathers in the same order (the skipped empty groups are
known on the host, the same on every rank). Everything else that feeds
the carry (the neighbors' background, the incumbents' ELBOs, the gain
table and the blocking test) is computed whole on every rank from the
gathered results, so after every step the carry is the same bits on
every rank. A mesh whose src axis has one rank runs the one-process
fits.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.patches import stack_patches
from ..ops.newton import NewtonConfig
from ..utils import log as Log
from ..utils import telemetry
from ..utils.flops import _TR_STEP_FLOPS, fit_flop_components_analytic
from ..vi.init import generic_init_source
from .common import (_beats, _elbo_values, _next_pow2, _render_neighbor_bg,
                     is_production_run)
from .mesh import fit_row_sharded, row_block, src_size
from .packing import fused_bucket_widths
from .state import fit_for_width


@dataclass
class _Carry:
    """The schedule's device state (merged ids): vps (S, 44), elbos (S,)
    float64, conv (S,) bool, iters (S,) int64; and the telemetry sums,
    float64 scalars: real pixel-visits rv, all pixel slots visited tv,
    real-lane TR steps ri, serial depth ss, model FLOPs fl."""
    vps: torch.Tensor
    elbos: torch.Tensor
    conv: torch.Tensor
    iters: torch.Tensor
    rv: torch.Tensor
    tv: torch.Tensor
    ri: torch.Tensor
    ss: torch.Tensor
    fl: torch.Tensor


def _account(cr, res, n, cnt, patches, config):
    """Add one sub-fit's telemetry (its first n lanes real) to the carry's
    device sums: the JAX program's accounting."""
    B_t, P_t = int(patches.mask.shape[-3]), int(patches.mask.shape[-1])
    F_fg, F_H, F_eigh = fit_flop_components_analytic(P_t, B_t)
    lane_total = float(np.prod(patches.mask.shape[1:]))
    fc = res.f_calls.double()
    it = res.iters.double()
    cr.rv += (cnt[:n] * fc[:n]).sum()
    cr.tv += lane_total * fc.sum()
    cr.ri += it[:n].sum()
    # serial depth: a batched fit runs every lane until its slowest stops
    cr.ss += it.max()
    refreshes = torch.ceil(it[:n] / max(config.hess_every, 1))
    cr.fl += (fc[:n] * F_fg + refreshes * (F_H + F_eigh)
              + it[:n] * _TR_STEP_FLOPS).sum()


def _sub_fit(cr, tbl, vp0, config, plain, label, mesh=None):
    """One batched fit of a lane row `tbl` against the carry's current
    background: (FitResult, the lanes' patches, background E, V). With a
    mesh whose src axis has more than one rank, the row is fit sharded
    over it (mesh.fit_row_sharded: this rank fits mesh.row_block(W)
    lanes). The fit's wall and this rank's lane width go to the telemetry
    as one launch."""
    pc = tbl["patches"].index(tbl["lane_pat"])
    dtype = pc.pixels.dtype
    W = int(tbl["lane_src"].shape[0])
    t0 = telemetry.now()
    bg_E, bg_V = _render_neighbor_bg(cr.vps[tbl["nb_idx"]].to(dtype),
                                     tbl["nb_mask"], pc, tbl["n_slots"])
    if src_size(mesh) > 1:
        res = fit_row_sharded(vp0.to(dtype), pc, bg_E, bg_V, mesh,
                              config=config, plain=plain)
        width = row_block(W, mesh)
    else:
        res = fit_for_width(W)(vp0.to(dtype), pc, bg_E, bg_V,
                               config=config, plain=plain)
        width = W
    telemetry.record_launch_wall(t0, label)
    telemetry.counters.lane_widths[width] += 1
    return res, pc, bg_E, bg_V


def _fused_joint_program(cr, buckets, n_classes, n_sweeps, n_restart,
                         config: NewtonConfig, plain=False, mesh=None):
    """n_sweeps warm Gauss-Seidel sweeps, then n_restart fresh-restart
    sweeps, over the classes, one sub-fit per (class, tile bucket) group;
    empty groups are skipped. Sources of a class are mutually conflict-free,
    so splitting a class step by bucket keeps the serial order (sweep,
    class) of the host-driven path's per-(class, bucket) launches.

    `buckets`: per tile bucket, the uploaded patches and, per class c,
    a lane row (n_real[c] real lanes, then pads): lane_src, lane_pat,
    nb_idx, nb_mask, fresh_vp0, pix_counts, n_slots. A warm step accepts
    every lane; a restart step refits from the fresh init and keeps the
    better of it and the incumbent re-evaluated under this step's
    background (_beats). mesh: each sub-fit sharded over its src axis
    (_sub_fit)."""
    for step in range(n_classes * (n_sweeps + n_restart)):
        c = step % n_classes
        is_restart = step >= n_classes * n_sweeps
        for bk in buckets:
            n = bk["n_real"][c]
            if not n:
                continue
            tbl = bk["rows"][c]
            src = tbl["lane_src"]
            sr = src[:n]
            W = int(src.shape[0])
            vp0 = tbl["fresh_vp0"] if is_restart else cr.vps[src]
            res, pc, bg_E, bg_V = _sub_fit(
                cr, tbl, vp0, config, plain,
                f"fused c={c} n={n} pad={W} P{bk['tile']}", mesh)
            vp = res.vp[:n].double()
            el = res.elbo[:n].double()
            cv = res.converged[:n]
            if is_restart:
                ref = _elbo_values(cr.vps[src].to(pc.pixels.dtype), pc,
                                   bg_E, bg_V)[:n].double()
                acc = _beats(el, ref)
                vp = torch.where(acc[:, None], vp, cr.vps[sr])
                el = torch.where(acc, el, ref)
                cv = torch.where(acc, cv, cr.conv[sr])
            cr.vps[sr] = vp
            cr.elbos[sr] = el
            cr.conv[sr] = cv
            cr.iters[sr] += res.iters[:n].long()
            _account(cr, res, n, tbl["pix_counts"], pc, config)


def _fused_wide_pass(cr, wide, config: NewtonConfig, plain=False,
                     fresh=True, resolve=True, mesh=None):
    """One full-budget pass over all the schedule's sources at once, a
    fresh generic-init probe (fresh=True) or a warm refit: one wide fit per
    tile bucket against the vps frozen at entry, keep-better acceptance
    per lane.

    resolve: True accepts, per conflicting neighborhood, only the
    best-gain lane (ties to the lower id), so the accepted set is an
    independent set of the conflict graph; False (the default schedule's
    probe) accepts every improving lane. A lane not accepted keeps its
    state, its stored ELBO refreshed to the incumbent's re-evaluation
    under this pass's background (the host path's keep_better).

    `wide`: per tile bucket, one lane row (n_real real lanes, then pads)
    with the same fields as a class row of _fused_joint_program. mesh:
    each bucket's fit sharded over its src axis (_sub_fit)."""
    fitted = []
    gain_tbl = torch.full_like(cr.elbos, -torch.inf)
    # phase 1: every bucket against the frozen vps (buckets are disjoint,
    # and nothing is written before phase 2)
    for bw in wide:
        src, n = bw["lane_src"], bw["n_real"]
        W = int(src.shape[0])
        vp0 = bw["fresh_vp0"] if fresh else cr.vps[src]
        res, pc, bg_E, bg_V = _sub_fit(
            cr, bw, vp0, config, plain,
            f"fused wide n={n} pad={W} P{bw['tile']}", mesh)
        inc = _elbo_values(cr.vps[src].to(pc.pixels.dtype), pc, bg_E,
                           bg_V)[:n].double()
        el = res.elbo[:n].double()
        gain_tbl[src[:n]] = torch.where(_beats(el, inc), el - inc,
                                        -torch.inf)
        fitted.append((res, pc, el, inc))
    # phase 2: accept (per neighborhood, the best gain alone if resolve)
    for bw, (res, pc, el, inc) in zip(wide, fitted):
        n = bw["n_real"]
        sr = bw["lane_src"][:n]
        nbi = bw["nb_idx"][:n]
        gi = gain_tbl[sr]
        gn = gain_tbl[nbi]
        blocked = torch.any((bw["nb_mask"][:n] > 0)
                            & ((gn > gi[:, None])
                               | ((gn == gi[:, None]) & (nbi < sr[:, None]))),
                            dim=1)
        acc = (gi > -torch.inf) & (~blocked | (not resolve))
        cr.vps[sr] = torch.where(acc[:, None], res.vp[:n].double(),
                                 cr.vps[sr])
        cr.elbos[sr] = torch.where(acc, el, inc)
        cr.conv[sr] = torch.where(acc, res.converged[:n], cr.conv[sr])
        cr.iters[sr] += res.iters[:n].long()
        _account(cr, res, n, bw["pix_counts"], pc, config)


def _lane_row(lanes, n_real, pat_row, nb_idx, nb_mask, fresh_by_src,
              counts_by_src, patches, tile, dev, dtype):
    """One staged lane row on the device (see _fused_joint_program)."""
    lanes = np.asarray(lanes, dtype=np.int64)
    long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    return {
        "patches": patches, "tile": tile, "n_real": n_real,
        "lane_src": long(lanes),
        "lane_pat": long([pat_row[m] for m in lanes]),
        "nb_idx": long(nb_idx[lanes]),
        "nb_mask": torch.as_tensor(nb_mask[lanes], dtype=dtype, device=dev),
        "n_slots": int((nb_mask[lanes] > 0).sum(axis=1).max()),
        "fresh_vp0": f64(fresh_by_src[lanes]),
        "pix_counts": f64([counts_by_src[m] for m in lanes]),
    }


def _fused_joint_dispatch(states, classes, newton_config, n_sweeps,
                          n_restart, budget_bytes=4 << 30,
                          restart_config=None, polish_config=None,
                          n_polish=2, plain=False, mesh=None):
    """Host staging of the fused schedule over ONE OR MORE fields; returns
    the handle _fused_joint_finish runs, or None when the staging would
    not fit `budget_bytes` (the caller falls back to per-field scheduling).

    Fields never conflict, so several fields' sources can ride the same
    class side by side: `classes` holds MERGED source ids, field f's
    source s being offset_f + s (offsets by cumulative catalog length).
    Each tile bucket's unique targets are patched at their tile and
    uploaded once; each (class, bucket) group becomes a lane row padded to
    the bucket's width (packing.fused_bucket_widths, the host-driven
    path's class launch widths) with its own first member; the wide
    probe's rows hold all of a bucket's sources, padded to a power of two
    as the host path's wide launches are.

    With n_restart > 0 and a restart_config the schedule is split, as the
    host-driven path runs it: n_sweeps warm sweeps at newton_config (the
    capped step config), ONE wide fresh probe at restart_config (bisect/48,
    every improving lane accepted) against the end-of-sweep background,
    then n_polish Gauss-Seidel polish sweeps at polish_config (or
    restart_config). Otherwise: n_sweeps warm sweeps then n_restart
    per-class restart sweeps, all at newton_config. plain: every fit runs
    the kernels' plain twins. mesh: a (src, pix) mesh over a pod whose
    every rank stages the same fields; the schedule's fits are sharded
    over its src axis (JAX fused.py:498-513). The rows are not padded to
    the axis here: mesh.fit_row_sharded pads each row to a multiple of
    it (blocks of two lanes or more, mesh.row_block), where JAX pads W to
    the axis's power of two (:332-334, :426-428)."""
    t_start = time.perf_counter()
    offsets = np.cumsum([0] + [len(st.catalog) for st in states])
    S_tot = int(offsets[-1])
    st0 = states[0]
    dev, dtype = st0.device, st0.dtype

    def owner(m):
        f = int(np.searchsorted(offsets, m, side="right") - 1)
        return f, m - int(offsets[f])

    n_cls = len(classes)
    tile_of = {}
    for f, st in enumerate(states):
        o = int(offsets[f])
        for s in st.targets:
            tile_of[o + s] = int(st.tile[s])
    tiles = sorted({tile_of[m] for cls in classes for m in cls})
    B = len(st0.images)

    grp = {t: [[m for m in cls if tile_of[m] == t] for cls in classes]
           for t in tiles}
    widths = fused_bucket_widths(classes, lambda m: tile_of[m])
    uniq_t = {t: sorted({m for g in grp[t] for m in g}) for t in tiles}
    # JAX's estimate: 4 float32 arrays of the bucket's unique rows, counted
    # at their power of two
    est_bytes = sum(_next_pow2(len(uniq_t[t])) * B * t * t * 4 * 4
                    for t in tiles)
    if est_bytes > budget_bytes:
        Log.info(f"fused joint: staging ~{est_bytes >> 20} MiB exceeds the "
                 "budget; using the host-driven schedule")
        return None

    # merged neighbor tables (field indices offset: no cross-field edges)
    # and merged state, float64 as the host-driven path keeps it
    NB = st0.nb_idx.shape[1]
    nb_idx = np.zeros((S_tot, NB), dtype=np.int64)
    nb_mask = np.zeros((S_tot, NB))
    vps = np.zeros((S_tot, 44))
    elbos = np.full(S_tot, -np.inf)
    convs = np.zeros(S_tot, dtype=bool)
    for f, st in enumerate(states):
        o = int(offsets[f])
        sl = slice(o, o + len(st.catalog))
        nb_idx[sl] = st.nb_idx + o
        nb_mask[sl] = st.nb_mask
        vps[sl] = st.vps
        elbos[sl] = st.elbos
        convs[sl] = st.converged

    counts_by_src = {}
    fresh_by_src = np.zeros((S_tot, 44))
    buckets, wide = [], []
    for t in tiles:
        uniq = uniq_t[t]
        pat_row = {m: i for i, m in enumerate(uniq)}
        by_field = {}
        for m in uniq:
            f, s = owner(m)
            by_field.setdefault(f, []).append(s)
        for f, ss in by_field.items():
            states[f].build_patches(ss, tile=t)
        patches = stack_patches([states[owner(m)[0]].patch(owner(m)[1],
                                                            tile=t)
                                 for m in uniq], dev, dtype)
        for m in uniq:
            f, s = owner(m)
            counts_by_src[m] = states[f]._pixel_counts[(s, t)]
            fresh_by_src[m] = generic_init_source(states[f].catalog[s].pos)
        row = lambda lanes, n: _lane_row(
            lanes, n, pat_row, nb_idx, nb_mask, fresh_by_src, counts_by_src,
            patches, t, dev, dtype)
        # a (class, bucket) group padded with its own first member; an
        # empty group is never staged (n_real 0: the step skips it)
        W = widths[t]
        buckets.append({
            "tile": t, "n_real": [len(g) for g in grp[t]],
            "rows": [row(g + [g[0]] * (W - len(g)), len(g)) if g else None
                     for g in grp[t]]})
        W_w = _next_pow2(len(uniq))
        wide.append(row(uniq + [uniq[0]] * (W_w - len(uniq)), len(uniq)))

    split = n_restart > 0 and restart_config is not None
    n_wide = 1 + max(n_polish, 0) if split else 0
    label = (f"fused F={len(states)} C={n_cls} "
             + " ".join(f"P{t}:W={widths[t]}" for t in tiles)
             + f" steps={n_cls * (n_sweeps + n_restart)}"
             + (f" +probe(wide)+{max(n_polish, 0)}polish" if split else ""))
    f64 = dict(dtype=torch.float64, device=dev)
    carry = _Carry(
        vps=torch.as_tensor(vps, **f64), elbos=torch.as_tensor(elbos, **f64),
        conv=torch.as_tensor(convs, device=dev),
        iters=torch.zeros(S_tot, dtype=torch.int64, device=dev),
        **{k: torch.zeros((), **f64) for k in ("rv", "tv", "ri", "ss", "fl")})
    return {"states": states, "offsets": offsets, "carry": carry,
            "buckets": buckets, "wide": wide, "n_classes": n_cls,
            "n_sweeps": n_sweeps, "n_restart": n_restart, "split": split,
            "n_polish": n_polish, "config": newton_config,
            "restart_config": restart_config,
            "polish_config": polish_config or restart_config, "plain": plain,
            "mesh": mesh,
            "touched": sorted({m for cls in classes for m in cls}),
            "n_fits": sum(len(cls) for cls in classes)
            * (n_sweeps + (0 if n_wide else n_restart) + n_wide),
            "label": label, "stage_s": time.perf_counter() - t_start}


def _run_schedule(h):
    """The staged schedule of handle `h`, on its carry."""
    cr, bk, n_cls = h["carry"], h["buckets"], h["n_classes"]
    mesh = h["mesh"]
    if h["split"]:
        _fused_joint_program(cr, bk, n_cls, h["n_sweeps"], 0, h["config"],
                             h["plain"], mesh)
        _fused_wide_pass(cr, h["wide"], h["restart_config"], h["plain"],
                         fresh=True, resolve=False, mesh=mesh)
        if h["n_polish"] > 0:
            _fused_joint_program(cr, bk, n_cls, h["n_polish"], 0,
                                 h["polish_config"], h["plain"], mesh)
    else:
        _fused_joint_program(cr, bk, n_cls, h["n_sweeps"], h["n_restart"],
                             h["config"], h["plain"], mesh)
    touched = torch.as_tensor(h["touched"], device=cr.vps.device)
    # the schedule's one transfer: the touched rows and the sums
    sums = torch.stack([cr.rv, cr.tv, cr.ri, cr.ss, cr.fl]).cpu().numpy()
    return (cr.vps[touched].cpu().numpy(), cr.elbos[touched].cpu().numpy(),
            cr.conv[touched].cpu().numpy(), cr.iters[touched].cpu().numpy(),
            sums)


def _fused_joint_finish(handle):
    """Run a _fused_joint_dispatch handle's schedule and apply its results
    to every field's InferenceState, with the telemetry. Only the rows the
    schedule fit (`touched`) are written: isolated targets are fit by a
    separate launch (_fit_isolated_multi) whose results must not be
    overwritten by the staged values. In production (CELESTE_PROD) a
    failure is logged, its sources counted in `failures`, and every field
    keeps its previous state (ParallelRun.jl:390-396); otherwise it
    raises. With a mesh, a fit that fails on one rank fails the same step
    on every rank (mesh.fit_row_sharded), so every rank raises, or in
    production every rank keeps its previous state; a rank that dies, or
    fails outside a fit, leaves the others waiting in their next gather
    until the pod's group timeout, which raises there."""
    t0 = time.perf_counter()
    try:
        vps_o, elbos_o, conv_o, iters_o, sums = _run_schedule(handle)
    except Exception as exc:
        if not is_production_run():
            raise
        Log.exception(exc)
        telemetry.counters.failures += len(handle["touched"])
        return
    handle["schedule_s"] = time.perf_counter() - t0
    Log.info(f"{handle['label']}: staging {handle['stage_s']:.2f}s, "
             f"schedule {handle['schedule_s']:.2f}s")
    states, offsets = handle["states"], handle["offsets"]
    touched = np.asarray(handle["touched"], dtype=np.int64)
    for f, st in enumerate(states):
        o, S = int(offsets[f]), len(st.catalog)
        sel = (touched >= o) & (touched < o + S)
        loc = touched[sel] - o
        st.vps[loc] = vps_o[sel]
        st.elbos[loc] = elbos_o[sel]
        st.converged[loc] = conv_o[sel]
        st.iters[loc] += iters_o[sel]
    rv, tv, ri, ss, fl = (float(x) for x in sums)
    c = telemetry.counters
    c.sources_fit += handle["n_fits"]
    c.newton_iters += int(ri)
    c.serial_steps += int(ss)
    c.pixel_visits += int(rv)
    c.padded_visits += int(max(tv - rv, 0.0))
    c.model_flops += fl
