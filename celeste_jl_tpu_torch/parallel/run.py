"""Top-level inference schedules (port of celeste_jl_tpu/parallel/run.py;
ParallelRun.jl).

The reference schedules per-source Newton fits across CPU threads with a
Cyclades conflict-graph partition (ParallelRun.jl:135-397). Here the
serial-equivalence guarantee maps to conflict-free classes: no two sources
of a class share pixels, so a class is one batched fit per tile bucket,
with the neighbors' freshest variational parameters rendered as fixed
background (the reference's inactive-source path, elbo_objective.jl:33-41).

The joint schedule runs on one engine, the fused schedule
(parallel/fused.py), its state on the device: by default over the
width-capped classes of packing.fused_color_classes (the JAX package's
default), with fused=False over the greedy color_classes (the JAX
package's CELESTE_FUSED=0 schedule, whose bits the engine reproduces).
The host-driven loop runs only for a Cyclades batch_size, a checkpoint
or a staging over the device budget.
joint_infer_fields merges several fields into one fused schedule;
joint_infer_fields_pipelined stages a stream of such groups, one ahead.
Entry points run on the card unless the caller passes device="cpu". On a
CUDA device every fit runs the kernels (K1 refresh, K2 Jacobi sweep, K3
TR subproblem); on the CPU the f64 parity route (torch eigh and the plain
twins).
"""

import os
import time

import numpy as np
import torch

from ..detection.detect import detect_sources
from ..models.patches import stack_patches
from ..ops.newton import NewtonConfig
from ..utils import log as Log
from ..utils import telemetry
from ..utils.config import Config
from ..utils.device import resolve
from ..vi.init import generic_init_source
from ..vi.stochastic import SVIConfig, svi_maximize
from .common import (TILE_BUCKETS, _beats, _next_pow2, _render_neighbor_bg,
                     is_production_run)
from .fused import _fused_joint_dispatch, _fused_joint_finish
from .packing import (_dual_chunk_cap, _pow2_chunks, _waves, color_classes,
                      fused_bucket_widths, fused_color_classes)
from .partition import partition_cyclades_dynamic
from .state import (InferenceState, OptimizedSource, detection_active_boxes,
                    fit_for_width, read_fit)


def card_newton_config(newton_config: NewtonConfig, dtype):
    """The solver the card runs in `dtype`: pjacobi with the refresh and TR
    kernels, K1-K3. In float32 4 sweeps to 1e-6 of ||H|| (bench.py's); in
    float64 up to 8 sweeps to 1e-12, so that a fit on a flat ridge ends
    where eig's does (at 4 sweeps GalSim's simple_star stops 3 nats short,
    P(star) 0.9416 against eig's 0.9950). On CPU tensors the same config
    runs the kernels' plain twins."""
    sweeps, tol = (8, 1e-12) if dtype == torch.float64 else (4, 1e-6)
    return newton_config._replace(tr_solver="pjacobi",
                                  jacobi_max_sweeps=sweeps, jacobi_tol=tol,
                                  tr_kernel="pallas", refresh_kernel="pallas")


def _platform_newton_config(newton_config: NewtonConfig, device, dtype):
    """The solver of a torch.device: on a CUDA device card_newton_config;
    on the CPU the caller's config (the default is eig with the plain
    twins, the f64 parity route)."""
    if device.type == "cuda":
        return card_newton_config(newton_config, dtype)
    return newton_config


def _capped_step_config(newton_config: NewtonConfig, config: Config):
    """The warm sweeps' config: Config.joint_step_refreshes Hessian
    refreshes a class-step (a batched step runs every lane until the
    slowest converges; a truncated lane resumes next sweep), and 16
    safeguarded-Newton iterations on the secular equation in place of 48
    bisections (the JAX package's choice for its narrow class-steps). The
    probe and polish keep the caller's bisect/48."""
    cap = config.joint_step_refreshes
    if cap and cap < newton_config.max_iters:
        newton_config = newton_config._replace(max_iters=cap)
    return newton_config._replace(secular="newton", bisect_iters=16)


def _probe_config(restart_cfg: NewtonConfig, config: Config):
    """The fresh-init probe's config: the caller's solver at
    Config.probe_refreshes Hessian refreshes (0 = full)."""
    cap = config.probe_refreshes
    if cap and cap < restart_cfg.max_iters:
        return restart_cfg._replace(max_iters=cap)
    return restart_cfg


def _polish_config(restart_cfg: NewtonConfig, config: Config):
    """(polish config, polish sweep count): the probe's solver capped at
    Config.polish_refreshes refreshes a class-step, Config.polish_sweeps
    sweeps."""
    cap = config.polish_refreshes
    cfg = restart_cfg
    if cap and cap < cfg.max_iters:
        cfg = cfg._replace(max_iters=cap)
    return cfg, config.polish_sweeps


def _wide_pass_host(st, union, newton_config, fresh, resolve=None,
                    plain=False):
    """One wide keep-better launch per tile bucket over `union` against the
    frozen current vps, then conflict-resolved acceptance (best gain per
    neighborhood, ties to the lower id; resolve=False, the probe, accepts
    every improving lane) applied across all buckets at once."""
    if resolve is None:
        resolve = not fresh
    snap = st.vps.copy()
    pend = [st.dispatch_group(
        [s for s in union if st.tile[s] == P], newton_config,
        use_bg=True, bg_vps=snap, fresh_init=fresh, keep_better=True,
        plain=plain)
        for P in TILE_BUCKETS]
    recs, gain = [], {}
    for p in pend:
        if p is None:
            continue
        idx, n = p["idx"], p["n"]
        try:
            vp, el, cv, it, fcalls = read_fit(p["res"], n)
        except Exception as exc:
            if not is_production_run():
                raise
            Log.exception(exc)
            telemetry.counters.failures += len(idx)
            continue
        telemetry.record_launch_wall(p["t0"], p["label"])
        inc = p["inc"].double().cpu().numpy()[:n]
        improving = _beats(el, inc)
        for k, s in enumerate(idx):
            gain[s] = float(el[k] - inc[k]) if improving[k] else -np.inf
        recs.append((p, idx, vp, el, cv, it, fcalls, inc))
    for p, idx, vp, el, cv, it, fcalls, inc in recs:
        take = np.zeros(len(idx), dtype=bool)
        for k, s in enumerate(idx):
            gi = gain[s]
            if gi == -np.inf:
                continue
            blocked = False
            if resolve:
                for j, nb in enumerate(st.nb_idx[s]):
                    if st.nb_mask[s, j] <= 0:
                        continue
                    gj = gain.get(int(nb), -np.inf)
                    if gj > gi or (gj == gi and int(nb) < s):
                        blocked = True
                        break
            take[k] = not blocked
        idxa = np.asarray(idx)
        st.elbos[idxa[~take]] = inc[~take]
        st.vps[idxa[take]] = vp[take]
        st.elbos[idxa[take]] = el[take]
        st.converged[idxa[take]] = cv[take]
        st.iters[idxa] += it
        telemetry.record_fit_launch(
            p["n_lanes"], p["pad"] - p["n_lanes"],
            pixels_per_lane_real=p["pixel_counts"][:p["n_lanes"]],
            pixels_per_lane_total=p["pixels_per_lane_total"],
            f_calls=fcalls, tile=p["tile"], bands=p["bands"],
            hess_every=p["hess_every"])


def _joint_configs(newton_config, config, device, dtype):
    """(the full-budget fits' config (the isolated targets'), the warm
    sweeps', the probe's, the polish's, the polish sweep count) of the
    joint schedules on `device` in `dtype`."""
    newton_config = _platform_newton_config(newton_config, device, dtype)
    polish_cfg, n_polish = _polish_config(newton_config, config)
    return (newton_config, _capped_step_config(newton_config, config),
            _probe_config(newton_config, config), polish_cfg, n_polish)


def one_node_joint_infer(catalog, images, target_sources=None,
                         config=Config(), batch_size=None,
                         newton_config=NewtonConfig(), max_neighbors=8,
                         seed=42, state=None, checkpoint_path=None,
                         restart_final=True, active_boxes=None, *,
                         device="cuda", dtype=torch.float32, plain=False,
                         fused=True, mesh=None):
    """Joint VI over all targets: num_joint_vi_iters warm sweeps over
    conflict-free classes of the overlap graph, each class one batched
    launch per tile bucket with the neighbors as freshest-vp background;
    pass batch_size for the reference's Cyclades batch/wave schedule
    (ParallelRun.jl:135-196) instead. With the classes, targets that
    share no pixels with another target are fit once, dual-init, at the
    full budget (_fit_isolated_multi).

    The classes run as the fused schedule (parallel/fused.py), by default
    packed by fused_color_classes (the JAX package's default); fused=False
    packs them by the greedy color_classes, the JAX package's
    CELESTE_FUSED=0 schedule (its host-driven loop and this engine give
    the same bits over the same classes). A Cyclades batch_size, a
    checkpoint_path, or a staging over the device budget takes the
    host-driven loop.

    checkpoint_path: npz saved after every sweep or batch; if it exists,
    inference resumes from the stored cursor.

    restart_final: after the warm sweeps, refit every scheduled target from
    a fresh generic init against the converged backgrounds and keep the
    better ELBO (the probe: a warm start can lock a source into the basin
    it chose while its neighbors were unfit), then Config.polish_sweeps
    warm sweeps at the caller's solver (each class's last fit predates its
    neighbors' later moves).

    plain: run every kernel's plain twin (the comparison route).

    mesh: a (src, pix) mesh (parallel/mesh.make_mesh) over a pod whose
    every rank makes this call with the same arguments: the fused
    schedule's fits are sharded over its src axis (fused.py) and every
    rank returns the same results. The isolated targets' fits and the
    host-driven loop are not sharded, as in the JAX package (run.py:378
    hands the mesh to the fused dispatch alone): every rank runs them
    whole."""
    st = state or InferenceState(catalog, images, config, target_sources,
                                 max_neighbors, active_boxes=active_boxes,
                                 device=device, dtype=dtype, plain=plain)
    newton_config, step_config, restart_cfg, polish_cfg, n_polish = \
        _joint_configs(newton_config, config, st.device, st.dtype)
    targets = st.targets
    tset = set(targets)
    nb_for_targets = {s: [n for n in st.neighbor_map[s] if n in tset]
                      for s in targets}
    rng = np.random.default_rng(seed)
    if batch_size is None:
        # an isolated target's ELBO shares no term with another target's:
        # re-fitting it every sweep is an identity, so it is fit once
        isolated = [s for s in targets if not nb_for_targets[s]]
        constrained = [s for s in targets if nb_for_targets[s]]
        sweeps = [color_classes(constrained, nb_for_targets, rng)
                  if constrained else []]
        Log.info(f"joint infer: {len(targets)} sources "
                 f"({len(isolated)} isolated), "
                 f"{len(sweeps[0])} conflict-free color classes")
    else:
        sweeps = [
            _waves(comps) for comps in partition_cyclades_dynamic(
                targets, nb_for_targets, batch_size=batch_size, rng=rng)]
        Log.info(f"joint infer: {len(targets)} sources, "
                 f"{len(sweeps)} Cyclades batches")

    cursor = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        cursor = st.restore(checkpoint_path)
        Log.info(f"joint infer: resuming at step {cursor}")

    isolated_done = False
    if batch_size is None and not checkpoint_path and targets:
        telemetry.counters.reset()
        try:
            # stage the constrained classes' schedule, fit the isolated
            # targets (never a constrained target's neighbor, so neither
            # reads the other's updates), then run the schedule
            handle = None
            if constrained:
                classes = (fused_color_classes(
                    constrained, nb_for_targets, np.random.default_rng(seed),
                    tile={s: int(st.tile[s]) for s in constrained})
                    if fused else sweeps[0])
                handle = _fused_joint_dispatch(
                    [st], classes, step_config,
                    n_sweeps=config.num_joint_vi_iters,
                    n_restart=1 if restart_final else 0,
                    restart_config=restart_cfg, polish_config=polish_cfg,
                    n_polish=n_polish, plain=plain, mesh=mesh)
            _fit_isolated_multi([st], isolated, newton_config, plain=plain)
            isolated_done = True
            if not constrained or handle is not None:
                if handle is not None:
                    _fused_joint_finish(handle)
                telemetry.counters.report("joint infer (fused)", st.device)
                return _collect_results(st)
            # handle is None: the staging exceeded the device budget; the
            # host-driven schedule below runs instead
        except Exception as exc:
            if not is_production_run():
                raise
            Log.exception(exc)

    def fit_class(cls, widths, cfg=None):
        # the tile-bucket groups of one class are mutually conflict-free
        pend = [st.dispatch_group([s for s in cls if st.tile[s] == P],
                                  cfg or step_config, use_bg=True,
                                  width=widths.get(P), plain=plain)
                for P in TILE_BUCKETS]
        for p in pend:
            st.finish_group(p)

    if not isolated_done:
        telemetry.counters.reset()
        if batch_size is None and cursor == 0:
            _fit_isolated_multi([st], isolated, newton_config, plain=plain)
    tile_of = lambda s: int(st.tile[s])
    w_by_groups = [fused_bucket_widths(groups, tile_of) for groups in sweeps]
    step = 0
    for it in range(config.num_joint_vi_iters):
        for groups, widths in zip(sweeps, w_by_groups):
            step += 1
            if step <= cursor:
                continue
            for cls in groups:
                fit_class(cls, widths)
            if checkpoint_path:
                st.save(checkpoint_path, cursor=step)
    if restart_final:
        union = sorted({s for groups in sweeps for cls in groups
                        for s in cls})
        _wide_pass_host(st, union, restart_cfg, fresh=True, resolve=False,
                        plain=plain)
        for _ in range(n_polish):
            for groups, widths in zip(sweeps, w_by_groups):
                for cls in groups:
                    fit_class(cls, widths, cfg=polish_cfg)
    telemetry.counters.report("joint infer", st.device)
    return _collect_results(st)


def joint_infer_fields(fields, config=Config(),
                       newton_config=NewtonConfig(), max_neighbors=8,
                       seed=42, restart_final=True, *, device="cuda",
                       dtype=torch.float32, plain=False, mesh=None):
    """Joint VI over MULTIPLE independent fields (boxes) as ONE fused
    schedule.

    fields: list of dicts with keys `catalog`, `images`, and optionally
    `target_sources` / `active_boxes` (as one_node_joint_infer takes
    them). Returns a list of per-field result lists.

    A sparse field alone fills few lanes of a class step. Fields never
    conflict, so their classes merge laterally: the width-capped packer
    runs on the union conflict graph with field-offset source ids and
    packs sources of different fields into the same class. Reference
    analog: the box-level task farm (contrib/nersc/infer.sl:30) x per-box
    thread scheduling (ParallelRun.jl:302-369), which never shared a
    thread pool across boxes. Falls back to per-field one_node_joint_infer
    when the merged staging exceeds the device budget. Runs on `device`
    in `dtype`; plain runs the kernels' plain twins; mesh: as
    one_node_joint_infer's, for the merged schedule and the fallback."""
    states, classes, isolated = _merged_states_classes(
        fields, config, max_neighbors, seed, device, dtype, plain)
    iso_cfg, step_cfg, restart_cfg, polish_cfg, n_polish = _joint_configs(
        newton_config, config, resolve(device), dtype)
    telemetry.counters.reset()
    handle = None
    if classes:
        handle = _fused_joint_dispatch(
            states, classes, step_cfg, n_sweeps=config.num_joint_vi_iters,
            n_restart=1 if restart_final else 0, restart_config=restart_cfg,
            polish_config=polish_cfg, n_polish=n_polish, plain=plain,
            mesh=mesh)
        if handle is None:
            return [one_node_joint_infer(
                f["catalog"], f["images"], f.get("target_sources"), config,
                newton_config=newton_config, max_neighbors=max_neighbors,
                seed=seed, restart_final=restart_final,
                active_boxes=f.get("active_boxes"), device=device,
                dtype=dtype, plain=plain, mesh=mesh) for f in fields]
    _fit_isolated_multi(states, isolated, iso_cfg, plain=plain)
    if handle is not None:
        _fused_joint_finish(handle)
    telemetry.counters.report("joint infer (fields, fused)",
                              resolve(device))
    return [_collect_results(st) for st in states]


def _merged_states_classes(fields, config, max_neighbors, seed, device,
                           dtype, plain):
    """Per-field InferenceStates and merged-id conflict classes of one
    fused multi-field schedule (the staging step of joint_infer_fields and
    joint_infer_fields_pipelined). Targets with no target neighbor are split out
    (third value, merged ids): their fits are independent of the whole
    schedule, so they go to wide dual-init launches (_fit_isolated_multi)
    instead of riding every sweep."""
    states = [InferenceState(f["catalog"], f["images"], config,
                             f.get("target_sources"), max_neighbors,
                             active_boxes=f.get("active_boxes"),
                             device=device, dtype=dtype, plain=plain)
              for f in fields]
    if len({len(st.images) for st in states}) > 1:
        raise ValueError("all fields must have the same number of bands")

    offsets = np.cumsum([0] + [len(st.catalog) for st in states])
    merged_targets, merged_nb, merged_tile = [], {}, {}
    for f, st in enumerate(states):
        o = int(offsets[f])
        tset = set(st.targets)
        for s in st.targets:
            merged_targets.append(o + s)
            merged_nb[o + s] = [o + n for n in st.neighbor_map[s]
                                if n in tset]
            merged_tile[o + s] = int(st.tile[s])

    isolated = [m for m in merged_targets if not merged_nb[m]]
    constrained = [m for m in merged_targets if merged_nb[m]]
    classes = (fused_color_classes(constrained, merged_nb,
                                   np.random.default_rng(seed),
                                   tile=merged_tile)
               if constrained else [])
    Log.info(f"joint infer (fields): {len(states)} fields, "
             f"{len(merged_targets)} sources ({len(isolated)} isolated), "
             f"{len(classes)} merged classes")
    return states, classes, isolated


def _fit_isolated_multi(states, isolated, newton_config, plain=False):
    """Fit isolated targets (merged ids over `states`' catalogs) at the
    full single-fit budget, dual-init: lane i from the current vp, lane
    n+i from a generic init, the better basin kept. Non-target neighbors
    enter as fixed catalog-init background.

    On the CPU every member is its own launch (two lanes, no padding: a
    padding lane costs a full serial fit there), as in the JAX package. On
    a CUDA device members go in power-of-two chunks per tile bucket,
    padded to a power of two with no 32-lane floor."""
    if not isolated:
        return
    cpu = states[0].device.type == "cpu"
    offsets = np.cumsum([0] + [len(st.catalog) for st in states])

    def owner(m):
        f = int(np.searchsorted(offsets, m, side="right") - 1)
        return f, m - int(offsets[f])

    by_tile = {}
    for m in isolated:
        f, s = owner(m)
        by_tile.setdefault(int(states[f].tile[s]), []).append((f, s))

    def dispatch(t, members):
        n = len(members)
        nl = 2 * n
        pad = _next_pow2(nl)
        members_p = members + members + [members[0]] * (pad - nl)
        by_field = {}
        for f, s in members_p:
            by_field.setdefault(f, []).append(s)
        for f, ss in by_field.items():
            states[f].build_patches(ss)
        st0 = states[0]
        patches = stack_patches([states[f].patch(s) for f, s in members_p],
                                st0.device, st0.dtype)
        counts = np.array([states[f]._pixel_counts[(s, t)]
                           for f, s in members_p])
        vp0 = np.stack([states[f].vps[s] for f, s in members_p])
        vp0[n:nl] = np.stack(
            [generic_init_source(states[f].catalog[s].pos)
             for f, s in members])
        nb_vps = np.stack([states[f].vps[states[f].nb_idx[s]]
                           for f, s in members_p])
        nb_mask = np.stack([states[f].nb_mask[s] for f, s in members_p])
        t0 = telemetry.now()
        bg_E, bg_V = _render_neighbor_bg(st0.tensor(nb_vps),
                                         st0.tensor(nb_mask), patches)
        res = fit_for_width(pad)(st0.tensor(vp0), patches, bg_E, bg_V,
                                 config=newton_config, plain=plain)
        return (members, t, n, pad, res, counts, t0,
                int(np.prod(patches.mask.shape[1:])),
                f"isolated n={n} pad={pad} P{t}")

    # catch-log-continue in production on dispatch and read
    # (ParallelRun.jl:390-396): a failed launch leaves its sources as they
    # were
    pending = []
    for t, group in sorted(by_tile.items()):
        chunks = ([[m] for m in group] if cpu else
                  _pow2_chunks(group, cap=_dual_chunk_cap(t)))
        for members in chunks:
            try:
                pending.append(dispatch(t, members))
            except Exception as exc:
                if not is_production_run():
                    raise
                Log.exception(exc)
                telemetry.counters.failures += len(members)

    for members, t, n, pad, res, counts, t0, lane_total, label in pending:
        nl = 2 * n
        try:
            vp, elbo, conv, iters, f_calls = read_fit(res, nl)
        except Exception as exc:
            if not is_production_run():
                raise
            Log.exception(exc)
            telemetry.counters.failures += n
            continue
        telemetry.record_launch_wall(t0, label)
        # the better basin per source, by the rounding margin (_beats), so
        # near-ties stay in the warm basin whatever the packing
        fresh = _beats(elbo[n:nl], elbo[:n])
        vp = np.where(fresh[:, None], vp[n:nl], vp[:n])
        elbo = np.where(fresh, elbo[n:nl], elbo[:n])
        conv = np.where(fresh, conv[n:nl], conv[:n])
        it_tot = iters[:n] + iters[n:nl]
        for i, (f, s) in enumerate(members):
            states[f].vps[s] = vp[i]
            states[f].elbos[s] = elbo[i]
            states[f].converged[s] = conv[i]
            states[f].iters[s] += it_tot[i]
        telemetry.record_fit_launch(
            nl, pad - nl, pixels_per_lane_real=counts[:nl],
            pixels_per_lane_total=lane_total,
            f_calls=f_calls, tile=t, bands=len(states[0].images),
            hess_every=newton_config.hess_every)


def joint_infer_fields_pipelined(groups, config=Config(),
                                 newton_config=NewtonConfig(),
                                 max_neighbors=8, seed=42,
                                 restart_final=True, *, device="cuda",
                                 dtype=torch.float32, plain=False,
                                 mesh=None):
    """Farm-worker pipeline over fused multi-field schedules.

    `groups` is an ITERABLE of `fields` lists (each group one fused
    schedule, as joint_infer_fields takes it); yields one result list per
    group, in order. Group k+1 is pulled from the (typically lazy)
    iterable, so the caller's image loading and detection run, and is
    staged before group k's schedule runs and its results are yielded:
    the JAX package's double-buffered box staging. (There, group k's
    device work overlaps group k+1's host staging; the port's fit drives
    its loop from the host, so here the two run one after the other.)

    Two groups' stagings are held at once, so the per-group device budget
    is half joint_infer_fields'. A group that still exceeds it drains the
    pipeline and falls back to the per-field path. Telemetry counters are
    NOT reset per group: reset them before iterating for a per-farm
    report. mesh: as one_node_joint_infer's, for every group's schedule
    and fallback."""
    pending = None
    iso_cfg, step_cfg, restart_cfg, polish_cfg, n_polish = _joint_configs(
        newton_config, config, resolve(device), dtype)

    def finish(p):
        handle, states, isolated = p
        _fit_isolated_multi(states, isolated, iso_cfg, plain=plain)
        if handle is not None:
            _fused_joint_finish(handle)
        return [_collect_results(st) for st in states]

    n_restart = 1 if restart_final else 0
    for fields in groups:
        states, classes, isolated = _merged_states_classes(
            fields, config, max_neighbors, seed, device, dtype, plain)
        handle = (_fused_joint_dispatch(
            states, classes, step_cfg, n_sweeps=config.num_joint_vi_iters,
            n_restart=n_restart, restart_config=restart_cfg,
            polish_config=polish_cfg, n_polish=n_polish,
            budget_bytes=2 << 30, plain=plain, mesh=mesh) if classes
            else None)
        if classes and handle is None:
            if pending is not None:
                yield finish(pending)
                pending = None
            yield [one_node_joint_infer(
                f["catalog"], f["images"], f.get("target_sources"), config,
                newton_config=newton_config, max_neighbors=max_neighbors,
                seed=seed, restart_final=restart_final,
                active_boxes=f.get("active_boxes"), device=device,
                dtype=dtype, plain=plain, mesh=mesh) for f in fields]
            continue
        if pending is not None:
            yield finish(pending)
        pending = (handle, states, isolated)
    if pending is not None:
        yield finish(pending)


def one_node_single_infer(catalog, images, target_sources=None,
                          config=Config(), newton_config=NewtonConfig(),
                          max_neighbors=8, state=None, active_boxes=None, *,
                          device="cuda", dtype=torch.float32, plain=False):
    """Independent per-source fits with neighbors fixed at their catalog
    initialization (ParallelRun.jl:546-607 + process_source :468-498)."""
    st = state or InferenceState(catalog, images, config, target_sources,
                                 max_neighbors, active_boxes=active_boxes,
                                 device=device, dtype=dtype, plain=plain)
    newton_config = _platform_newton_config(newton_config, st.device,
                                            st.dtype)
    # the background comes from the initial vps for every target, as in
    # the reference's per-source ElboArgs: snapshot first
    vps0 = st.vps.copy()
    telemetry.counters.reset()
    pend = [st.dispatch_group([s for s in st.targets if st.tile[s] == P],
                              newton_config, use_bg=True, bg_vps=vps0,
                              plain=plain)
            for P in TILE_BUCKETS]
    for p in pend:
        st.finish_group(p)
    telemetry.counters.report("single infer", st.device)
    return _collect_results(st)


def one_node_svi_infer(catalog, images, target_sources=None,
                       config=Config(), svi_config=None, max_neighbors=8,
                       state=None, active_boxes=None, seed=42, *,
                       device="cuda", dtype=torch.float32):
    """Independent per-source fits by pixel-minibatch stochastic VI
    (vi/stochastic.svi_maximize) with the neighbors fixed at their
    catalog initialization: the single_vi schedule with Adam on minibatches
    in place of Newton trust-region, one launch per tile bucket at the
    bucket's own width. The subsamples come from one torch.Generator on the
    device, seeded with `seed`."""
    svi_config = svi_config or SVIConfig()
    st = state or InferenceState(catalog, images, config, target_sources,
                                 max_neighbors, active_boxes=active_boxes,
                                 device=device, dtype=dtype)
    vps0 = st.vps.copy()
    gen = torch.Generator(device=st.device)
    gen.manual_seed(seed)
    telemetry.counters.reset()
    for P in TILE_BUCKETS:
        idx = [s for s in st.targets if st.tile[s] == P]
        if not idx:
            continue
        t0 = telemetry.now()
        try:
            patches, counts = st.stacked_patches(idx)
            bg_E, bg_V = _render_neighbor_bg(st.tensor(vps0[st.nb_idx[idx]]),
                                             st.tensor(st.nb_mask[idx]),
                                             patches)
            res = svi_maximize(st.tensor(vps0[idx]), patches, bg_E, bg_V,
                               config=svi_config, generator=gen)
            vp = res.vp.double().cpu().numpy()
            elbo_v = res.elbo.double().cpu().numpy()
        except Exception as exc:
            # production: log, count, keep the sources as they were
            if not is_production_run():
                raise
            Log.exception(exc)
            telemetry.counters.failures += len(idx)
            continue
        telemetry.record_launch_wall(t0, f"svi n={len(idx)} P{P}")
        idxa = np.asarray(idx)
        st.vps[idxa] = vp
        st.elbos[idxa] = elbo_v
        st.converged[idxa] = np.isfinite(elbo_v)
        st.iters[idxa] += svi_config.steps
        telemetry.counters.sources_fit += len(idx)
        # each SVI step scores ~pixel_fraction of the active pixels
        telemetry.counters.pixel_visits += int(
            counts.sum() * svi_config.steps
            * min(svi_config.pixel_fraction, 1.0))
    telemetry.counters.report("svi infer", st.device)
    return _collect_results(st)


def bad_sky(ce, images):
    """Flag sources whose background intensity estimate looks inconsistent
    with the observed pixels (ParallelRun.jl:437-461)."""
    img = next((im for im in images if im.band == 3), None)
    if img is None:
        return False
    pc = np.asarray(img.world_to_pix(ce.pos))
    h = int(np.clip(round(pc[0]), 1, img.H)) - 1
    w = int(np.clip(round(pc[1]), 1, img.W)) - 1
    claimed_sky = img.sky_at(h, w) * img.iota_at(h)
    i0, i1 = max(0, h - 50), min(img.H, h + 51)
    j0, j1 = max(0, w - 50), min(img.W, w + 51)
    box = img.pixels[i0:i1, j0:j1]
    observed = np.median(box[~np.isnan(box)]) if box.size else claimed_sky
    return bool((claimed_sky + 5.0) < observed)


def _collect_results(st: InferenceState):
    results = []
    for s in st.targets:
        ce = st.catalog[s]
        results.append(OptimizedSource(
            init_pos=np.asarray(ce.pos, dtype=np.float64),
            vs=st.vps[s].copy(), elbo=float(st.elbos[s]),
            converged=bool(st.converged[s]),
            is_sky_bad=bad_sky(ce, st.images)))
    return results


def infer_box(images, box=None, method="joint_vi", catalog=None,
              config=Config(), *, device="cuda", dtype=torch.float32,
              plain=False, fused=True, **detect_kwargs):
    """Detect (or take) a catalog and infer all sources inside `box`
    (ParallelRun.jl:652-673). method: joint_vi | single_vi | svi | mcmc.
    Runs on `device` (raises for CUDA without a card) in `dtype`; plain
    runs the kernels' plain twins (the comparison route; svi and mcmc have
    none to choose); fused=False runs joint_vi over the JAX package's
    CELESTE_FUSED=0 classes (one_node_joint_infer's switch). Phase wall
    times (detect, infer) are logged, as the reference's box-level @time
    reporting
    (ParallelRun.jl:655-669)."""
    if method not in ("joint_vi", "single_vi", "svi", "mcmc"):
        raise ValueError(f"unknown method {method!r}")
    resolve(device)
    t0 = time.perf_counter()
    active_boxes = None
    if catalog is None:
        catalog, det_boxes = detect_sources(images, **detect_kwargs)
        if catalog:
            # patches cover the dilated detection footprints, as the
            # reference's patch construction (detection.jl:152-167)
            active_boxes = detection_active_boxes(catalog, det_boxes, images)
    t_detect = time.perf_counter() - t0
    Log.info(f"infer_box: {len(catalog)} detected sources, method={method} "
             f"(detect {t_detect:.2f}s)")
    if not catalog:
        return []
    if box is not None:
        pos = np.array([ce.pos for ce in catalog])
        targets = [i for i in range(len(catalog))
                   if box.contains(pos[i, 0], pos[i, 1])]
    else:
        targets = None
    t1 = time.perf_counter()
    kw = dict(device=device, dtype=dtype)
    if method == "joint_vi":
        out = one_node_joint_infer(catalog, images, targets, config,
                                   active_boxes=active_boxes, plain=plain,
                                   fused=fused, **kw)
    elif method == "single_vi":
        out = one_node_single_infer(catalog, images, targets, config,
                                    active_boxes=active_boxes, plain=plain,
                                    **kw)
    elif method == "svi":
        out = one_node_svi_infer(catalog, images, targets, config,
                                 active_boxes=active_boxes, **kw)
    else:
        from ..mcmc.infer import one_node_mcmc_infer
        out = one_node_mcmc_infer(catalog, images, targets, config, **kw)
    Log.info(f"infer_box: inferred {len(out)} sources "
             f"in {time.perf_counter() - t1:.2f}s")
    return out
