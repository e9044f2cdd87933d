#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (celeste_jl_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the repo root, one card

Phases, one line each; the first failure exits non-zero:
  1. set-up: needs a CUDA device, prints the card's name and power limit
     (nvidia-smi), builds the kernels from csrc/ with nvcc;
  2. K1-K3 against their plain torch twins on the card, at the main path's
     shapes, in f64 (tight) and f32 (the working type), with median times
     as a caller sees them (timed_ms) and a kernel's on the card alone;
  3. the slice: synthetic_patch_batch(1024, tile=32, seed=1) fitted by
     fit_sources_compacted with bench.py's configuration in f32; every ELBO
     finite and every kernel launched; fits/s, mean iterations, converged
     fraction and star/galaxy accuracy against the synthetic truth; each
     stage's batch and launches, and K2 and K3 checked and timed at the
     stage-2 bucket (the record's "stage2");
  4. the kernels against the plain twins on the slice: 64 sources fitted
     twice with bench.py's configuration; in f64 the classifications agree
     and no lane's ELBO is worse than the plain run's by more than 1e-4
     relative; the same comparison in f32 is reported;
  5. the compiled shape of the redesigned kernels K1, K4, K2, K3, K2a and
     K2b (registers, local memory, shared memory, blocks per SM; nvcc's
     -Xptxas -v lines); the MCMC slice's kernel K4 (the fused render +
     Poisson score) against its twin: on radius-8 patches (64 sources x 10
     samples on 32x32 tiles, plus 16x16 and 64x64) for each model through the
     single-model entry and for both models in one ragged launch, timed
     for the galaxy rows on 32x32 (the earlier shape of the kernel's
     record); and on the AIS's own patches (patch_radii, the neighbours'
     background, the largest source's tile: 64x64), both models in one
     launch as the evaluator scores them once (m = 1) and in the
     step-out's two copies (m = 2), timed with the bound and the exp floor
     (the m = 1 launch is the kernel's record); and the split Jacobi sweep
     K2a + K2b against its twin (f64) and against K2, bit for bit (f32 and
     f64), timed on 1024 matrices (the record), on phase 8's 256
     (`split_fit`) and on one (`floor_ms`);
  6. the MCMC slice at full width: run_ais_batched on bench_mcmc.py's
     64-source scene with the production AIS program (50 temperatures x
     10 samples, 25-step chains, 1000 bootstrap draws, both models) in
     f32; every lnZ and chain value finite, galaxy recall 1.0 and 2-sd
     calibration coverage >= 0.85 on r-flux and the four colors; K4
     launches (one per evaluation) and host reads per sweep;
  7. the AIS program through K4 and through its twin in f64 from the same
     seed on 8 sources (20 temperatures x 4 samples, 10-step chains): the
     same star/galaxy side everywhere and lnZ within 1e-6 relative on at
     least 7 of 8 sources; in a process of its own in the route pool
     after phase 13 (on its own copy of the scene);
  8. the fit of phase 4 with the split sweep (NewtonConfig.eigh_fused =
     False) against the fused one, f64, 256 sources: no flip, the same
     iterations per lane, ELBOs within 1e-9 relative;
  9. one sky box end to end: benchmark/run_field.py's field at its density
     of record cut to 128 sources on 512 x 512 px (its record is 512 on
     1024 x 1024; phase 13 carries that density at 1024 sources), seed 7,
     drawn on the card, then
     infer_box(joint_vi): detection (native labelling) and the joint
     schedule (the fused default) through K1-K3, f32, scored as
     run_field.py scores it;
     then single_vi on the same images and detections (15 refreshes a
     lane). Prints detect and infer seconds, sources/s, completeness,
     type accuracy, median r-flux error, the fit launches by lane width
     and K1-K3's launches by width, and times K1-K3 at the joint run's
     median fit-launch width. Bars:
     every ELBO finite, no failure, K1-K3 each launched, native detection
     built, completeness >= 0.95 and (joint_vi) type accuracy >= 0.90;
 10. the joint field path through the kernels and through the plain twins
     (infer_box(plain=True)), f64, 16 sources on 181 x 181 px (phase 9's
     density): 0 classification flips, no source's ELBO worse than 1e-4
     relative; each departure printed. Its two runs go in processes of
     their own, beside phase 14's, after phase 13 (host-bound checks, so
     they share the card without slowing a phase that is timed);
 11. the survey app at full width: one SDSS field (2048 x 1489 px, 5
     bands, 400 sources as run_field.py draws them, a psField PSF whose
     width varies by +-13 % across the frame) written to FITS files with
     the port's io/fits, then main(["sdss", <the frame less 20 px>,
     "--config", yml, "--method", "joint_vi", "--detect-thresh", "6"]) on
     the card in f64: FITS load with the field-center PSF fits, per-source
     PSF fits (K3 at D = 12), detection, the joint schedule through K1-K3;
     the .npz read back with load_results. Prints each stage's seconds,
     sources/s, completeness, type accuracy and median r-flux error
     (matched through the frame's TAN WCS), the fit launches by lane width
     and K1-K3's by width, and K3 against its twin and timed at the PSF
     fits' shape. Bars: every ELBO finite, 0 failures, completeness >=
     0.95, type accuracy >= 0.90, K1-K3 launched and K3 by the PSF fits,
     the r-band local PSF widths spanning >= 10 % across the targets,
     every target of the box in the .npz;
 12. the app's routes, f64, on a 256 x 256 SDSS field of 32 sources:
     fit_patch_psfs through K3 and through its twin (packed params within
     1e-9 relative); infer_box(joint_vi) through the kernels and through
     plain=True (0 flips, no ELBO worse than 1e-4 relative; the twins' run
     in a process of its own beside the phase's other runs); main with
     --method svi and single_vi (finite ELBOs, completeness >= 0.95) and
     the median ELBO gap between them; in a process of its own in the
     route pool after phase 13;
 13. the multi-field path at benchmark/run_multifield.py's size of
     record, through the port's runner (benchmark/multifield.run_pass): 8
     fields x 128 sources on 512 x 512 px (field f from seed 7 + 1000 f)
     drawn on the card, detected per field, inferred as ONE merged fused
     schedule by joint_infer_fields, f32 through K1-K3; scored as
     run_multifield.py scores. Prints the scores, fits, busy and summed
     launch seconds, device fits/s and sources/s, e2e sources/s,
     utilization, model GFLOP/s and MFU, serial TR steps, iterations a
     fit, converged fraction, the infer and detect walls, the fused
     staging's and the schedule's seconds, the fit launches by lane width,
     the merged classes (and how many hold sources of 2+ fields) and
     K1-K3's launches, and the runner's JSON record. Bars: finite ELBOs,
     0 failures, completeness >= 0.95, type accuracy >= 0.90, K1-K3
     launched, the fused staging taken (no budget fallback), a class with
     sources of two fields;
 14. the multi-field routes, f64, on two fields at phase 10's density (8
     sources on 128 x 128 px, seeds 7 and 1007): joint_infer_fields
     through the kernels and the twins (0 flips, no ELBO worse than 1e-4
     relative); the merged result against each field's own
     one_node_joint_infer (0 flips, the worst departure printed); one
     field over the host schedule's classes (fused=False) against the
     host-driven loop (a checkpoint run; every vs within 1e-8);
     joint_infer_fields_pipelined over lazy one-field groups
     against joint_infer_fields per group (bit for bit, the generator a
     group ahead).
 15. the GalSim suite's CI subset (benchmark/galsim.CI_CASES: five 96 x 96
     px scenes, radius 40) through the port's runner
     (benchmark/galsim_suite.run_suite), joint, f64, then the noise-free
     rerun of its two noisy scenes; each scene's estimates printed beside
     the JAX package's artifact row (benchmark/galsim_results.csv). Bars:
     0 noise-free violations, no star/galaxy misclassification, finite
     ELBOs, K1-K3 launched. It runs in a process of its own beside
     phases 10 and 14;
 16. the farm worker (python -m celeste_jl_tpu_torch.worker's main, f64,
     pipelined) on phase 11's SDSS files (kept under build/ until then),
     its box split 2 x 1, two boxes a group (one schedule); then the same
     command in a process of its own on the same workdir (the resume).
     Prints
     sources/s and each group's load, detect and infer seconds. Bars:
     every box saved, each of phase 11's targets in exactly one box's
     file, completeness >= 0.95 and type accuracy >= 0.90 over the union,
     0 failures, the resume completing 0 boxes, K1-K3 and K3 at D = 12
     (the PSF fits, field-center and per-source, from the worker's
     report) launched. It runs in a process of its own beside phases 10,
     14 and 15;
 17. the science runners and grad_mode="analytic":
     a. the MCMC-vs-VI experiment at full width
        (experiments/mcmc_experiment: 16 prior-drawn sources on 200 x 200
        px, joint VI through K1-K3, AIS through K4 at 50 temperatures x 10
        samples, f32), then mcmc_figures' tables. Bars: every file
        written, mc.csv a row a source with finite lnZs, finite VI ELBOs,
        K1-K4 launched, within_2_sd >= within_1_sd >= within_half_sd in
        every row. Its joint VI and its AIS (independent: both start
        from the truth) run in two processes of the route pool, each a
        call of mcmc_experiment.run(stage=...), the runner's own
        function;
     b. benchmark/bench_elbo at 512 sources on 32 x 32 tiles, f32, 3
        repeats: its JSON lines, every value finite;
     c. phase 4's 64 sources in f64 with grad_mode="analytic" against
        phase 4's autograd fit (0 flips, no ELBO further than 1e-6
        relative), then phase 3's 1024 sources in f32 with the analytic
        mode: fits/s beside phase 3's;
     d. results_to_fits over phase 16's result files: one row a target;
     e. benchmark/calibration on galsim.CI_CASES at one seed (f64), and
     f. benchmark/svi_compare at 32 sources on 256 px, one pass: their
        tables and JSON rows, K1-K3 launched; e and f one after the other
        in a process of the route pool.
 18. the pod (phase_pod), alone after 17d: two ranks spawned by
     parallel/mesh.spawn_pod, joined with Gloo and sharing the card,
     f64 (in the route pool, beside its ~16 processes, a rank's
     cusolverDnCreate failed). (a) phase 4's 64 sources fitted by fit_sources_sharded
     with run.card_newton_config on a (1, 2) mesh (each tile's rows split
     over the ranks: held to the one-process fit at phase 4's 1e-4 ELBO
     bar, its ELBOs to the whole tiles' ELBO at its parameters at 1e-6,
     its ranks' free vectors equal bit for bit) and a (2, 1) mesh (the
     sources split: held to one process's fits of the same blocks at
     1e-6), 0 flips and the same converged flags each, every rank's
     K1-K3 launched; (b) the worker CLI --distributed on both ranks over
     phase 11's files, 2 x 1 boxes: every box saved by rank 0, each of
     phase 11's targets once at its catalog position, finite ELBOs,
     every rank's K1-K3 launched; the pod's sources/s; (c) the joint
     schedule with its fits sharded: one_node_joint_infer(mesh=) on a (2,
     1) mesh over a field at phase 9's density, POD_JOINT_SOURCES = 64
     sources on 362 x 362 px (seed 7; phase 9's 128 on 512 x 512 cut to
     keep the script inside its time limit), detected here as phase 9
     detects, one warm and one polish sweep (POD_JOINT_CONFIG), f64
     through K1-K3, against the same call at mesh=None in this process
     beside the pod. Bars: every rank's results equal bit for bit, 0
     flips, the field's total ELBO within 1e-5 relative, each rank's
     K1-K3 launched; printed: each source's worst relative ELBO
     departure and the count over 1e-4 (the sharded pjacobi fits depend
     on their batch: ROADMAP queue 3), the walls and launches by rank.
Each phase prints its wall time; phases 7, 10, 12, 14, 15, 16, 17a, 17e
and 17f run together after 13 and print one (the route pool: its
processes block on the card's synchronizations, _blocking_sync). The line before the last is the
kernels' JSON record (each kernel's launches counted on its path: phase 3
for K1-K3, 6 for K4, 8 for K2a/K2b, `field_launches` on phase 9's joint
run, `app_launches` on phase 11's, `multifield_launches` on phase 13's,
`galsim_launches` on phase 15's, `farm_launches` on phase 16's worker
run, and `experiment_launches`, `bench_elbo_launches`,
`analytic_launches`, `calibration_launches` and `svi_compare_launches`
on phase 17's, and `pod_launches` on phase 18's two ranks; its
bound from this run's shapes at the H100's published f32 and memory
peaks); the last line is {"ok": true, "device": {...}}. The app's files go
to a directory under build/, removed at the end. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of phase 2 (relative to each output's magnitude, see _rel_err)
F64_TOL = 1e-9        # tests/test_pallas_refresh.py:69, test_pallas_tr.py
K1_F32_TOL = 1e-4     # f32 sums of ~1e3 pixel terms, with cancellation
K3_F32_TOL = 2e-5     # tests/test_pallas_tr.py:49 (rtol = atol = 2e-5)
EIGH_BARS = dict(dw=5e-3, orth=1e-4, resid=1e-4)   # test_pallas_eigh.py:46-54
SLICE_ELBO_TOL = 1e-4  # tests/test_pallas_eigh.py:69-108
K4_F64_TOL = 1e-10    # per row, relative: f64 sums of ~1e3 pixel terms
K4_F32_TOL = 2e-4     # tests/test_pallas_render.py:70
SPLIT_F64_TOL = 1e-11  # of ||H||, as K2's sweep in phase 2
COVERAGE_BAR = 0.85   # 2-sd coverage; the JAX run gave 0.906-0.984
SPLIT_ELBO_TOL = 1e-9
# phase 17c: analytic against autograd, f64 (tests/test_analytic_grad.py:77)
ANALYTIC_ELBO_TOL = 1e-6
# phase 9's quality bars: benchmark/run_field.py's score on its field of
# record (the JAX package's runs reached 0.977 and 0.935,
# benchmark/field_results.md)
FIELD_COMPLETENESS_BAR = 0.95
FIELD_TYPE_BAR = 0.90
# the field path's kernels
FIELD_KERNELS = ("refresh", "jacobi_sweep", "tr_subproblem")
# the AIS program of benchmark/bench_mcmc.py (the production config)
FULL_AIS = dict(num_temperatures=50, num_samples=10, num_samples_per_chain=25)
ROUTE_AIS = dict(num_temperatures=20, num_samples=4, num_samples_per_chain=10)
# phase 9's single_vi rerun on the joint run's detections, cut to 15
# Hessian refreshes a lane (the joint warm sweeps' budget) to keep the
# whole run near half its time limit
SINGLE_RERUN_REFRESHES = 15

# published peaks of one H100 SXM (NVIDIA's datasheet): float32
# outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
# float64 outside the tensor cores, the same datasheet
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
# the SFUs' exp2 rate: 16 a clock per SM (CUDA programming guide's
# throughput table, compute capability 9.0), 132 SMs, 1.98 GHz boost
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# the spin before each call timed on the card alone (timed_ms): ~1 ms at
# the H100's clock
SPIN_CYCLES = 2_000_000


class PhaseError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def timed_ms(fn, torch, reps=10, spin=False):
    """Median time of fn(), ms: CUDA events around each call, after one
    warm-up call, as a caller that waits for each call sees it (the host's
    enqueue counts where it is slower than the card: the `ms` of the
    kernels' record). spin: a spin kernel of ~1 ms runs before each call,
    so the host has enqueued the call by the time the card reaches it and
    the events time the card's work alone (`device_ms`)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops, nbytes, f64=False):
    """The least time the card could take for `flops` f32 (f64: float64)
    operations and `nbytes` of device memory traffic, and which of the two
    bounds it."""
    peak = PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _rel_err(got, want):
    """max |got - want| / (max |want| over the leading axis, per trailing
    index): each output entry is judged against its own magnitude."""
    got = got.double()
    want = want.double()
    scale = want.abs().amax(dim=0, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------

def refresh_rows(n_sources, tile, device, dtype, seed=1):
    """The refresh pass's rows at the fit's starting point of a synthetic
    batch: G = 5 n_sources rows, C = 30 components, N = tile^2 pixels."""
    import torch

    from celeste_jl_tpu_torch.ops.bijectors import enforce, to_bound, to_free
    from celeste_jl_tpu_torch.ops.refresh import band_pixel_rows
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.elbo import brightness_coeffs
    from celeste_jl_tpu_torch.vi.optimize import _make_bounds

    _, vp0s, p = synthetic_patch_batch(n_sources, tile=tile, seed=seed,
                                       device=device)
    p = p.to(device, dtype)
    vp0 = torch.as_tensor(vp0s, dtype=dtype, device=device)
    bounds = _make_bounds(vp0[:, 0:2])
    vp = to_bound(to_free(enforce(vp0, bounds), bounds), bounds)
    S, B = vp.shape[0], p.pixels.shape[1]
    C20 = brightness_coeffs(vp)
    zero = torch.zeros_like(p.sky)
    rows, mix = band_pixel_rows(
        vp[:, None, 0:6].expand(S, B, 6), C20[:, :10].reshape(S, 5, 2),
        C20[:, 10:].reshape(S, 5, 2), p.psf, p.wcs_jacobian, p.world_center,
        p.pixel_center, p.offset, p.pixels, p.mask, p.sky, p.iota, zero,
        zero)
    return rows, mix[0], (tile, tile)


def wide_spectrum_batch(rng, B, D=42, noise=1e-3):
    """B jittered copies of a symmetric D x D matrix whose spectrum spans
    ~8 decades with a negative tail (as
    tests/test_pallas_eigh.py::_wide_spectrum_batch)."""
    w_true = np.concatenate([-np.logspace(-4, 1, 6),
                             np.logspace(-5, 3, D - 6)])
    V, _ = np.linalg.qr(rng.standard_normal((D, D)))
    A0 = (V * w_true) @ V.T
    A0 = 0.5 * (A0 + A0.T)
    batch = A0 + noise * rng.standard_normal((B, D, D))
    return 0.5 * (batch + batch.transpose(0, 2, 1))


def tr_cases(rng, B, D=42):
    """Interior, boundary and near-hard-case lanes (as
    tests/test_pallas_tr.py::_cases)."""
    w = rng.standard_normal((B, D)) * 3.0
    w[: B // 3] = np.abs(w[: B // 3]) + 0.5
    gq = rng.standard_normal((B, D))
    gq[: B // 6] *= 1e-3
    delta = 10.0 ** rng.uniform(-3, 1, B)
    w[-1] = np.linspace(3.0, 0.5, D)
    w[-1, -1] = -2.0
    gq[-1, -1] = 1e-6
    delta[-1] = 5.0
    return gq, w, delta


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_setup():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    import celeste_jl_tpu_torch  # noqa: F401  (sets and asserts no TF32)
    from celeste_jl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"phase 1 ok: {torch.cuda.get_device_name(0)}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.relpath(path, ROOT)}; "
          f"registers and spills in its .ptxas.txt)", flush=True)


def phase_kernels(device="cuda", k1_sets=((1024, 32), (64, 16), (16, 128)),
                  n_mats=1024):
    """Each kernel against its plain twin at the main path's shapes: K1 on
    each (sources, tile) of k1_sets (the first is timed), K2 and K3 on
    n_mats matrices and lanes. Returns {name: record} for the JSON line."""
    import torch

    from celeste_jl_tpu_torch.ops import eigh, refresh, tr

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    rec = {}

    # K1: the refresh pixel pass
    names = ("lik_core", "m15", "hcross", "htc", "hcc", "gc")
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, K1_F32_TOL)):
        for i, (n_src, tile) in enumerate(k1_sets):
            rows, ks, pdims = refresh_rows(n_src, tile, device, dtype)
            got = refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
            want = refresh.pixel_terms_plain(*rows, ks=ks, pdims=pdims)
            sync()
            errs = {n: _rel_err(g, w) for n, g, w in zip(names, got, want)}
            err = max(errs.values())
            abs_err = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want))
            G, C = rows[2].shape
            msg = (f"K1 refresh {str(dtype)[6:]} G={G} C={C} P={tile}: "
                   f"rel err {err:.3g} (tol {tol:g}; "
                   + ", ".join(f"{n} {e:.2g}" for n, e in errs.items()) + ")")
            check(all(np.isfinite(list(errs.values()))) and err < tol, msg)
            if dtype == torch.float32 and i == 0:
                kernel = lambda: refresh.pixel_terms(*rows, ks=ks,
                                                     pdims=pdims)
                ms, device_ms = time_fn(kernel), time_fn(kernel, spin=True)
                plain_ms = time_fn(lambda: refresh.pixel_terms_plain(
                    *rows, ks=ks, pdims=pdims))
                # pass 1's work on the active pixels, ~(60 C + 400) flops
                # each (csrc/refresh.cu); every input read and output
                # written once
                N = rows[6].shape[-1]
                active = float(rows[7].sum())
                nbytes = 4 * (G * C * 42 + G * 6 + 5 * G * N
                              + G * C * 15 + G * 72)
                rec["refresh"] = dict(max_abs_err=abs_err, ms=ms,
                                      device_ms=device_ms,
                                      plain_ms=plain_ms, library_ms=None,
                                      **bound(active * (60 * C + 400),
                                              nbytes))
                msg += (f"; kernel {ms:.3f} ms ({device_ms:.3f} on the card "
                        f"alone), plain {plain_ms:.3f} ms")
            print(msg, flush=True)

    # K2: one parallel-Jacobi sweep, and jacobi_eigh through it
    rng = np.random.default_rng(0)
    H64 = wide_spectrum_batch(rng, n_mats)
    w_ref = np.linalg.eigvalsh(H64)
    for dtype in (torch.float64, torch.float32):
        H = torch.as_tensor(H64, dtype=dtype, device=device)
        eye = torch.eye(42, dtype=dtype, device=device).expand_as(H)
        A1, Q1 = eigh.jacobi_sweep(H, eye)
        A2, Q2 = eigh.jacobi_sweep_plain(H, eye)
        sync()
        # against ||H|| per matrix (the rotations drive entries to noise
        # level, so an entry-wise relative error means nothing) and against
        # 1 for the orthogonal Q
        norm = torch.linalg.matrix_norm(H.double())[:, None, None]
        sweep_err = max(float(((A1 - A2).double().abs() / norm).max()),
                        float((Q1 - Q2).abs().max()))
        abs_err = max(float((A1 - A2).abs().max()), float((Q1 - Q2).abs().max()))
        qual = {}
        for label, sweep in (("kernel", eigh.jacobi_sweep),
                             ("plain", eigh.jacobi_sweep_plain)):
            w, Q, sweeps = eigh.jacobi_eigh(H, tol=1e-6, max_sweeps=10,
                                            sweep=sweep)
            w = w.double().cpu().numpy()
            Qn = Q.double().cpu().numpy()
            dw = np.max(np.abs(np.sort(w, -1) - w_ref))
            orth = np.max(np.abs(np.einsum("bji,bjk->bik", Qn, Qn)
                                 - np.eye(42)))
            resid = (np.max(np.abs(np.einsum("bij,bjk->bik", H64, Qn)
                                   - w[:, None, :] * Qn))
                     / np.linalg.norm(H64[0]))
            qual[label] = (dw, orth, resid, sweeps)
        # A sweep amplifies rounding (a pair with a_pp ~ a_qq rotates by
        # +-45 degrees on the sign of a rounding difference), so in f32
        # one sweep is held only through the eigensolver's quality bars.
        tol = F64_TOL if dtype == torch.float64 else float("inf")
        kq = qual["kernel"]
        msg = (f"K2 jacobi_sweep {str(dtype)[6:]} B={n_mats} D=42: one sweep "
               f"rel err {sweep_err:.3g} (tol {tol:g}); jacobi_eigh kernel "
               f"|dw| {kq[0]:.3g} orth {kq[1]:.3g} resid {kq[2]:.3g} "
               f"({kq[3]} sweeps), plain |dw| {qual['plain'][0]:.3g} orth "
               f"{qual['plain'][1]:.3g} resid {qual['plain'][2]:.3g} (bars "
               f"{EIGH_BARS['dw']:g}, {EIGH_BARS['orth']:g}, "
               f"{EIGH_BARS['resid']:g})")
        check(sweep_err < tol and kq[0] < EIGH_BARS["dw"]
              and kq[1] < EIGH_BARS["orth"] and kq[2] < EIGH_BARS["resid"],
              msg)
        if dtype == torch.float32:
            kernel = lambda: eigh.jacobi_sweep(H, eye)
            ms, device_ms = time_fn(kernel), time_fn(kernel, spin=True)
            plain_ms = time_fn(lambda: eigh.jacobi_sweep_plain(H, eye))
            rec["jacobi_sweep"] = dict(max_abs_err=abs_err, ms=ms,
                                       device_ms=device_ms,
                                       plain_ms=plain_ms, library_ms=None,
                                       **sweep_bound(n_mats, 42, "aq"))
            msg += (f"; kernel {ms:.3f} ms ({device_ms:.3f} on the card "
                    f"alone), plain {plain_ms:.3f} ms")
        print(msg, flush=True)

    # K3: the trust-region subproblem
    gq64, w64, d64 = tr_cases(np.random.default_rng(7), n_mats)
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        gq, w, delta = t(gq64), t(w64), t(d64)
        p1, r1 = tr.tr_subproblem(gq, w, delta, 48)
        p2, r2 = tr.tr_subproblem_plain(gq, w, delta, 48)
        sync()
        if dtype == torch.float64:
            err = max(_rel_err(p1, p2), _rel_err(r1[:, None], r2[:, None]))
            ok = err < F64_TOL
            tol_txt = f"rel err {err:.3g} (tol {F64_TOL:g})"
        else:
            ok = k3_f32_ok(p1, r1, p2, r2)
            fin = torch.isfinite(p2)
            err = max(float((p1 - p2).abs()[fin].max()),
                      float((r1 - r2).abs()[torch.isfinite(r2)].max()))
            tol_txt = f"max abs err {err:.3g} (rtol = atol = {K3_F32_TOL:g})"
        msg = f"K3 tr_subproblem {str(dtype)[6:]} B={n_mats} D=42: {tol_txt}"
        check(ok, msg)
        if dtype == torch.float32:
            kernel = lambda: tr.tr_subproblem(gq, w, delta, 48)
            ms, device_ms = time_fn(kernel), time_fn(kernel, spin=True)
            plain_ms = time_fn(lambda: tr.tr_subproblem_plain(gq, w, delta,
                                                              48))
            # ~5 flops per coordinate per bisection; gq, w, delta in,
            # p and pred out
            rec["tr_subproblem"] = dict(
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=None, **tr_bound(n_mats, 42))
            msg += (f"; kernel {ms:.3f} ms ({device_ms:.3f} on the card "
                    f"alone), plain {plain_ms:.3f} ms")
        print(msg, flush=True)
    print("phase 2 ok: K1, K2, K3 agree with their plain twins", flush=True)
    return rec


def k3_f32_ok(p1, r1, p2, r2):
    """K3's (p, pred) against its twin's in f32: assert_allclose(rtol =
    atol = 2e-5) of tests/test_pallas_tr.py, with the non-finite entries
    (the near-hard lane overflows in f32) in the same places."""
    import torch

    def excess(a, b):
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            return float("inf")
        d = ((a - b).abs() - K3_F32_TOL * (1 + b.abs()))[fin]
        return float(d.max()) if d.numel() else 0.0

    return max(excess(p1, p2), excess(r1, r2)) <= 0


def sweep_bound(B, D, part):
    """Bound of one sweep of B D x D matrices: per round 3 flops per entry
    rotated (rows and columns of A, columns of Q) and ~12 per pair for its
    (c, s); bytes of A and/or Q in and out, and of the split's (c, s) log."""
    K, rounds = D // 2, D - 1
    per_round = {"aq": 9 * D * D + 12 * K, "a": 6 * D * D + 12 * K,
                 "q": 3 * D * D}[part]
    mats = 2 if part != "aq" else 4
    log = B * rounds * 2 * K if part != "aq" else 0
    return bound(B * rounds * per_round, 4 * (mats * B * D * D + log))


def bench_config():
    """bench.py's configuration of the main path."""
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig

    return NewtonConfig(tr_solver="pjacobi", jacobi_max_sweeps=4,
                        tr_kernel="pallas", refresh_kernel="pallas",
                        grad_mode="ad", hess_every=6, bisect_iters=48,
                        secular="bisect")


def fit_kernels_at(B, device="cuda"):
    """K2 and K3 at batch B (the stage-2 bucket, or 1): each against its
    twin (K2 in f64 to F64_TOL, K3 in f32 to K3_F32_TOL) and timed in f32.
    Returns {name: {B, ms, device_ms, bound_ms, bound_by}}."""
    import torch

    from celeste_jl_tpu_torch.ops import eigh, tr

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    out = {}
    H64 = wide_spectrum_batch(np.random.default_rng(0), B)
    for dtype in (torch.float64, torch.float32):
        H = torch.as_tensor(H64, dtype=dtype, device=device)
        eye = torch.eye(42, dtype=dtype, device=device).expand_as(H)
        if dtype == torch.float64:
            (A1, Q1), (A2, Q2) = (eigh.jacobi_sweep(H, eye),
                                  eigh.jacobi_sweep_plain(H, eye))
            sync()
            norm = torch.linalg.matrix_norm(H)[:, None, None]
            err = max(float(((A1 - A2).abs() / norm).max()),
                      float((Q1 - Q2).abs().max()))
            check(err < F64_TOL, f"K2 at B={B} f64: rel err {err:.3g}")
        else:
            kernel = lambda: eigh.jacobi_sweep(H, eye)
            out["jacobi_sweep"] = dict(B=B, ms=time_fn(kernel),
                                       device_ms=time_fn(kernel, spin=True),
                                       **sweep_bound(B, 42, "aq"))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    gq, w, delta = map(t, tr_cases(np.random.default_rng(7), B))
    p1, r1 = tr.tr_subproblem(gq, w, delta, 48)
    p2, r2 = tr.tr_subproblem_plain(gq, w, delta, 48)
    sync()
    check(k3_f32_ok(p1, r1, p2, r2),
          f"K3 at B={B} f32 outside rtol = atol = {K3_F32_TOL:g}")
    kernel = lambda: tr.tr_subproblem(gq, w, delta, 48)
    out["tr_subproblem"] = dict(B=B, ms=time_fn(kernel),
                                device_ms=time_fn(kernel, spin=True),
                                **tr_bound(B, 42))
    return out


def tr_bound(B, D, iters=48):
    """K3's bound: ~5 flops per coordinate per bisection; gq, w, delta in,
    p and pred out."""
    return bound(B * iters * D * 5, 4 * B * (3 * D + 2))


def phase_slice(device="cuda", n_sources=1024, tile=32, rec=None):
    """The fit at full width. Prints each stage's batch and launches (the
    unconverged lanes finish in a power-of-two bucket); with `rec` (phase
    2's records), K2 and K3 are checked and timed at that bucket too, and
    at B = 1 (`floor_ms`: their chains of dependent steps alone). Returns
    (the launches, fits/s)."""
    import torch

    from celeste_jl_tpu_torch.ops import eigh, refresh, tr
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi import optimize

    catalog, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile,
                                                   seed=1, device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    counters = {"refresh": refresh.pixel_terms,
                "jacobi_sweep": eigh.jacobi_sweep,
                "tr_subproblem": tr.tr_subproblem}
    for fn in counters.values():
        fn.launches = 0
    # each stage of fit_sources_compacted is one fit_sources call: note its
    # batch and the launches it made
    stages, fit_sources = [], optimize.fit_sources

    def staged(vp, *args, **kw):
        n0 = {k: fn.launches for k, fn in counters.items()}
        res = fit_sources(vp, *args, **kw)
        stages.append((vp.shape[0], {k: fn.launches - n0[k]
                                     for k, fn in counters.items()}))
        return res

    if device == "cuda":
        torch.cuda.synchronize()
    optimize.fit_sources = staged
    try:
        t0 = time.perf_counter()
        res = optimize.fit_sources_compacted(vp0, patches,
                                             config=bench_config())
        elbo = res.elbo.cpu().numpy()
        wall = time.perf_counter() - t0
    finally:
        optimize.fit_sources = fit_sources
    launches = {k: fn.launches for k, fn in counters.items()}

    check(res.vp.shape == (n_sources, 44), f"vp shape {tuple(res.vp.shape)}")
    check(bool(np.all(np.isfinite(elbo))),
          f"{int(np.sum(~np.isfinite(elbo)))} non-finite ELBOs")
    check(bool(np.all(np.isfinite(res.vp.cpu().numpy()))), "non-finite vp")
    if device == "cuda":
        check(all(n > 0 for n in launches.values()),
              f"a kernel of the path never launched: {launches}")
    truth = np.array([ce.is_star for ce in catalog])
    acc = float(np.mean((res.vp[:, 26].cpu().numpy() > 0.5) == truth))
    print(f"phase 3 ok: {n_sources} sources in {wall:.3f} s = "
          f"{n_sources / wall:.2f} fits/s (f32, one run, kernels included); "
          f"mean iters {float(res.iters.double().mean()):.2f}; converged "
          f"{float(res.converged.double().mean()):.4f}; star/galaxy accuracy "
          f"{acc:.4f}; launches {launches}; by stage "
          + "; ".join(f"stage {i + 1} B={b}: {n}"
                      for i, (b, n) in enumerate(stages)), flush=True)
    if rec is not None and len(stages) > 1:
        bucket = stages[1][0]
        for name, r in fit_kernels_at(bucket, device).items():
            rec[name]["stage2"] = r
            print(f"phase 3: {name} at the stage-2 bucket B={bucket}: "
                  f"{r['ms']:.4f} ms ({r['device_ms']:.4f} on the card "
                  f"alone), bound {r['bound_ms']:.3g} ms", flush=True)
        # one matrix, one lane alone: the kernel's chain of dependent steps
        # (41 rounds for K2, 48 bisections for K3) with nothing to overlap
        for name, r in fit_kernels_at(1, device).items():
            rec[name]["floor_ms"] = r["device_ms"]
            print(f"phase 3: {name} at B=1 (its dependency chain alone): "
                  f"{r['device_ms']:.4f} ms on the card", flush=True)
    return launches, n_sources / wall


def phase_compare(device="cuda", n_sources=64, tile=32):
    """The same sources fitted through the kernels and through the plain
    twins. The bar is held in f64: in f32 a lane's final ELBO carries
    rounding noise of ~1e-4 relative on 32x32 tiles, so either f32 route
    lands within that noise of the other and near-tie star/galaxy lanes
    may swap; the f32 comparison is printed beside it. Returns the f64
    kernel-route fit (phase 17c's autograd side)."""
    import torch

    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources_compacted

    _, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile, seed=1,
                                             dtype=np.float64, device=device)
    cfg = bench_config()
    for dtype in (torch.float64, torch.float32):
        vp0 = torch.as_tensor(vp0s, dtype=dtype, device=device)
        p = patches.to(device, dtype)
        rk = fit_sources_compacted(vp0, p, config=cfg)
        rp = fit_sources_compacted(vp0, p, config=cfg, plain=True)
        if dtype == torch.float64:
            f64 = rk
        flips = int(np.sum((rk.vp[:, 26].cpu().numpy() > 0.5)
                           != (rp.vp[:, 26].cpu().numpy() > 0.5)))
        ek = rk.elbo.double().cpu().numpy()
        ep = rp.elbo.double().cpu().numpy()
        rel = (ek - ep) / np.abs(ep)
        msg = (f"{n_sources} sources {str(dtype)[6:]}: {flips} "
               f"classification flips; ELBO rel worst {rel.min():.3g}, best "
               f"{rel.max():.3g}, mean {rel.mean():.3g} (kernels vs plain); "
               f"mean iters {float(rk.iters.double().mean()):.2f} vs "
               f"{float(rp.iters.double().mean()):.2f}")
        if dtype == torch.float64:
            msg += f"; bar: 0 flips, worst > -{SLICE_ELBO_TOL:g}"
            check(flips == 0 and bool(np.all(rel > -SLICE_ELBO_TOL)),
                  "phase 4: " + msg)
        print("phase 4: " + msg, flush=True)
    print("phase 4 ok", flush=True)
    return f64


def _phase_clock(n, t0):
    print(f"phase {n} wall {time.perf_counter() - t0:.1f} s", flush=True)


def mcmc_scene(device, n_sources=64):
    """bench_mcmc.py's scene, rendered on `device`."""
    from celeste_jl_tpu_torch.synthetic import ais_bench_scene

    return ais_bench_scene(n_sources, device=device)


def k4_inputs(scene, device, dtype, n_samples=10, m=1, P=None, seed=5):
    """K4's inputs as the AIS's evaluator makes them: n_samples prior draws
    per source of each model, in m stacked copies (m = 2: the step-out
    scores both ends of every lane at once). P None: the AIS's own patches,
    as run_ais_batched makes them (patch_radii at bench_mcmc.py's least
    radius of 8 px, the neighbours' background, every source on the
    largest source's tile); P given: every source at radius 8 on P x P
    tiles, no neighbour. Returns the LaneBlocks of the star and galaxy
    blocks and their lanes' parameters."""
    import torch

    from celeste_jl_tpu_torch.mcmc import infer, log_prob
    from celeste_jl_tpu_torch.parallel.common import _tile_for_radius
    from celeste_jl_tpu_torch.parallel.state import find_neighbors, patch_radii
    from celeste_jl_tpu_torch.utils.config import Config
    from celeste_jl_tpu_torch.vi.elbo import default_prior

    images, catalog = scene
    S = len(catalog)
    if P is None:
        radii = patch_radii(catalog, images, Config(min_radius_pix=8.0))
        neighbors = find_neighbors(catalog, radii, images)
        P = max(_tile_for_radius(r) for r in radii)
    else:
        radii, neighbors = [8.0] * S, {}
    tgt, _ = infer.chunk_target(catalog, images, list(range(S)), neighbors,
                                radii, P, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    prior = default_prior(torch.device(device), dtype)
    L = m * S * n_samples
    ths = [log_prob.sample_star_prior(gen, L, prior),
           log_prob.sample_gal_prior(gen, L, prior)]
    src = torch.arange(S, device=device).repeat_interleave(n_samples)
    return (log_prob.lane_blocks(tgt, [(True, src.repeat(m)),
                                       (False, src.repeat(m))]), ths)


def k4_launch(lb, ths, blocks):
    """mixture_poisson_ll_ragged's arguments (tiles, plan, comps, meta)
    scoring the blocks `blocks` (indices into lb) in one launch."""
    import torch

    from celeste_jl_tpu_torch.mcmc import log_prob
    from celeste_jl_tpu_torch.ops import render

    rows = [log_prob.row_inputs(lb.lanes[k], ths[k], lb.is_star[k])
            for k in blocks]
    tiles = lb.lanes[0].tiles.k4
    plan = (lb.plan if tuple(blocks) == tuple(range(len(lb.lanes))) else
            render.row_plan(
                tiles, torch.cat([lb.lanes[k].tile_index for k in blocks]),
                tuple((m.shape[0], c.shape[1]) for c, m in rows)))
    return (tiles, plan, torch.cat([c.reshape(-1, 6) for c, _ in rows]),
            torch.cat([m for _, m in rows]))


def k4_active(args):
    """Active pixels of each row of K4's launch `args`, (R,) float64."""
    tiles, plan, _, _ = args
    n_act = (tiles.ptr[1:] - tiles.ptr[:-1]).double()
    return n_act[plan.tile_index.long()]


def k4_work(args):
    """Active pixels x components summed over the rows of K4's launch
    `args`: the accurate exps it evaluates."""
    plan = args[1]
    C = (plan.comp_ptr[1:] - plan.comp_ptr[:-1]).double()
    return float((C * k4_active(args)).sum())


def k4_bound(args):
    """K4's bound: ~12 flops per component per active pixel of each row
    (the exps and logs not counted), ~8 per active pixel for the score;
    the tiles' active-pixel lists, comps, meta, the plan's indices and the
    output moved once each. Also its exp floor: the accurate exps alone at
    the SFUs' rate (16 a clock per SM, 132 SMs, the 1.98 GHz boost
    clock)."""
    tiles, plan, comps, meta = args
    act = float(k4_active(args).sum())
    R = meta.shape[0]
    nbytes = (comps.element_size() * (3 * tiles.x.numel() + comps.numel()
                                      + meta.numel() + R)
              + 4 * (tiles.pos.numel() + tiles.ptr.numel()
                     + plan.comp_ptr.numel() + R + plan.work.numel()))
    rec = bound(12 * k4_work(args) + 8 * act, nbytes)
    rec["exp_floor_ms"] = k4_work(args) / SFU_EXP_PER_S * 1e3
    return rec


def kernel_report(dtype):
    """The redesigned kernels' compiled shape on this card: registers,
    local memory (spills), shared memory and blocks per SM."""
    from celeste_jl_tpu_torch.ops import _build, render

    lines = []
    for name, what, arg in (("refresh", "C", 30),
                            ("mixture_poisson_ll", "warps", render.K4_WARPS),
                            ("jacobi_sweep", "D", 42),
                            ("tr_subproblem", "D", 42),
                            ("jacobi_sweep_a", "D", 42),
                            ("jacobi_replay_q", "D", 42)):
        a = _build.kernel_attrs(name, dtype, arg)
        lines.append(f"{name} {str(dtype)[6:]} ({what} = {arg}): "
                     f"{a['registers']} registers, {a['local_bytes']} B "
                     f"local, {a['shared_bytes']} B shared, "
                     f"{a['blocks_per_sm']} blocks per SM")
    return lines


# the compiled instances phase 5 prints nvcc's report for (mangled-name
# fragments): K1, K4, K2 (sweep_kernel with Q, without the log), K2a
# (without Q, with the log) and K2b at D = 42, and K3's instance for D in
# [33, 64]
PTXAS_KERNELS = ("refresh_kernel", "render_ll_kernel",
                 "sweep_kernelIfLi42ELb1ELb0E", "sweep_kernelIdLi42ELb1ELb0E",
                 "sweep_kernelIfLi42ELb0ELb1E", "sweep_kernelIdLi42ELb0ELb1E",
                 "replay_q_kernelIfLi42E", "replay_q_kernelIdLi42E",
                 "tr_kernelIfLi2E", "tr_kernelIdLi2E")


def split_kernels_at(B, device="cuda"):
    """K2a and K2b at batch B in f32: K2a + K2b bit-identical to K2, and
    each timed. Returns {name: {B, ms, device_ms, bound_ms, bound_by}}."""
    import torch

    from celeste_jl_tpu_torch.ops import eigh

    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    H = torch.as_tensor(wide_spectrum_batch(np.random.default_rng(0), B),
                        dtype=torch.float32, device=device)
    eye = torch.eye(42, dtype=H.dtype, device=device).expand_as(H)
    A1, cs = eigh.jacobi_sweep_a(H)
    Q1 = eigh.jacobi_replay_q(eye, cs)
    A2, Q2 = eigh.jacobi_sweep(H, eye)
    check(torch.equal(A1, A2) and torch.equal(Q1, Q2),
          f"K2a+K2b at B={B} f32: not K2's bits")
    out = {}
    for name, fn, part in (("jacobi_sweep_a", lambda: eigh.jacobi_sweep_a(H),
                            "a"),
                           ("jacobi_replay_q",
                            lambda: eigh.jacobi_replay_q(eye, cs), "q")):
        out[name] = dict(B=B, ms=time_fn(fn), device_ms=time_fn(fn, spin=True),
                         **sweep_bound(B, 42, part))
    return out


def phase_new_kernels(scene, device="cuda", tiles=(32, 16, 64),
                      n_samples=10, n_mats=1024, fit_batch=256):
    """K4 against its twin: on radius-8 patches at each tile size of
    `tiles`, one model at a time (through the single-model entry) and
    both in one launch; on the AIS's own patches, both models in one
    launch as the evaluator makes it (m = 1, the kernel's record) and
    for the step-out (m = 2). Then the split sweep K2a+K2b against its
    twin and, bit for bit, against K2 on n_mats matrices, and at
    fit_batch (phase 8's) and 1. Returns {name: record}."""
    import torch

    from celeste_jl_tpu_torch.mcmc import log_prob
    from celeste_jl_tpu_torch.ops import _build, eigh, render

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    rec = {}
    if device == "cuda":
        for dtype in (torch.float32, torch.float64):
            for line in kernel_report(dtype):
                print(f"phase 5: {line}", flush=True)
        for kernel in PTXAS_KERNELS:
            for line in _build.ptxas_lines(kernel):
                print(f"phase 5: ptxas {line}", flush=True)
    models = (("star", (0,)), ("galaxy", (1,)), ("both", (0, 1)))
    # (P, m): radius-8 patches on P x P tiles, then the AIS's own patches
    # as its evaluator scores them once and in the step-out's two copies
    cases = [(P, 1) for P in tiles] + [(None, 1), (None, 2)]
    for dtype, tol in ((torch.float64, K4_F64_TOL),
                       (torch.float32, K4_F32_TOL)):
        for P, m in cases:
            lb, ths = k4_inputs(scene, device, dtype, n_samples, m, P)
            for label, blocks in models if P else models[2:]:
                args = k4_launch(lb, ths, blocks)
                if label == "both":
                    got = render.mixture_poisson_ll_ragged(*args)
                else:   # the single-model entry
                    k = blocks[0]
                    got = render.mixture_poisson_ll(*log_prob.fused_rows(
                        lb.lanes[k], ths[k], lb.is_star[k]))
                want = render.mixture_poisson_ll_ragged_plain(*args)
                sync()
                d = (got - want).double().abs()
                err = float((d / want.double().abs().clamp(min=1e-30)).max())
                tl, plan, comps, _ = args
                where = (f"radius 8, P={P}" if P else
                         f"AIS patches m={m}, P={tl.pixels.shape[-1]}, "
                         f"{float(k4_active(args).mean()):.1f} active pixels a row")
                msg = (f"K4 mixture_poisson_ll {label} {str(dtype)[6:]} R="
                       f"{plan.order.numel()} C="
                       f"{'/'.join(str(C) for _, C in plan.segments)} "
                       f"({where}): max rel err per row {err:.3g} (tol "
                       f"{tol:g})")
                check(bool(torch.all(torch.isfinite(got))) and err < tol, msg)
                if dtype == torch.float32:
                    # which f32 route carries the difference: each against
                    # the twin in f64 on the same (f32) inputs
                    tl64 = tl._replace(**{f: getattr(tl, f).double() for f in
                                          ("pixels", "mask", "iota", "bg")})
                    w64 = render.mixture_poisson_ll_ragged_plain(
                        tl64, plan, comps.double(), args[3].double())
                    e64 = lambda r: float(((r.double() - w64).abs()
                                           / w64.abs().clamp(min=1e-30)).max())
                    msg += (f"; vs f64: kernel {e64(got):.3g}, twin "
                            f"{e64(want):.3g}")
                if dtype == torch.float32 and (
                        P is None or (P == tiles[0] and label != "star")):
                    # the kernel alone: tiles and row plan made beforehand,
                    # as the AIS makes them once per set of lanes
                    kernel = lambda: render.mixture_poisson_ll_ragged(*args)
                    ms, device_ms = time_fn(kernel), time_fn(kernel, spin=True)
                    b = k4_bound(args)
                    msg += (f"; kernel {ms:.4f} ms ({device_ms:.4f} on the "
                            f"card alone; {plan.work.shape[0]} blocks of at "
                            f"most {plan.warps} warps); bound "
                            f"{b['bound_ms']:.5f} ms, exp floor "
                            f"{b['exp_floor_ms']:.5f} ms")
                    if P is None and m == 1:
                        plain_ms = time_fn(
                            lambda: render.mixture_poisson_ll_ragged_plain(
                                *args))
                        b.pop("exp_floor_ms")
                        rec["mixture_poisson_ll"] = dict(
                            max_abs_err=float(d.max()), ms=ms,
                            device_ms=device_ms, plain_ms=plain_ms,
                            library_ms=None, **b)
                        msg += f", plain {plain_ms:.3f} ms"
                print(msg, flush=True)

    rng = np.random.default_rng(0)
    H64 = wide_spectrum_batch(rng, n_mats)
    w_ref = np.linalg.eigvalsh(H64)
    for dtype in (torch.float64, torch.float32):
        H = torch.as_tensor(H64, dtype=dtype, device=device)
        eye = torch.eye(42, dtype=dtype, device=device).expand_as(H)
        A1, cs = eigh.jacobi_sweep_a(H)
        Q1 = eigh.jacobi_replay_q(eye, cs)
        A2, cs2 = eigh.jacobi_sweep_a_plain(H)
        Q2 = eigh.jacobi_replay_q_plain(eye, cs2)
        A3, Q3 = eigh.jacobi_sweep(H, eye)
        sync()
        norm = torch.linalg.matrix_norm(H.double())[:, None, None]
        e_plain = max(float(((A1 - A2).double().abs() / norm).max()),
                      float((Q1 - Q2).double().abs().max()))
        # K2a and K2b do K2's arithmetic in K2's order (csrc/jacobi_sweep.cuh,
        # jacobi_round.cuh): its bits, in either type
        same = torch.equal(A1, A3) and torch.equal(Q1, Q3)
        w, Q, sweeps = eigh.jacobi_eigh(H, tol=1e-6, max_sweeps=10,
                                        sweep=eigh.jacobi_sweep_split)
        w = w.double().cpu().numpy()
        Qn = Q.double().cpu().numpy()
        dw = np.max(np.abs(np.sort(w, -1) - w_ref))
        orth = np.max(np.abs(np.einsum("bji,bjk->bik", Qn, Qn) - np.eye(42)))
        resid = (np.max(np.abs(np.einsum("bij,bjk->bik", H64, Qn)
                               - w[:, None, :] * Qn))
                 / np.linalg.norm(H64[0]))
        # f32 sweeps amplify rounding (phase 2): against the twin, held
        # through the eigensolver's bars only
        tol = SPLIT_F64_TOL if dtype == torch.float64 else float("inf")
        msg = (f"K2a+K2b split sweep {str(dtype)[6:]} B={n_mats} D=42: "
               f"vs plain twin {e_plain:.3g} (tol {tol:g}); bit-identical "
               f"to K2 {same}; jacobi_eigh |dw| {dw:.3g} orth {orth:.3g} "
               f"resid {resid:.3g} ({sweeps} sweeps)")
        check(same and e_plain < tol and dw < EIGH_BARS["dw"]
              and orth < EIGH_BARS["orth"] and resid < EIGH_BARS["resid"],
              msg)
        if dtype == torch.float32:
            for name, fn, pfn, part, abs_err in (
                    ("jacobi_sweep_a", lambda: eigh.jacobi_sweep_a(H),
                     lambda: eigh.jacobi_sweep_a_plain(H), "a",
                     max(float((A1 - A2).abs().max()),
                         float((cs - cs2).abs().max()))),
                    ("jacobi_replay_q", lambda: eigh.jacobi_replay_q(eye, cs),
                     lambda: eigh.jacobi_replay_q_plain(eye, cs), "q",
                     float((Q1 - eigh.jacobi_replay_q_plain(eye, cs))
                           .abs().max()))):
                ms, device_ms = time_fn(fn), time_fn(fn, spin=True)
                plain_ms = time_fn(pfn)
                rec[name] = dict(max_abs_err=abs_err, ms=ms,
                                 device_ms=device_ms, plain_ms=plain_ms,
                                 library_ms=None,
                                 **sweep_bound(n_mats, 42, part))
                msg += (f"; {name} {ms:.4f} ms ({device_ms:.4f} on the card "
                        f"alone), plain {plain_ms:.3f} ms")
        print(msg, flush=True)
    # at the batch of phase 8's split fit (`split_fit`), and one matrix
    # alone (`floor_ms`: K2a's chain of 41 rounds, K2b's 41 dependent
    # rotation steps, with nothing to overlap)
    for B in (fit_batch, 1):
        for name, r in split_kernels_at(B, device).items():
            if B == 1:
                rec[name]["floor_ms"] = r["device_ms"]
            else:
                rec[name]["split_fit"] = r
            print(f"phase 5: {name} at B={B}: {r['ms']:.4f} ms "
                  f"({r['device_ms']:.4f} on the card alone), bound "
                  f"{r['bound_ms']:.3g} ms", flush=True)
    print("phase 5 ok: K4, K2a, K2b agree with their plain twins", flush=True)
    return rec


def _coverage(results, catalog):
    """Fraction of sources whose true r-flux and colors lie within 2
    posterior standard deviations of the winning model's chain mean
    (benchmark/bench_mcmc.py's calibration, in numpy)."""
    fields = ("log_flux_r", "color_ug", "color_gr", "color_ri", "color_iz")
    hits = {f: [] for f in fields}
    for r, ce in zip(results, catalog):
        chain = r["star_samples" if r["ave_pstar"] > 0.5 else "gal_samples"]
        lnf = chain[:, :5]
        est = np.column_stack([lnf[:, 2], lnf[:, 1] - lnf[:, 0],
                               lnf[:, 2] - lnf[:, 1], lnf[:, 3] - lnf[:, 2],
                               lnf[:, 4] - lnf[:, 3]])
        tf = np.log(np.asarray(ce.star_fluxes if ce.is_star
                               else ce.gal_fluxes))
        truth = np.array([tf[2], tf[1] - tf[0], tf[2] - tf[1],
                          tf[3] - tf[2], tf[4] - tf[3]])
        mu, sd = est.mean(0), est.std(0, ddof=1)
        for k, f in enumerate(fields):
            if sd[k] > 0:
                hits[f].append(abs(mu[k] - truth[k]) / sd[k])
    return {f: float(np.mean(np.asarray(h) < 2.0)) if h else float("nan")
            for f, h in hits.items()}


def phase_mcmc(scene, device="cuda", ais=FULL_AIS, bars=True):
    """The MCMC slice at full width through its entry point, f32."""
    import torch

    from celeste_jl_tpu_torch.mcmc.infer import run_ais_batched
    from celeste_jl_tpu_torch.mcmc.slice import slicesample
    from celeste_jl_tpu_torch.ops import render
    from celeste_jl_tpu_torch.utils.config import Config

    images, catalog = scene
    S = len(catalog)
    render.mixture_poisson_ll.launches = 0
    slicesample.host_reads = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_ais_batched(catalog, images, config=Config(min_radius_pix=8.0),
                          seed=0, device=device, dtype=torch.float32, **ais)
    wall = time.perf_counter() - t0
    launches = {"mixture_poisson_ll": render.mixture_poisson_ll.launches}
    reads = slicesample.host_reads

    for k in ("star_lnZ", "gal_lnZ", "star_lnZ_bootstrap",
              "gal_lnZ_bootstrap", "star_samples", "gal_samples",
              "star_lls", "gal_lls", "ave_pstar"):
        bad = [i for i, r in enumerate(res)
               if not np.all(np.isfinite(r[k]))]
        check(not bad, f"phase 6: non-finite {k} on sources {bad}")
    n = ais["num_samples"]
    T = ais["num_samples_per_chain"]
    check(all(r["star_samples"].shape == (n * T, 7)
              and r["gal_samples"].shape == (n * T, 11) for r in res),
          "phase 6: chain shapes")
    if device == "cuda":
        check(launches["mixture_poisson_ll"] > 0, "phase 6: K4 never ran")
    pstar = np.array([r["ave_pstar"] for r in res])
    truth = np.array([ce.is_star for ce in catalog])
    recall = float(np.mean(pstar[~truth] < 0.5))
    star_side = float(np.mean(pstar[truth] > 0.5))
    cov = _coverage(res, catalog)
    sweeps = ais["num_temperatures"] - 1 + T
    msg = (f"phase 6: {S} sources, AIS {ais['num_temperatures']} temps x "
           f"{n} samples + {T}-step chains, f32: {wall:.3f} s = "
           f"{S / wall:.4f} sources/s; K4 launches "
           f"{launches['mixture_poisson_ll']} "
           f"({launches['mixture_poisson_ll'] / sweeps:.1f} per sweep); "
           f"host reads {reads} "
           f"({reads / sweeps:.1f} per sweep, {reads / (11 * sweeps):.2f} "
           f"per coordinate step); galaxy recall {recall:.4f}; stars with "
           f"p(star) > 0.5 {star_side:.4f}; 2-sd coverage "
           + ", ".join(f"{f} {c:.3f}" for f, c in cov.items()))
    if bars:
        check(recall == 1.0 and all(c >= COVERAGE_BAR for c in cov.values()),
              msg + f" (bars: recall 1.0, coverage >= {COVERAGE_BAR})")
    print(msg, flush=True)
    print("phase 6 ok", flush=True)
    return launches


def _split_step(hists, outs, s, lanes):
    """Where the two routes' chains of source s (its AIS `lanes`) first
    differ: the AIS step, or the step of the posterior chain after it."""
    import torch

    for k, (a, b) in enumerate(zip(*hists)):
        if not torch.equal(a[lanes], b[lanes]):
            return f"AIS step {k + 1}"
    for t in range(outs[0]["star_samples"].shape[2]):
        if any(not torch.equal(outs[0][f][s, :, t], outs[1][f][s, :, t])
               for f in ("star_samples", "gal_samples")):
            return f"posterior chain step {t + 1}"
    return "no step (the chains agree; only the lnZ sums differ)"


def phase_mcmc_routes(scene, device="cuda", n_sources=8, ais=ROUTE_AIS):
    """K4 against its twin on the AIS program, f64, same seed."""
    import torch

    from celeste_jl_tpu_torch.mcmc import infer
    from celeste_jl_tpu_torch.parallel.common import _tile_for_radius
    from celeste_jl_tpu_torch.parallel.state import find_neighbors, patch_radii
    from celeste_jl_tpu_torch.utils.config import Config

    images, catalog = scene
    targets = list(range(n_sources))
    radii = patch_radii(catalog, images, Config(min_radius_pix=8.0))
    tgt, _ = infer.chunk_target(
        catalog, images, targets, find_neighbors(catalog, radii, images),
        radii, max(_tile_for_radius(radii[s]) for s in targets),
        device=device, dtype=torch.float64)
    outs, hists = [], []
    for plain in (False, True):
        gen = torch.Generator(device=device).manual_seed(0)
        hists.append([])
        outs.append(infer._ais_both_models(gen, tgt, plain=plain,
                                           history=hists[-1], **ais))
    k, p = outs
    rel = lambda key: ((k[key] - p[key]).abs() / p[key].abs()).cpu().numpy()
    r_star, r_gal = rel("star_lnZ"), rel("gal_lnZ")
    same_side = ((k["ave_pstar"] > 0.5) == (p["ave_pstar"] > 0.5)).cpu()
    close = (r_star <= 1e-6) & (r_gal <= 1e-6)
    S, n = n_sources, ais["num_samples"]
    for s in range(S):
        if not (close[s] and same_side[s]):
            lanes = torch.cat([torch.arange(s * n, s * n + n),
                               torch.arange(S * n + s * n, S * n + s * n + n)])
            print(f"phase 7: source {s} departs (lnZ rel star {r_star[s]:.3g}"
                  f" gal {r_gal[s]:.3g}); chains split at "
                  f"{_split_step(hists, outs, s, lanes.to(device))}",
                  flush=True)
    msg = (f"phase 7: {S} sources f64, kernel vs twin: same side on "
           f"{int(same_side.sum())}/{S}, lnZ within 1e-6 on "
           f"{int(close.sum())}/{S}; max rel star {r_star.max():.3g}, gal "
           f"{r_gal.max():.3g}")
    check(bool(same_side.all()) and int(close.sum()) >= S - 1,
          msg + f" (bars: all sides, >= {S - 1} within 1e-6)")
    print(msg, flush=True)
    print("phase 7 ok", flush=True)


def phase_split_fit(device="cuda", n_sources=256, tile=32):
    """The fit with the split sweep (K2a + K2b) against the fused one."""
    import torch

    from celeste_jl_tpu_torch.ops import eigh
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources_compacted

    _, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile, seed=1,
                                             dtype=np.float64, device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    p = patches.to(device, torch.float64)
    cfg = bench_config()
    rf = fit_sources_compacted(vp0, p, config=cfg)
    counters = {"jacobi_sweep_a": eigh.jacobi_sweep_a,
                "jacobi_replay_q": eigh.jacobi_replay_q}
    for fn in counters.values():
        fn.launches = 0
    rs = fit_sources_compacted(vp0, p, config=cfg._replace(eigh_fused=False))
    es = rs.elbo.cpu().numpy()
    launches = {k: fn.launches for k, fn in counters.items()}
    flips = int(np.sum((rs.vp[:, 26].cpu().numpy() > 0.5)
                       != (rf.vp[:, 26].cpu().numpy() > 0.5)))
    same_iters = bool(torch.equal(rs.iters, rf.iters))
    ef = rf.elbo.cpu().numpy()
    rel = float(np.max(np.abs(es - ef) / np.abs(ef)))
    msg = (f"phase 8: {n_sources} sources f64, split vs fused sweep: "
           f"{flips} flips, identical iterations {same_iters}, ELBO max rel "
           f"diff {rel:.3g}; launches {launches}")
    check(flips == 0 and same_iters and rel <= SPLIT_ELBO_TOL
          and np.all(np.isfinite(es)),
          msg + f" (bars: 0 flips, same iterations, <= {SPLIT_ELBO_TOL:g})")
    if device == "cuda":
        check(all(v > 0 for v in launches.values()),
              f"phase 8: a split kernel never launched: {launches}")
    print(msg, flush=True)
    print("phase 8 ok", flush=True)
    return launches


def field_scene(n_sources, size, seed, device):
    """benchmark/run_field.py's field, drawn on `device` (the port's
    multi-field runner draws the same: benchmark.multifield.make_field).
    Returns (images, truth)."""
    from celeste_jl_tpu_torch.benchmark.multifield import make_field

    return make_field(seed, n_sources, size, device)


def field_score(results, truth):
    """benchmark/run_field.py's score() (benchmark.multifield.score):
    (matched, type accuracy, r-flux relative errors)."""
    from celeste_jl_tpu_torch.benchmark.multifield import score

    return score(results, truth)


class KernelWidths:
    """Counts, while open, each field-path kernel's launches by width (K1:
    rows, K2 and K3: lanes), read at `_build.launch`; the wrappers' own
    launch counters are reset on entry."""

    _WIDTH_ARG = {"refresh": -5, "jacobi_sweep": -2, "tr_subproblem": -3}

    def __enter__(self):
        import collections

        from celeste_jl_tpu_torch.ops import _build, eigh, refresh, tr

        self.fns = {"refresh": refresh.pixel_terms,
                    "jacobi_sweep": eigh.jacobi_sweep,
                    "tr_subproblem": tr.tr_subproblem}
        for fn in self.fns.values():
            fn.launches = 0
        self.widths = {k: collections.Counter() for k in self.fns}
        self._build, self._launch = _build, _build.launch

        def launch(name, dtype, *args):
            if name in self.widths:
                self.widths[name][int(args[self._WIDTH_ARG[name]])] += 1
            return self._launch(name, dtype, *args)

        _build.launch = launch
        return self

    def __exit__(self, *exc):
        self._build.launch = self._launch

    def launches(self):
        return {k: fn.launches for k, fn in self.fns.items()}

    def summary(self):
        return "; ".join(
            f"{k} {fn.launches} launches, widths "
            + ", ".join(f"{w}x{n}" for w, n in sorted(self.widths[k].items()))
            for k, fn in self.fns.items())


def field_run(images, truth, method, device, dtype, label, bars,
              **kw):
    """One infer_box-path run on the field, scored and checked; prints its
    lines. kw: infer_box's (joint_vi) or one_node_single_infer's
    arguments. Returns (results, launches, fit-launch widths, the
    detection's (catalog, boxes) or None)."""
    import torch

    from celeste_jl_tpu_torch.parallel import run
    from celeste_jl_tpu_torch.utils import telemetry

    detect = {}
    detect_sources = run.detect_sources

    def timed_detect(*a, **k):
        t = time.perf_counter()
        out = detect_sources(*a, **k)
        detect["s"] = time.perf_counter() - t
        detect["out"] = out
        return out

    if device == "cuda":
        torch.cuda.synchronize()
    run.detect_sources = timed_detect
    try:
        with KernelWidths() as kw_rec:
            t0 = time.perf_counter()
            if method == "joint_vi":
                res = run.infer_box(images, method=method, device=device,
                                    dtype=dtype, **kw)
            else:
                res = run.one_node_single_infer(
                    kw.pop("catalog"), images, device=device, dtype=dtype,
                    **kw)
            wall = time.perf_counter() - t0
    finally:
        run.detect_sources = detect_sources
    c = telemetry.counters
    t_det = detect.get("s", 0.0)
    t_inf = wall - t_det
    n_match, acc, errs = field_score(res, truth)
    elbos = np.array([r.elbo for r in res])
    completeness = n_match / len(truth)
    med = float(np.median(errs)) if errs else float("nan")
    launches = kw_rec.launches()
    fit_widths = dict(sorted(c.lane_widths.items()))
    print(f"{label} {method}: detect {t_det:.3f} s, infer {t_inf:.3f} s, "
          f"{len(res) / t_inf:.3f} sources/s (infer); detected {len(res)}, "
          f"matched {n_match}, completeness {completeness:.4f}; type "
          f"accuracy {acc:.4f}; median r-flux rel err {med:.4f}; "
          f"{c.launches} fit launches by lane width {fit_widths}, lane "
          f"fill {c.lane_fill():.4f}; failures {c.failures}", flush=True)
    print(f"{label} {method} kernels: {kw_rec.summary()}", flush=True)
    if bars:
        msg = (f"{label} {method}: finite ELBOs "
               f"{bool(np.all(np.isfinite(elbos)))}, failures {c.failures}, "
               f"launches {launches}, native detection "
               f"{_native_available()}, completeness {completeness:.4f} "
               f"(bar {FIELD_COMPLETENESS_BAR}), type accuracy {acc:.4f}")
        ok = (np.all(np.isfinite(elbos)) and c.failures == 0
              and _native_available()
              and completeness >= FIELD_COMPLETENESS_BAR)
        if method == "joint_vi":
            msg += f" (bar {FIELD_TYPE_BAR})"
            ok = ok and acc >= FIELD_TYPE_BAR
        if device == "cuda":
            ok = ok and all(n > 0 for n in launches.values())
        check(bool(ok), msg)
    return res, launches, fit_widths, detect.get("out")


def _native_available():
    from celeste_jl_tpu_torch.detection import _native

    return _native.available()


def phase_field(device="cuda", n_sources=128, size=512, seed=7, rec=None,
                config=None, single_newton=None, bars=True):
    """benchmark/run_field.py's field at its density of record (its record,
    512 sources on 1024 x 1024 px, cut to 128 on 512 x 512 to keep the
    whole script's phase walls near 750 s with phases 15 and 16) through the
    port's infer_box (detection, then joint_vi's schedule, fused by default),
    f32, scored as run_field.py scores it; then single_vi on the same
    images, detected catalog and footprints. With `rec`, K1-K3 are timed
    at the joint run's median fit-launch width. single_newton: the
    single_vi run's NewtonConfig (default SINGLE_RERUN_REFRESHES refreshes
    a lane); config (default Config()) and single_newton shorten the
    schedule for a CPU rehearsal, bars=False skips the quality bars
    there. Returns the joint run's launches."""
    import torch

    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel.state import detection_active_boxes
    from celeste_jl_tpu_torch.utils.config import Config

    check(_native_available(), "phase 9: the native detection library did "
          "not build")
    t0 = time.perf_counter()
    images, truth = field_scene(n_sources, size, seed, device)
    print(f"phase 9: field {n_sources} sources, {size}x{size} px, seed "
          f"{seed}, drawn in {time.perf_counter() - t0:.3f} s", flush=True)
    detect = dict(thresh=6.0, boxsize=(size, size), match_radius_deg=1.0)
    _, launches, widths, (catalog, det_boxes) = field_run(
        images, truth, "joint_vi", device, torch.float32, "phase 9", bars,
        config=config or Config(), **detect)
    field_run(images, truth, "single_vi", device, torch.float32, "phase 9",
              bars, catalog=catalog,
              active_boxes=detection_active_boxes(catalog, det_boxes, images),
              newton_config=single_newton or NewtonConfig(
                  max_iters=SINGLE_RERUN_REFRESHES))
    if rec is not None and widths:
        W = int(np.median(np.repeat(list(widths), list(widths.values()))))
        for name, r in fit_kernels_at(W, device).items():
            rec[name]["field"] = r
        rec["refresh"]["field"] = refresh_kernel_at(W, 32, device)
        for name in FIELD_KERNELS:
            r = rec[name]["field"]
            print(f"phase 9: {name} at the median fit-launch width W={W}: "
                  f"{r['ms']:.4f} ms ({r['device_ms']:.4f} on the card "
                  f"alone), bound {r['bound_ms']:.3g} ms", flush=True)
    print("phase 9 ok", flush=True)
    return launches


def refresh_kernel_at(n_sources, tile, device="cuda", dtype=None):
    """K1 at n_sources lanes (5 rows each) on tile x tile, timed (f32
    unless dtype says otherwise)."""
    import torch

    from celeste_jl_tpu_torch.ops import refresh

    dtype = dtype or torch.float32
    rows, ks, pdims = refresh_rows(n_sources, tile, device, dtype)
    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    kernel = lambda: refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
    G, C = rows[2].shape
    N = rows[6].shape[-1]
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (G * C * 42 + G * 6 + 5 * G * N + G * C * 15 + G * 72)
    return dict(B=G, dtype=str(dtype)[6:], ms=time_fn(kernel),
                device_ms=time_fn(kernel, spin=True),
                **bound(float(rows[7].sum()) * (60 * C + 400), nbytes,
                        f64=dtype == torch.float64))


def _field_route(plain, device, n_sources, size, seed, config):
    """One side of phase 10, in a process of its own: infer_box(joint_vi)
    on the field through the kernels, or through their twins (plain),
    f64. Returns (results, kernel launches, their summary, seconds)."""
    import torch

    from celeste_jl_tpu_torch.parallel.run import infer_box
    from celeste_jl_tpu_torch.utils.config import Config

    # one intra-op thread: the route processes share the host's cores
    torch.set_num_threads(1)
    images, _ = field_scene(n_sources, size, seed, device)
    t0 = time.perf_counter()
    with KernelWidths() as rec:
        res = infer_box(images, method="joint_vi", config=config or Config(),
                        device=device, dtype=torch.float64, plain=plain,
                        thresh=6.0, boxsize=(size, size),
                        match_radius_deg=1.0)
    return res, rec.launches(), rec.summary(), time.perf_counter() - t0


def _submit_field_routes(pool, device="cuda", n_sources=16, size=181,
                         seed=7, config=None):
    """Phase 10's two runs, submitted to `pool`."""
    return [pool.submit(_field_route, plain, device, n_sources, size, seed,
                        config) for plain in (False, True)]


def _check_field_routes(pending, device):
    """Phase 10's bar on its two runs (see phase_field_routes)."""
    (rk, launches, summary, tk), (rp, _, _, tp) = (p.result()
                                                   for p in pending)
    check(len(rk) > 0, "phase 10: no source detected")
    flips, rel = _route_diff("phase 10", rk, rp)
    msg = (f"phase 10: {len(rk)} sources f64, kernels vs plain twins: "
           f"{flips} classification flips; ELBO rel worst {rel.min():.3g}, "
           f"best {rel.max():.3g}; kernels {tk:.3f} s, plain {tp:.3f} s; "
           f"{summary}; bar: 0 flips, worst > -{SLICE_ELBO_TOL:g}")
    check(flips == 0 and bool(np.all(rel > -SLICE_ELBO_TOL)), msg)
    if device == "cuda":
        check(all(n > 0 for n in launches.values()),
              f"phase 10: a field kernel never launched: {launches}")
    print(msg, flush=True)
    print("phase 10 ok", flush=True)


def _blocking_sync():
    """A route process's start: its waits on the card block
    (CU_CTX_SCHED_BLOCKING_SYNC on the device's primary context, set
    before torch makes it) instead of spinning, the CUDA default for a
    process of one context. The pool runs more processes than the host
    has cores, and a process spinning on the time-sliced card takes a
    core from one with host work. Nothing happens where libcuda.so.1
    does not load (the CPU rehearsal)."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return
    dev = ctypes.c_int()
    if cuda.cuInit(0) == 0 and cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0:
        set_flags = getattr(cuda, "cuDevicePrimaryCtxSetFlags_v2",
                            cuda.cuDevicePrimaryCtxSetFlags)
        set_flags(dev, 4)


# each route process's start (pool_sync_ab sets it to None for a run)
POOL_INITIALIZER = _blocking_sync


def _route_pool(n):
    """A pool of n spawned processes, each started by POOL_INITIALIZER
    (a worker that dies fails the phase; all are stopped when the pool
    closes)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn"),
        initializer=POOL_INITIALIZER)


def pool_sync_ab(device="cuda"):
    """The route pool of main run twice after phases 1 and 11, its
    processes spinning on the card's synchronizations (no initializer),
    then blocking (_blocking_sync, as main runs them); prints each wall.
    The app's twin process (phase 12 starts it from a route process)
    blocks in both. On the card:
    python3 -c 'import chip_smoke as c; c.pool_sync_ab()'."""
    import shutil

    global POOL_INITIALIZER
    phase_setup()
    field = {}
    phase_app(device, rec={"tr_subproblem": {}}, field=field)
    try:
        for label, init in (("spinning", None),
                            ("blocking", _blocking_sync)):
            shutil.rmtree(os.path.join(field["dir"], "farm"),
                          ignore_errors=True)
            POOL_INITIALIZER = init
            t0 = time.perf_counter()
            phase_routes(device, galsim={}, farm={"field": field,
                                                  "grid": (2, 1)},
                         experiment={}, runners={}, mcmc={}, app={})
            print(f"route pool, {label}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        POOL_INITIALIZER = _blocking_sync
        shutil.rmtree(field["dir"], ignore_errors=True)


def phase_field_routes(device="cuda", n_sources=16, size=181, seed=7,
                       config=None):
    """The field path through the kernels and through their plain twins
    (infer_box(plain=True)), f64, on run_field.py's density: phase 4's bar
    (0 classification flips, no source's ELBO worse than 1e-4 relative),
    each departure printed. The two runs go in two processes at once
    (main runs them beside phase 14's, phase_routes)."""
    with _route_pool(2) as pool:
        _check_field_routes(_submit_field_routes(
            pool, device, n_sources, size, seed, config), device)


# ---------------------------------------------------------------------------
# phases 11-12: the survey app (main, SDSS files, per-source PSFs)
# ---------------------------------------------------------------------------

# tests/sdss_fixtures.make_sdss_field's photometry: gain 4 e-/DN and 0.005
# nMgy/DN (800 e-/nMgy), sky 0.15 nMgy on a 6 x 4 grid, ~0.396 arcsec/px
SDSS_GAIN, SDSS_CALIB, SDSS_SKY = 4.0, 0.005, 0.15
SDSS_SKY_GRID = (6, 4)
SDSS_CD = np.array([[1.1e-4, 0.0], [0.0, 1.1e-4]])
SDSS_RCF = (3900, 6, 269)
# the local PSF: (1 - w) narrow + w wide, w linear in axis 1 from 0 to 1
# across the frame, each an elliptical two-Gaussian core and halo
PSF_SIGMAS = (1.3, 1.7)
PSF_STAMP = 31
APP_MARGIN = 20.0
PSF_WIDTH_SPAN_BAR = 0.10
PSF_F64_TOL = 1e-9


def app_psf(sigma):
    """A packed (2, 6) elliptical PSF: 0.8 of a core of major sigma
    `sigma`, 0.2 of a halo twice as wide, axis ratio 0.85, at 0.3 rad."""
    from celeste_jl_tpu_torch.models.psf import make_psf

    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s], [s, c]])
    covs = [R @ np.diag([(k * sigma) ** 2, (0.85 * k * sigma) ** 2]) @ R.T
            for k in (1.0, 2.0)]
    return make_psf([0.8, 0.2], np.zeros((2, 2)), covs)


def local_psf(x, H):
    """The true local PSF at 1-based axis-1 position(s) x, packed (..., 4,
    6): the narrow and the wide mixture weighted (1 - w, w)."""
    narrow, wide = (app_psf(s) for s in PSF_SIGMAS)
    w = (np.asarray(x, np.float64) - 1.0) / (H - 1.0)
    out = np.broadcast_to(np.concatenate([narrow, wide]),
                          np.shape(w) + (4, 6)).copy()
    out[..., :2, 0] *= (1.0 - w)[..., None]
    out[..., 2:, 0] *= w[..., None]
    return out


def write_sdss_field(basedir, H, W, n_sources, seed, device):
    """Write one SDSS field in the 'celeste' directory layout with the
    port's io/fits.write_fits: the files and conventions of
    tests/sdss_fixtures.make_sdss_field (frame, fpM, psField, photoField,
    photoObj, field_extents), at H x W px (axis1 x axis2), 5 bands.
    n_sources from default_rng(seed) as benchmark/run_field.py draws them
    (the first half stars, r-flux lognormal(3.0, 0.6); the rest galaxies,
    lognormal(3.2, 0.5), radius lognormal(0.7, 0.3) px), uniform 20 px
    inside the edges, drawn on `device` with each source's local PSF. The
    psField holds two eigenimages (narrow, wide - narrow) whose weights
    make the PSF width vary by +-13 % along axis 1. A few pixel boxes are
    masked in the fpM files. Returns (truth, wcs)."""
    from celeste_jl_tpu_torch.io.fits import write_fits
    from celeste_jl_tpu_torch.io.sdss import BAND_CHARS, SDSSPSFMap
    from celeste_jl_tpu_torch.io.wcs import TanWCS
    from celeste_jl_tpu_torch.models.image import Image
    from celeste_jl_tpu_torch.models.psf import render_psf
    from celeste_jl_tpu_torch.synthetic import (gen_images_fast,
                                                sample_galaxy, sample_star)

    run, camcol, field = SDSS_RCF
    wcs = TanWCS(crpix=[H / 2, W / 2], crval=[150.0, 1.0], cd=SDSS_CD)
    rng = np.random.default_rng(seed)
    pix = APP_MARGIN + rng.random((n_sources, 2)) * (
        np.array([H, W]) - 2 * APP_MARGIN)
    world = wcs.pix_to_world(pix)
    truth = []
    for i in range(n_sources):
        if i < n_sources // 2:
            truth.append(sample_star(pos=world[i], r_flux=float(
                np.exp(rng.normal(3.0, 0.6)))))
        else:
            truth.append(sample_galaxy(
                pos=world[i], r_flux=float(np.exp(rng.normal(3.2, 0.5))),
                gal_radius_px=float(np.exp(rng.normal(0.7, 0.3))),
                gal_axis_ratio=float(rng.uniform(0.25, 0.9)),
                gal_angle=float(rng.uniform(0.0, np.pi))))

    nelec = np.full(H, SDSS_GAIN / SDSS_CALIB)
    images = [Image(pixels=np.zeros((H, W)), band=b, psf=app_psf(1.5),
                    sky=SDSS_SKY, nelec_per_nmgy=nelec, wcs=wcs)
              for b in range(5)]
    psfs = np.repeat(local_psf(pix[:, 0], H)[:, None], 5, axis=1)
    gen_images_fast(images, truth, seed=seed, device=device, psfs=psfs)

    fdir = os.path.join(basedir, str(run), str(camcol), str(field))
    os.makedirs(fdir, exist_ok=True)
    tag = f"{run:06d}-{camcol}-{field:04d}"
    nx, ny = SDSS_SKY_GRID
    sky_small = np.full((nx, ny), SDSS_SKY / SDSS_CALIB)     # DN
    wcs_cards = [("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN"),
                 ("CRPIX1", H / 2), ("CRPIX2", W / 2),
                 ("CRVAL1", 150.0), ("CRVAL2", 1.0),
                 ("CD1_1", SDSS_CD[0, 0]), ("CD1_2", SDSS_CD[0, 1]),
                 ("CD2_1", SDSS_CD[1, 0]), ("CD2_2", SDSS_CD[1, 1])]
    masks = {"r": [((5, 8), (5, 8)), ((H // 2, H // 2 + 3), (W // 3,
                                                            W // 3 + 2))],
             "g": [((H - 12, H - 9), (W - 12, W - 10))]}
    planes = ["S_MASK_INTERP", "S_MASK_SATUR", "S_MASK_CR", "S_MASK_GHOST"
              ] + [f"S_MASK_OTHER{k}" for k in range(1, 7)]
    for b, band in enumerate(BAND_CHARS):
        frame = (images[b].pixels / nelec[:, None] - SDSS_SKY
                 ).astype(np.float32)
        write_fits(os.path.join(fdir, f"frame-{band}-{tag}.fits"), [
            (frame.T.copy(), wcs_cards),
            (np.full(H, SDSS_CALIB, np.float32), None),
            ({"ALLSKY": sky_small.T[None].astype(np.float32),
              "XINTERP": np.linspace(0, nx - 1, H)[None].astype(np.float32),
              "YINTERP": np.linspace(0, ny - 1, W)[None].astype(np.float32)},
             None)])
        boxes = masks.get(band, [])
        i32 = lambda v: np.array(v, np.int32)
        hdus = [(None, None)]
        for plane in range(10):
            sel = boxes if plane == 0 else []
            hdus.append(({"cmin": i32([x0 for (x0, _), _ in sel]),
                          "cmax": i32([x1 for (_, x1), _ in sel]),
                          "rmin": i32([y0 for _, (y0, _) in sel]),
                          "rmax": i32([y1 for _, (_, y1) in sel])}, None))
        hdus.append(({"Value": np.arange(10, dtype=np.int32),
                      "defName": np.array(["S_MASKTYPE"] * 10),
                      "attributeName": np.array(planes)}, None))
        write_fits(os.path.join(
            fdir, f"fpM-{run:06d}-{band}{camcol}-{field:04d}.fit"), hdus)

    narrow, wide = (render_psf(app_psf(s), PSF_STAMP).numpy()
                    for s in PSF_SIGMAS)
    cmat = np.zeros((2, 9))                 # 3 x 3 polynomial, column-major
    cmat[0, 0] = 1.0                        # eigen 0 (narrow): weight 1
    cmat[1, 1] = 1.0 / (SDSSPSFMap.RCS * (H - 1))   # eigen 1: (x - 1)/(H - 1)
    rrows = np.stack([narrow.ravel(order="F"),
                      (wide - narrow).ravel(order="F")])
    write_fits(os.path.join(fdir, f"psField-{tag}.fit"), [(None, None)] + [
        ({"nrow_b": np.array([3, 3], np.int32),
          "ncol_b": np.array([3, 3], np.int32),
          "rnrow": np.array([PSF_STAMP] * 2, np.int32),
          "rncol": np.array([PSF_STAMP] * 2, np.int32),
          "c": cmat.astype(np.float32),
          "rrows": rrows.astype(np.float32)}, None) for _ in BAND_CHARS])
    write_fits(os.path.join(basedir, str(run), str(camcol),
                            f"photoField-{run:06d}-{camcol}.fits"),
               [(None, None), ({"FIELD": np.array([field], np.int32),
                                "GAIN": np.full((1, 5), SDSS_GAIN,
                                                np.float32)}, None)])
    n = len(truth)
    rep5 = lambda v: np.repeat(np.asarray(v, np.float32)[:, None], 5, axis=1)
    fluxes = np.array([ce.star_fluxes if ce.is_star else ce.gal_fluxes
                       for ce in truth], np.float32)
    write_fits(os.path.join(fdir, f"photoObj-{tag}.fits"), [(None, None), ({
        "objid": np.array([f"obj-{i}" for i in range(n)]),
        "ra": world[:, 0], "dec": world[:, 1],
        "objc_flags": np.zeros(n, np.int32),
        "objc_flags2": np.zeros(n, np.int32),
        "nchild": np.zeros(n, np.int16),
        "objc_type": np.array([6 if ce.is_star else 3 for ce in truth],
                              np.int32),
        "fracdev": rep5([ce.gal_frac_dev for ce in truth]),
        "psfflux": fluxes, "cmodelflux": fluxes, "devflux": fluxes,
        "expflux": fluxes,
        "phi_dev_deg": rep5([np.degrees(ce.gal_angle) for ce in truth]),
        "phi_exp_deg": rep5([np.degrees(ce.gal_angle) for ce in truth]),
        "phi_offset": rep5(np.zeros(n)),
        "theta_dev": rep5([ce.gal_radius_px * 0.396 for ce in truth]),
        "theta_exp": rep5([ce.gal_radius_px * 0.396 for ce in truth]),
        "ab_exp": rep5([ce.gal_axis_ratio for ce in truth]),
        "ab_dev": rep5([ce.gal_axis_ratio for ce in truth])}, None)])
    corners = wcs.pix_to_world(np.array([[1, 1], [H, 1], [1, W], [H, W]],
                                        np.float64))
    write_fits(os.path.join(basedir, "field_extents.fits"), [
        (None, None), ({"run": np.array([run], np.int16),
                        "camcol": np.array([camcol], np.int16),
                        "field": np.array([field], np.int16),
                        "ramin": corners[:, 0].min(keepdims=True),
                        "ramax": corners[:, 0].max(keepdims=True),
                        "decmin": corners[:, 1].min(keepdims=True),
                        "decmax": corners[:, 1].max(keepdims=True)}, None)])
    return truth, wcs


def app_box(wcs, H, W):
    """The frame less a 20 px margin, as (ramin, ramax, decmin, decmax)."""
    m = APP_MARGIN
    c = wcs.pix_to_world(np.array([[m, m], [H - m, m], [m, W - m],
                                   [H - m, W - m]], np.float64))
    return (c[:, 0].min(), c[:, 0].max(), c[:, 1].min(), c[:, 1].max())


def app_score(results, truth, wcs):
    """field_score through the frame's TAN WCS: results and truth matched
    within 2 px in pixel coordinates."""
    import dataclasses

    return field_score(
        [dataclasses.replace(r, init_pos=wcs.world_to_pix(r.init_pos))
         for r in results],
        [dataclasses.replace(t, pos=wcs.world_to_pix(t.pos)) for t in truth])


def app_config(dirname, basedir, extra=""):
    """A celeste.yml naming the SDSS dataset at basedir; returns its path."""
    path = os.path.join(dirname, "celeste.yml")
    with open(path, "w") as f:
        f.write(f"# the survey app's config (chip_smoke.py)\n{extra}"
                f"datasets:\n  sdss:\n    basedir: '{basedir}'\n"
                f"    dirlayout: celeste\n")
    return path


def app_run(argv, device, label):
    """One main(argv) run, instrumented: the FITS load, the per-source PSF
    fits (seconds, lanes, their K3 launches and the fitted table), the
    detection and the inference are timed, K1-K3's launches counted by
    width (their counters set to 0 at the start). Returns a dict."""
    import torch

    from celeste_jl_tpu_torch import main as app
    from celeste_jl_tpu_torch.io import sdss
    from celeste_jl_tpu_torch.ops import tr
    from celeste_jl_tpu_torch.parallel import run, state
    from celeste_jl_tpu_torch.utils import telemetry

    out = dict(psf_s=0.0, psf_lanes=[], psf_k3=0, psf_tables=[])
    orig = dict(load=sdss.SDSSDataSet.load_images,
                psf=state.fit_patch_psfs, detect=run.detect_sources,
                infer=app.infer_box)

    def timed(key, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            res = fn(*a, **k)
            out[key] = out.get(key, 0.0) + time.perf_counter() - t
            if key == "detect_s":
                out["catalog"] = res[0]
            return res
        return wrapper

    def psf_fits(images, positions, **k):
        t, n3 = time.perf_counter(), tr.tr_subproblem.launches
        table = orig["psf"](images, positions, **k)
        out["psf_s"] += time.perf_counter() - t
        out["psf_k3"] += tr.tr_subproblem.launches - n3
        out["psf_lanes"].append(len(positions))
        out["psf_tables"].append(table)
        return table

    if device == "cuda":
        torch.cuda.synchronize()
    sdss.SDSSDataSet.load_images = timed("load_s", orig["load"])
    state.fit_patch_psfs = psf_fits
    run.detect_sources = timed("detect_s", orig["detect"])
    app.infer_box = timed("infer_box_s", orig["infer"])
    try:
        with KernelWidths() as kw_rec:
            t0 = time.perf_counter()
            rc = app.main(argv, device=device)
            out["wall_s"] = time.perf_counter() - t0
    finally:
        sdss.SDSSDataSet.load_images = orig["load"]
        state.fit_patch_psfs = orig["psf"]
        run.detect_sources = orig["detect"]
        app.infer_box = orig["infer"]
    check(rc == 0, f"{label}: main returned {rc}")
    out["infer_s"] = out["infer_box_s"] - out.get("detect_s", 0.0)
    out["launches"] = kw_rec.launches()
    out["kernels"] = kw_rec.summary()
    out["counters"] = telemetry.counters
    return out


def app_results(outdir):
    """The run's one .npz, read back with the port's load_results."""
    import glob

    from celeste_jl_tpu_torch.main import load_results

    files = glob.glob(os.path.join(outdir, "celeste-*.npz"))
    check(len(files) == 1, f"expected one .npz in {outdir}, found {files}")
    return load_results(files[0])


def k3_at_psf_shape(S, device):
    """K3 against its twin at the PSF fits' shape (S lanes, D = 12, f64,
    48 bisections), timed with its f64 bound (tr_bound's count: ~5 flops
    per coordinate per bisection; gq, w, delta in, p and pred out)."""
    import torch

    from celeste_jl_tpu_torch.ops import tr

    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    gq, w, delta = map(t, tr_cases(np.random.default_rng(12), S, D=12))
    p1, r1 = tr.tr_subproblem(gq, w, delta, 48)
    p2, r2 = tr.tr_subproblem_plain(gq, w, delta, 48)
    err = max(_rel_err(p1, p2), _rel_err(r1[:, None], r2[:, None]))
    abs_err = max(float((p1 - p2).abs().max()), float((r1 - r2).abs().max()))
    check(err < F64_TOL, f"K3 at the PSF fits' shape B={S} D=12 f64: rel "
          f"err {err:.3g} (tol {F64_TOL:g})")
    if device == "cuda":
        kernel = lambda: tr.tr_subproblem(gq, w, delta, 48)
        ms, device_ms = (timed_ms(kernel, torch),
                         timed_ms(kernel, torch, spin=True))
        plain_ms = timed_ms(lambda: tr.tr_subproblem_plain(gq, w, delta, 48),
                            torch)
    else:
        ms = device_ms = plain_ms = float("nan")
    return dict(B=S, D=12, dtype="float64", max_abs_err=abs_err, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms,
                **bound(S * 48 * 12 * 5, 8 * S * (3 * 12 + 2), f64=True))


def phase_app(device="cuda", H=2048, W=1489, n_sources=400, seed=11,
              method="joint_vi", rec=None, bars=True, field=None):
    """The survey app at full width: one SDSS field (H x W px, 5 bands,
    n_sources, a spatially varying psField PSF) written to FITS files, then
    main(["sdss", <the frame less a 20 px margin>, "--config", yml,
    "--method", method, "--detect-thresh", "6", "--outdir", ...]) on
    `device` (float64, as the CLI runs), and the .npz read back with
    load_results. Prints the load, PSF-fit, detect and infer seconds,
    sources/s, the score (through the frame's TAN WCS), the fit launches
    by lane width and K1-K3's launches by width; with `rec`, K3 is checked
    against its twin and timed at the PSF fits' shape, and K1 timed in
    f64 at the median fit-launch width. Bars (bars=True):
    every ELBO finite, 0 failures, completeness >= 0.95 and type accuracy
    >= 0.90, K1-K3 each launched and K3 by the PSF fits, the fitted r-band
    local PSF widths spanning >= 10 % across the targets, and every target
    of the box in the .npz. Returns the run's launches.
    field: a dict that, when given, receives the field (its directory
    under build/, which is then kept for the caller to remove, the SDSS
    basedir, the box, the truth, the WCS and the run's targets) for phase
    16."""
    import shutil
    import tempfile

    import torch

    from celeste_jl_tpu_torch.io.dataset import BoundingBox
    from celeste_jl_tpu_torch.models.psf import get_psf_width

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="app-", dir=os.path.join(ROOT, "build"))
    keep = field is not None
    try:
        t0 = time.perf_counter()
        base = os.path.join(tmp, "sdss")
        truth, wcs = write_sdss_field(base, H, W, n_sources, seed, device)
        print(f"phase 11: SDSS field {H}x{W} px, 5 bands, {n_sources} "
              f"sources, seed {seed}, written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        box = app_box(wcs, H, W)
        outdir = os.path.join(tmp, "out")
        argv = (["sdss"] + [repr(float(v)) for v in box]
                + ["--config", app_config(tmp, base), "--method", method,
                   "--detect-thresh", "6", "--outdir", outdir])
        r = app_run(argv, device, "phase 11")
        results = app_results(outdir)
    except BaseException:
        keep = False
        raise
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    c = r["counters"]
    targets = [ce for ce in r.get("catalog", [])
               if BoundingBox(*box).contains(*ce.pos)]
    if keep:
        field.update(dir=tmp, base=base, box=box, truth=truth, wcs=wcs,
                     targets=targets)
    n_match, acc, errs = app_score(results, truth, wcs)
    completeness = n_match / len(truth)
    med = float(np.median(errs)) if errs else float("nan")
    elbos = np.array([x.elbo for x in results])
    widths = np.array([get_psf_width(row[2]) for table in r["psf_tables"]
                       for row in table])
    span = (float((widths.max() - widths.min()) / np.median(widths))
            if widths.size else 0.0)
    fit_widths = dict(sorted(c.lane_widths.items()))
    print(f"phase 11 {method}: FITS load {r.get('load_s', 0.0):.3f} s (the "
          f"field-center PSF fits included), per-source PSF fits "
          f"{r['psf_s']:.3f} s, {r['psf_lanes']} lanes a band, K3 "
          f"{r['psf_k3']} launches; detect {r.get('detect_s', 0.0):.3f} s, "
          f"infer {r['infer_s']:.3f} s (PSF fits included), "
          f"{len(results) / r['infer_s']:.3f} sources/s; main "
          f"{r['wall_s']:.3f} s; detected {len(r.get('catalog', []))}, "
          f"{len(targets)} in the box, {len(results)} in the .npz; matched "
          f"{n_match}, completeness {completeness:.4f}; type accuracy "
          f"{acc:.4f}; median r-flux rel err {med:.4f}; r-band local PSF "
          f"width {widths.min() if widths.size else 0:.4f}-"
          f"{widths.max() if widths.size else 0:.4f} px (span {span:.4f}); "
          f"{c.launches} fit launches by lane width {fit_widths}, lane fill "
          f"{c.lane_fill():.4f}; failures {c.failures}", flush=True)
    print(f"phase 11 {method} kernels: {r['kernels']}", flush=True)
    if bars:
        ok = (bool(np.all(np.isfinite(elbos))) and c.failures == 0
              and completeness >= FIELD_COMPLETENESS_BAR
              and acc >= FIELD_TYPE_BAR and span >= PSF_WIDTH_SPAN_BAR
              and len(results) == len(targets) > 0)
        if device == "cuda":
            ok = ok and r["psf_k3"] > 0 and all(
                r["launches"][k] > 0 for k in FIELD_KERNELS)
        check(ok, f"phase 11: finite ELBOs "
              f"{bool(np.all(np.isfinite(elbos)))}, failures {c.failures}, "
              f"completeness {completeness:.4f} (bar "
              f"{FIELD_COMPLETENESS_BAR}), type accuracy {acc:.4f} (bar "
              f"{FIELD_TYPE_BAR}), PSF width span {span:.4f} (bar "
              f"{PSF_WIDTH_SPAN_BAR}), .npz {len(results)} of {len(targets)} "
              f"targets, launches {r['launches']}, K3 by the PSF fits "
              f"{r['psf_k3']}")
    if rec is not None and fit_widths:
        # K1 in f64, the CLI's type, at the median fit-launch width
        W = int(np.median(np.repeat(list(fit_widths),
                                    list(fit_widths.values()))))
        k1 = refresh_kernel_at(W, 32, device, torch.float64)
        rec.setdefault("refresh", {})["app_f64"] = k1
        print(f"phase 11: refresh f64 at the median fit-launch width W={W} "
              f"(G={k1['B']}, 32x32): {k1['ms']:.4f} ms "
              f"({k1['device_ms']:.4f} on the card alone), bound "
              f"{k1['bound_ms']:.3g} ms ({k1['bound_by']})", flush=True)
    if rec is not None and r["psf_lanes"]:
        k3 = k3_at_psf_shape(max(r["psf_lanes"]), device)
        rec["tr_subproblem"]["psf_fit"] = k3
        print(f"phase 11: tr_subproblem at the PSF fits' shape B={k3['B']} "
              f"D=12 f64: max abs err {k3['max_abs_err']:.3g}; "
              f"{k3['ms']:.4f} ms ({k3['device_ms']:.4f} on the card alone), "
              f"plain {k3['plain_ms']:.4f} ms, bound {k3['bound_ms']:.3g} ms "
              f"({k3['bound_by']})", flush=True)
    print("phase 11 ok", flush=True)
    return r["launches"]


def phase_app_routes(device="cuda", size=256, n_sources=32, seed=7,
                     config=None):
    """The app's routes on a small SDSS field (size x size px, n_sources,
    phase 10's density), f64: fit_patch_psfs through K3 and through its
    twin (packed params within 1e-9 relative); infer_box(joint_vi) on the
    loaded images through the kernels and through plain=True (0 flips, no
    ELBO worse than 1e-4 relative); then main with --method svi and
    single_vi (every ELBO finite, completeness >= 0.95), and the median
    ELBO gap between them. The twins' infer_box runs in a process of its
    own from the phase's start (it writes and loads the same field from
    the same seed), beside this process's runs. config: infer_box's
    Config (default Config()) for a CPU rehearsal."""
    import shutil
    import tempfile

    import torch

    from celeste_jl_tpu_torch.io.sdss import RunCamcolField, SDSSDataSet
    from celeste_jl_tpu_torch.models.psf_fit import fit_patch_psfs
    from celeste_jl_tpu_torch.parallel.run import infer_box
    from celeste_jl_tpu_torch.utils.config import Config

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="app-", dir=os.path.join(ROOT, "build"))
    pool = _route_pool(1)
    try:
        twin = pool.submit(_app_route, True, True, device, size, n_sources,
                           seed, config)
        base = os.path.join(tmp, "sdss")
        truth, wcs = write_sdss_field(base, size, size, n_sources, seed,
                                      device)
        images = SDSSDataSet(base, device=device).load_field_images(
            RunCamcolField(*SDSS_RCF))
        pos = [t.pos for t in truth]
        t0 = time.perf_counter()
        pk = fit_patch_psfs(images, pos, device=device)
        t1 = time.perf_counter()
        pp = fit_patch_psfs(images, pos, device=device, plain=True)
        t2 = time.perf_counter()
        S = len(pos)
        err = _rel_err(torch.as_tensor(pk).reshape(S, -1),
                       torch.as_tensor(pp).reshape(S, -1))
        msg = (f"phase 12: fit_patch_psfs {S} sources x 5 bands f64, K3 vs "
               f"twin: packed rel err {err:.3g} (tol {PSF_F64_TOL:g}); "
               f"kernel {t1 - t0:.3f} s, plain {t2 - t1:.3f} s")
        check(np.all(np.isfinite(pk)) and err < PSF_F64_TOL, msg)
        print(msg, flush=True)

        kw = dict(method="joint_vi", config=config or Config(),
                  device=device, dtype=torch.float64, thresh=6.0,
                  boxsize=(size, size))
        t0 = time.perf_counter()
        with KernelWidths() as rk_rec:
            rk = infer_box(images, **kw)
        t_k = time.perf_counter() - t0
        # read now: the main runs below count launches of their own
        k_launches, k_summary = rk_rec.launches(), rk_rec.summary()

        box = app_box(wcs, size, size)
        runs = {}
        for method in ("svi", "single_vi"):
            outdir = os.path.join(tmp, method)
            argv = (["sdss"] + [repr(float(v)) for v in box]
                    + ["--config", app_config(tmp, base), "--method",
                       method, "--detect-thresh", "6", "--outdir", outdir])
            r = app_run(argv, device, f"phase 12 {method}")
            res = app_results(outdir)
            n_match, acc, _ = app_score(res, truth, wcs)
            completeness = n_match / len(truth)
            elbos = np.array([x.elbo for x in res])
            msg = (f"phase 12 main --method {method}: {len(res)} sources, "
                   f"main {r['wall_s']:.3f} s (infer {r['infer_s']:.3f} s); "
                   f"matched {n_match}, completeness {completeness:.4f}; "
                   f"type accuracy "
                   f"{acc:.4f}; finite ELBOs "
                   f"{bool(np.all(np.isfinite(elbos)))}")
            check(len(res) > 0 and bool(np.all(np.isfinite(elbos)))
                  and completeness >= FIELD_COMPLETENESS_BAR,
                  msg + f" (bar {FIELD_COMPLETENESS_BAR})")
            print(msg, flush=True)
            runs[method] = {tuple(x.init_pos): x.elbo for x in res}

        rp, t_p = twin.result()
        check(len(rk) > 0, "phase 12: no source detected")
        flips, rel = _route_diff("phase 12", rk, rp)
        msg = (f"phase 12: infer_box(joint_vi) {len(rk)} sources f64 on the "
               f"SDSS field, kernels vs plain twins: {flips} flips; ELBO rel "
               f"worst {rel.min():.3g}, best {rel.max():.3g}; kernels "
               f"{t_k:.3f} s, plain {t_p:.3f} s; {k_summary}; bar: 0 "
               f"flips, worst > -{SLICE_ELBO_TOL:g}")
        check(flips == 0 and bool(np.all(rel > -SLICE_ELBO_TOL)), msg)
        if device == "cuda":
            check(all(n > 0 for n in k_launches.values()),
                  f"phase 12: a field kernel never launched: {k_launches}")
        print(msg, flush=True)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    common = set(runs["svi"]) & set(runs["single_vi"])
    gap = [runs["single_vi"][k] - runs["svi"][k] for k in common]
    print(f"phase 12: svi vs single_vi on {len(common)} sources: median "
          f"ELBO gap (single_vi - svi) {float(np.median(gap)):.4f} nats",
          flush=True)
    print("phase 12 ok", flush=True)



# ---------------------------------------------------------------------------
# phases 13-14: the multi-field fused schedule
# ---------------------------------------------------------------------------

class FusedStagings:
    """Records, while open, each _fused_joint_dispatch of the schedules in
    parallel/run.py: (states, classes, handle), the handle None where the
    staging exceeded the budget (the fallback)."""

    def __enter__(self):
        from celeste_jl_tpu_torch.parallel import run

        self.run, self.dispatch, self.calls = run, run._fused_joint_dispatch, []

        def spy(states, classes, *a, **k):
            h = self.dispatch(states, classes, *a, **k)
            self.calls.append((states, classes, h))
            return h

        run._fused_joint_dispatch = spy
        return self

    def __exit__(self, *exc):
        self.run._fused_joint_dispatch = self.dispatch

    def multi_field_classes(self):
        """Of every staged class, how many hold sources of 2+ fields."""
        n = 0
        for states, classes, _ in self.calls:
            offsets = np.cumsum([0] + [len(st.catalog) for st in states])
            for cls in classes:
                fields = set(np.searchsorted(offsets, cls, side="right") - 1)
                n += len(fields) > 1
        return n


def phase_multifield(device="cuda", n_fields=8, n_sources=128, size=512,
                     seed=7, config=None, newton_config=None, bars=True):
    """benchmark/run_multifield.py's run at its size of record through the
    port's runner (celeste_jl_tpu_torch.benchmark.multifield.run_pass):
    n_fields fields of n_sources on size x size px (field f from seed +
    1000 f) drawn on the card, detected, and inferred as ONE merged fused
    schedule by joint_infer_fields, f32 through K1-K3; scored as
    run_multifield.py scores. Bars: finite ELBOs, 0 failures, completeness
    and type accuracy (phase 9's), K1-K3 each launched, the fused staging
    taken (no budget fallback), a class holding sources of two fields.
    config (default Config()) and newton_config (default NewtonConfig(),
    the isolated fits') shorten the schedule for a CPU rehearsal, where
    bars=False skips the quality bars. Returns K1-K3's launches."""
    import torch

    from celeste_jl_tpu_torch.benchmark import multifield
    from celeste_jl_tpu_torch.utils import telemetry

    with FusedStagings() as fs, KernelWidths() as kw_rec:
        out, per_field, _ = multifield.run_pass(
            n_fields, n_sources, size, seed, device=device,
            dtype=torch.float32, config=config, newton_config=newton_config)
    c = telemetry.counters
    launches = kw_rec.launches()
    elbos = np.array([r.elbo for res in per_field for r in res])
    staged = [h for _, _, h in fs.calls]
    n_multi = fs.multi_field_classes()
    n_classes = sum(len(cl) for _, cl, _ in fs.calls)
    stage_s = sum(h["stage_s"] for h in staged if h is not None)
    sched_s = sum(h.get("schedule_s", 0.0) for h in staged if h is not None)
    g = lambda k, fmt=".4f": (format(out[k], fmt) if out[k] is not None
                              else "None")
    print(f"phase 13: {n_fields} fields x {n_sources} sources, {size}x{size}"
          f" px: detected {out['n_detected']}, matched {out['n_matched']}, "
          f"completeness {g('completeness')}, type accuracy "
          f"{g('type_accuracy')}, median r-flux rel err "
          f"{g('median_flux_relerr')}", flush=True)
    print(f"phase 13: {out['fits']} fits, busy {g('device_busy_s', '.3f')} "
          f"s, summed launch {g('launch_wall_sum_s', '.3f')} s; device "
          f"{g('value', '.3f')} fits/s, device "
          f"{g('device_sources_per_sec', '.3f')} sources/s, e2e "
          f"{g('e2e_sources_per_sec', '.3f')} sources/s; utilization "
          f"{g('utilization')}, {g('achieved_model_gflops_per_s', '.4f')} "
          f"model GFLOP/s, MFU {g('mfu', '.6f')}; {out['serial_tr_steps']} "
          f"serial TR steps, {g('mean_iters_per_fit', '.2f')} iterations a "
          f"fit, converged {g('converged_frac')}; infer wall "
          f"{g('infer_wall_s', '.3f')} s, detect wall "
          f"{g('detect_wall_s', '.3f')} s; failures {c.failures}",
          flush=True)
    print(f"phase 13: fused staging {stage_s:.3f} s, schedule {sched_s:.3f}"
          f" s; {c.launches} fit launches by lane width "
          f"{dict(sorted(c.lane_widths.items()))}; {n_classes} merged "
          f"classes, {n_multi} of them with sources of 2+ fields; "
          f"budget fallbacks {sum(h is None for h in staged)}", flush=True)
    print(f"phase 13 kernels: {kw_rec.summary()}", flush=True)
    print("phase 13 json: " + json.dumps(out), flush=True)
    if bars:
        check(bool(np.all(np.isfinite(elbos))) and c.failures == 0,
              f"phase 13: finite ELBOs {bool(np.all(np.isfinite(elbos)))},"
              f" failures {c.failures}")
        check(out["completeness"] >= FIELD_COMPLETENESS_BAR
              and out["type_accuracy"] >= FIELD_TYPE_BAR,
              f"phase 13: completeness {out['completeness']:.4f} (bar "
              f"{FIELD_COMPLETENESS_BAR}), type accuracy "
              f"{out['type_accuracy']:.4f} (bar {FIELD_TYPE_BAR})")
        check(len(staged) > 0 and all(h is not None for h in staged),
              f"phase 13: the fused staging was not taken ({len(staged)} "
              "stagings, a None is the budget fallback)")
        check(n_multi > 0, "phase 13: no class holds sources of two fields")
        if device == "cuda":
            check(all(n > 0 for n in launches.values()),
                  f"phase 13: a field kernel never launched: {launches}")
    print("phase 13 ok", flush=True)
    return launches


def _route_diff(label, got, want):
    """(classification flips, relative ELBO departures) of two result
    lists of the same sources (the first run against the second); prints
    each departing source: its star flags, ELBO departure and converged
    flags in both runs."""
    from celeste_jl_tpu_torch.models.params import ids

    check(len(got) == len(want) and all(
        np.array_equal(a.init_pos, b.init_pos) for a, b in zip(got, want)),
        f"{label}: the two runs hold different sources")
    sg = np.array([r.vs[ids.is_star[0]] > 0.5 for r in got])
    sw = np.array([r.vs[ids.is_star[0]] > 0.5 for r in want])
    eg = np.array([r.elbo for r in got])
    ew = np.array([r.elbo for r in want])
    rel = (eg - ew) / np.abs(ew)
    for i in np.nonzero((sg != sw) | (rel != 0.0))[0]:
        print(f"{label}: source {i} at {got[i].init_pos}: star {sg[i]} / "
              f"{sw[i]}, ELBO {eg[i]:.6f} / {ew[i]:.6f} (rel {rel[i]:.3g}), "
              f"converged {got[i].converged} / {want[i].converged}",
              flush=True)
    check(bool(np.all(np.isfinite(eg))), f"{label}: a non-finite ELBO")
    return int(np.sum(sg != sw)), rel


def _multifield_route(item, device, n_sources, size, seeds, config,
                      newton_config, bars):
    """Check `item` (1-3) of phase 14 on the two fields (see
    phase_multifield_routes), in its own process: returns its line, or
    raises PhaseError. Item "4 pipelined" and "4 per group" return (their
    line, their results), which the caller compares."""
    import torch

    from celeste_jl_tpu_torch.benchmark.multifield import build_field
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel.run import (
        joint_infer_fields, joint_infer_fields_pipelined, one_node_joint_infer)
    from celeste_jl_tpu_torch.utils.config import Config

    # one intra-op thread: four processes share the host's cores (their
    # host work is dispatch; more threads only spin against each other)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    kw = dict(config=config or Config(),
              newton_config=newton_config or NewtonConfig(), device=device,
              dtype=torch.float64)
    fields = [build_field(s, n_sources, size, device)[0] for s in seeds]
    label = f"phase 14 ({item})"
    if item in (1, 2):
        with KernelWidths() as kw_rec:
            rk = joint_infer_fields(fields, **kw)
    if item == 1:
        rp = joint_infer_fields(fields, plain=True, **kw)
        flips, rel = _route_diff(label, sum(rk, []), sum(rp, []))
        msg = (f"{label}: {len(fields)} fields, {sum(map(len, rk))} "
               f"sources f64, kernels vs plain twins: {flips} flips; ELBO "
               f"rel worst {rel.min():.3g}, best {rel.max():.3g}; "
               f"{kw_rec.summary()}; bar: 0 flips, worst > "
               f"-{SLICE_ELBO_TOL:g}")
        check(flips == 0 and bool(np.all(rel > -SLICE_ELBO_TOL)), msg)
        if device == "cuda":
            check(all(n > 0 for n in kw_rec.launches().values()),
                  f"{label}: a field kernel never launched: "
                  f"{kw_rec.launches()}")
    elif item == 2:
        alone = [one_node_joint_infer(f["catalog"], f["images"],
                                      active_boxes=f["active_boxes"], **kw)
                 for f in fields]
        flips, rel = _route_diff(label, sum(rk, []), sum(alone, []))
        msg = (f"{label}: merged vs each field alone: {flips} flips; ELBO "
               f"rel worst {rel.min():.3g}, best {rel.max():.3g}; bar: 0 "
               "flips")
        check(flips == 0 or not bars, msg)
    elif item == 3:
        import shutil
        import tempfile

        f0 = fields[0]
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="ckpt-", dir=os.path.join(ROOT, "build"))
        try:
            # a checkpoint_path selects the host-driven loop
            a, b = (one_node_joint_infer(
                f0["catalog"], f0["images"], active_boxes=f0["active_boxes"],
                fused=False, **kw, **k)
                for k in ({}, dict(checkpoint_path=os.path.join(
                    tmp, "joint.npz"))))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        dvs = max(float(np.max(np.abs(x.vs - y.vs))) for x, y in zip(a, b))
        msg = (f"{label}: one field ({len(a)} sources) over the host "
               f"schedule's classes (fused=False), the fused schedule vs the "
               f"host-driven loop: max |vs| difference {dvs:.3g}; bar: 1e-8")
        check(dvs < 1e-8, msg)
    elif item == "4 pipelined":
        built, out = [], []

        def lazy():
            for s in seeds:
                built.append(s)
                yield [build_field(s, n_sources, size, device)[0]]

        for res in joint_infer_fields_pipelined(lazy(), **kw):
            out.append(res)
            check(len(built) >= min(len(out) + 1, len(seeds)),
                  f"{label}: group {len(out)} was yielded before the "
                  "next group was pulled")
        msg = f"{label}: {len(out)} lazy one-field groups"
    else:
        out = [joint_infer_fields([f], **kw) for f in fields]
        msg = f"{label}: joint_infer_fields on each field"
    msg = f"{msg}; {time.perf_counter() - t0:.3f} s"
    return (msg, out) if item in ("4 pipelined", "4 per group") else msg


MULTIFIELD_ROUTE_ITEMS = (1, 2, 3, "4 pipelined", "4 per group")


def _submit_multifield_routes(pool, device="cuda", n_sources=8, size=128,
                              seeds=(7, 1007), config=None,
                              newton_config=None, bars=True):
    """Phase 14's checks, each (and each side of (4)) submitted to `pool`."""
    args = (device, n_sources, size, seeds, config, newton_config, bars)
    return [pool.submit(_multifield_route, item, *args)
            for item in MULTIFIELD_ROUTE_ITEMS]


def _check_multifield_routes(pending, n_groups):
    """Phase 14's lines and its pipeline bar (see phase_multifield_routes)."""
    for p in pending[:3]:
        print(p.result(), flush=True)
    (m1, piped), (m2, seq) = (p.result() for p in pending[3:])
    same = all(np.array_equal(x.vs, y.vs) and x.elbo == y.elbo
               for p, q in zip(piped, seq) for x, y in zip(p[0], q[0]))
    msg = (f"phase 14 (4): pipelined ({m1}) vs per group ({m2}): bit for "
           f"bit {same}")
    check(len(piped) == len(seq) == n_groups and same, msg)
    print(msg, flush=True)
    print("phase 14 ok", flush=True)


def phase_multifield_routes(device="cuda", n_sources=8, size=128,
                            seeds=(7, 1007), config=None,
                            newton_config=None, bars=True):
    """The multi-field path's routes, f64, on two fields at phase 10's
    density (run_multifield.py's generator): (1) joint_infer_fields
    through the kernels and through plain=True: 0 flips, no ELBO worse
    than 1e-4 relative; (2) the merged result against each field's own
    one_node_joint_infer: 0 flips, the worst ELBO departure printed (the
    merge changes the isolated launches' widths, so no bit equality on
    the card); (3) the first field over the host schedule's classes
    (fused=False) through the fused schedule against the host-driven loop
    that a checkpoint_path selects: every vs within 1e-8
    (tests/test_infer.py:121-124); (4) joint_infer_fields_pipelined over
    lazy one-field groups against joint_infer_fields on each group: bit
    for bit, the generator a group ahead of the consumer. The checks are
    independent and host-bound, so each (and each side of (4)) runs in a
    process of its own, all at once (main runs them beside phase 10's,
    phase_routes). config and newton_config (defaults Config(),
    NewtonConfig()) shorten the schedules for a CPU rehearsal, where
    bars=False skips (2)'s bar: a schedule cut short leaves its fits far
    from their optima, so two class orders part there."""
    with _route_pool(len(MULTIFIELD_ROUTE_ITEMS)) as pool:
        _check_multifield_routes(_submit_multifield_routes(
            pool, device, n_sources, size, seeds, config, newton_config,
            bars), len(seeds))


def _one_thread(fn, *args, **kwargs):
    """fn(*args, **kwargs) with one intra-op thread: a route process's."""
    import torch

    torch.set_num_threads(1)
    return fn(*args, **kwargs)


def phase_routes(device="cuda", field=None, multi=None, galsim=None,
                 farm=None, experiment=None, runners=None, mcmc=None,
                 app=None):
    """Phases 10 and 14 at once, each run in a process of its own (seven),
    and beside them, each in a process of its own when its argument is
    given: phase 7 (the AIS through K4 and its twin), phase 12 (the app's
    routes), phase 15, phase 16, phase 17a's two stages (the MCMC
    experiment's joint VI and its AIS, each in a process, then its files
    and tables here) and phases 17e and 17f one after the other (the
    calibration and SVI runners). All are host-bound runs with no timed record, so side by
    side they take about the longest of them. field: phase_field_routes'
    keyword arguments (defaults: 16 sources on 181 x 181 px, seed 7);
    multi: phase_multifield_routes' (defaults: two 8-source fields on 128
    x 128 px, seeds 7 and 1007); mcmc: phase_mcmc_routes' on
    mcmc_scene(device); app: phase_app_routes'; galsim: phase_galsim's
    ({} for its defaults); farm: phase_farm's (with `field`, phase 11's);
    experiment: mcmc_experiment.run's; runners: {"calibration":
    phase_calibration's, "svi_compare": phase_svi_compare's}. Returns
    {phase: its launches} for the phases run of 15, 16, 17a, 17e and 17f
    (keys "galsim", "farm", "experiment", "calibration",
    "svi_compare")."""
    field, multi = dict(field or {}), dict(multi or {})
    stage = lambda name: (None if experiment is None
                          else dict(experiment, stage=name))
    jobs = {"farm": (phase_farm, farm), "galsim": (phase_galsim, galsim),
            "experiment_vi": (experiment_stage, stage("vi")),
            "experiment_mcmc": (experiment_stage, stage("mcmc")),
            "runners": (_science_runners, runners),
            "mcmc": (_mcmc_routes, mcmc), "app": (phase_app_routes, app)}
    jobs = {k: v for k, v in jobs.items() if v[1] is not None}
    n = 2 + len(MULTIFIELD_ROUTE_ITEMS) + len(jobs)
    with _route_pool(n) as pool:
        futures = {k: pool.submit(_one_thread, fn, device=device, **kw)
                   for k, (fn, kw) in jobs.items()}
        f10 = _submit_field_routes(pool, device, **field)
        f14 = _submit_multifield_routes(pool, device, **multi)
        _check_field_routes(f10, device)
        _check_multifield_routes(f14, len(multi.get("seeds", (7, 1007))))
        out = {k: f.result() for k, f in futures.items()}
    out.update(out.pop("runners", {}))
    out.pop("mcmc", None)
    out.pop("app", None)
    if experiment is not None:
        out["experiment"] = phase_experiment(
            device, parts=(out.pop("experiment_vi"),
                           out.pop("experiment_mcmc")))
    return out


def _mcmc_routes(device="cuda", **kw):
    """Phase 7 on its own copy of bench_mcmc.py's scene (a route process
    of phase_routes)."""
    phase_mcmc_routes(mcmc_scene(device), device, **kw)


def _science_runners(device="cuda", calibration=None, svi_compare=None):
    """Phases 17e and 17f one after the other (one process of the route
    pool): {"calibration": launches, "svi_compare": launches}."""
    return {"calibration": phase_calibration(device, **(calibration or {})),
            "svi_compare": phase_svi_compare(device, **(svi_compare or {}))}


def _joint_turn(kind, joint, tmp):
    """one_node_joint_infer for a turn of schedule_turns: "fused" (the
    default classes), "host" (fused=False: the host schedule's classes,
    the same engine) or "loop" (those classes through the host-driven loop,
    which a fresh checkpoint_path selects)."""
    def infer(*a, **k):
        k["fused"] = kind == "fused"
        if kind == "loop":
            path = os.path.join(tmp, "joint.npz")
            if os.path.exists(path):
                os.remove(path)
            k["checkpoint_path"] = path
        return joint(*a, **k)

    return infer


def schedule_turns(order=("loop", "host", "fused", "fused", "host", "loop"),
                   phases=(9,), device="cuda", n_sources=256, size=724):
    """Phase 9's joint run (and phase 11 if asked) in turns in one process
    (phase 9's field: n_sources on size x size px, seed 7),
    each turn with the joint schedule of its kind (see _joint_turn), so
    that the schedules compare on one card:

        python3 -c 'import chip_smoke as c; c.phase_setup();
                    c.schedule_turns()'

    Each turn prints its phase lines (infer seconds, sources/s, the
    scores, launches) after a "turn N: <kind>" line."""
    import shutil
    import tempfile

    import torch

    from celeste_jl_tpu_torch.parallel import run
    from celeste_jl_tpu_torch.utils.config import Config

    images, truth = field_scene(n_sources, size, 7, device)
    joint = run.one_node_joint_infer
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="turns-", dir=os.path.join(ROOT, "build"))
    try:
        for i, kind in enumerate(order):
            print(f"turn {i}: {kind}", flush=True)
            run.one_node_joint_infer = _joint_turn(kind, joint, tmp)
            if 9 in phases:
                t0 = time.perf_counter()
                field_run(images, truth, "joint_vi", device, torch.float32,
                          f"turn {i} ({kind}) phase 9", True,
                          config=Config(), thresh=6.0, boxsize=(size, size),
                          match_radius_deg=1.0)
                _phase_clock(9, t0)
            if 11 in phases:
                t0 = time.perf_counter()
                phase_app(device=device)
                _phase_clock(11, t0)
    finally:
        run.one_node_joint_infer = joint
        shutil.rmtree(tmp, ignore_errors=True)


def _app_route(plain, fused, device, size, n_sources, seed, config=None):
    """One run of phase 12's infer_box routes, in a process of its own:
    the SDSS field written and loaded, then infer_box(joint_vi) in f64
    through the kernels or their twins (plain), over the default classes
    or the host schedule's (fused=False). Returns (the results, the
    infer_box seconds)."""
    import shutil
    import tempfile

    import torch

    from celeste_jl_tpu_torch.io.sdss import RunCamcolField, SDSSDataSet
    from celeste_jl_tpu_torch.parallel.run import infer_box
    from celeste_jl_tpu_torch.utils.config import Config

    torch.set_num_threads(1)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="witness-", dir=os.path.join(ROOT, "build"))
    try:
        base = os.path.join(tmp, "sdss")
        write_sdss_field(base, size, size, n_sources, seed, device)
        images = SDSSDataSet(base, device=device).load_field_images(
            RunCamcolField(*SDSS_RCF))
        t0 = time.perf_counter()
        res = infer_box(images, method="joint_vi", config=config or Config(),
                        device=device, dtype=torch.float64, thresh=6.0,
                        boxsize=(size, size), plain=plain, fused=fused)
        return res, time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def app_route_witness(device="cuda", size=222, n_sources=24,
                      seeds=(7, 8, 9)):
    """Phase 12's infer_box routes on SDSS fields of n_sources on size x
    size px, f64, to tell a basin change from a fault when kernels and
    twins part: on seeds[0], kernels and twins over both class
    partitions (the default fused_color_classes, and the host schedule's
    with fused=False); on the other seeds, kernels and twins over the
    default. Each run in a process of its own, all at once; each
    comparison printed with its departures and phase 12's bar (0 flips,
    no ELBO worse than 1e-4 relative) met or not. Diagnostic, not a
    phase:

        python3 -c 'import chip_smoke as c; c.phase_setup();
                    c.app_route_witness()'
    """
    runs = ([(seeds[0], plain, fused) for fused in (True, False)
             for plain in (False, True)]
            + [(seed, plain, True) for seed in seeds[1:]
               for plain in (False, True)])
    with _route_pool(len(runs)) as pool:
        pending = {r: pool.submit(_app_route, r[1], r[2], device, size,
                                  n_sources, r[0]) for r in runs}
        res = {r: p.result()[0] for r, p in pending.items()}
    name = lambda plain, fused: (("twins" if plain else "kernels") + ", "
                                 + ("default" if fused else "host")
                                 + " classes")
    pairs = ([((seeds[0], False, f), (seeds[0], True, f)) for f in (True,
                                                                   False)]
             + [((seeds[0], p, True), (seeds[0], p, False))
                for p in (True, False)]
             + [((seed, False, True), (seed, True, True))
                for seed in seeds[1:]])
    for a, b in pairs:
        label = (f"witness seed {a[0]}: {name(*a[1:])} vs {name(*b[1:])}")
        flips, rel = _route_diff(label, res[a], res[b])
        met = flips == 0 and bool(np.all(rel > -SLICE_ELBO_TOL))
        print(f"{label}: {len(res[a])} sources, {flips} flips; ELBO rel "
              f"worst {rel.min():.3g}, best {rel.max():.3g}; phase 12's "
              f"bar {'met' if met else 'missed'}", flush=True)


# ---------------------------------------------------------------------------
# phases 15-16: the GalSim suite's CI subset and the farm worker
# ---------------------------------------------------------------------------

GALSIM_RADIUS = 40.0   # the reference's ACTIVE_PIXELS_MIN_RADIUS_PX
GALSIM_ARTIFACT = os.path.join("benchmark", "galsim_results.csv")


def phase_galsim(device="cuda", names=None, radius=GALSIM_RADIUS,
                 config=None, newton_config=None, bars=True):
    """The GalSim suite's CI subset (galsim.CI_CASES: five 96 x 96 px
    scenes, radius 40) through the port's runner (galsim_suite.run_suite:
    run_benchmarks, joint, f64), then the noise-free rerun of its noisy
    scenes. Prints each scene's estimates beside the JAX package's
    artifact row (benchmark/galsim_results.csv), the field scores, both
    gates, the wall and K1-K3's launches. Bars (bars=True): 0 noise-free
    violations, no star/galaxy misclassification, finite ELBOs, K1-K3
    launched. Returns the phase's launches."""
    import torch

    from celeste_jl_tpu_torch.benchmark import accuracy as ab
    from celeste_jl_tpu_torch.benchmark import galsim_suite
    from celeste_jl_tpu_torch.benchmark.galsim import CI_CASES

    names = list(names or CI_CASES)
    res = galsim_suite.run_suite(names, joint=True, radius=radius,
                                 device=device, dtype=torch.float64,
                                 config=config, newton_config=newton_config)
    elbos = res["pred_df"]["elbo"]
    ref = ab.read_csv(os.path.join(ROOT, GALSIM_ARTIFACT))
    ref_row = {o: i for i, o in enumerate(ref["objid"])}
    pred = res["pred_df"]
    cols = ("is_star", "flux_r_nmgy", "gal_axis_ratio", "gal_radius_px",
            "gal_angle_deg")
    for i, o in enumerate(res["truth_df"]["objid"]):
        j = ref_row.get(o)
        pairs = ", ".join(
            f"{c} {pred[c][i]:.10g}"
            + (f" (JAX {ref['est_' + c][j]:.10g})" if j is not None else "")
            for c in cols)
        print(f"phase 15: {o}: {pairs}", flush=True)
    scores = ", ".join(f"{f} {m:.6g} (N {n})" for f, n, m in zip(
        res["scores"]["field"], res["scores"]["N"], res["scores"]["first"]))
    print(f"phase 15: {len(names)} scenes, {len(res['truth_df'])} sources, "
          f"joint f64, radius {radius:g} px: {res['wall_s']:.3f} s "
          f"(noise-free rerun {res['nf_wall_s']:.3f} s); field scores: "
          f"{scores}; violations as defined {len(res['violations'])} "
          f"{[v[:2] for v in res['violations']]}, noise-free "
          f"{len(res['nf_violations'])} "
          f"{[v[:2] for v in res['nf_violations']]}; misclassified "
          f"{res['missed']}; launches {res['launches']}", flush=True)
    if bars:
        ok = (not res["nf_violations"] and not res["missed"]
              and len(elbos) > 0 and bool(np.all(np.isfinite(elbos))))
        if device == "cuda":
            ok = ok and all(n > 0 for n in res["launches"].values())
        check(ok, f"phase 15: noise-free violations "
              f"{res['nf_violations']}, misclassified {res['missed']}, "
              f"finite ELBOs {bool(np.all(np.isfinite(elbos)))}, launches "
              f"{res['launches']}")
    print("phase 15 ok", flush=True)
    return res["launches"]


def _worker(argv, device, label):
    """The farm worker CLI (celeste_jl_tpu_torch.worker) on argv: on the
    card a process of its own (python -m, as a user runs it), on the CPU
    main(argv, device="cpu") in this process. Returns its JSON summary."""
    import contextlib
    import io

    if device == "cuda":
        proc = subprocess.run(
            [sys.executable, "-m", "celeste_jl_tpu_torch.worker", *argv],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"{label}: the worker exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        out = proc.stdout
    else:
        from celeste_jl_tpu_torch import worker

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = worker.main(argv, device=device)
        check(rc == 0, f"{label}: the worker returned {rc}")
        out = buf.getvalue()
    return json.loads(out.strip().splitlines()[-1])


def phase_farm(field, device="cuda", grid=(2, 2), group=2, config=None,
               newton_config=None, bars=True):
    """The farm worker on phase 11's SDSS field (`field`, from
    phase_app(field=...)): the worker CLI's main on the card, f64, pipelined,
    over phase 11's box split grid[0] x grid[1] ways, group boxes a
    schedule, detection as phase 11's (thresh 6); then the same command
    again as a process of its own on the same workdir (the resume). Prints
    sources/s, each group's load, detect and infer seconds and K1-K3's
    launches (K3 also at D = 12, the PSF fits: each box's field-center
    fits and its per-source fits). Bars
    (bars=True): every box has its result file, each of phase 11's
    targets is saved in exactly one box and nothing else is, completeness
    >= 0.95 and type accuracy >= 0.90 over the union, 0 failures, finite
    ELBOs, the resume completes 0 boxes, K1-K3 and K3 at D = 12 launched.
    config and newton_config (defaults Config(), NewtonConfig()) shorten
    the schedule for a CPU rehearsal. Returns the first run's launches."""
    import contextlib
    import io

    from celeste_jl_tpu_torch import worker
    from celeste_jl_tpu_torch.io.dataset import BoundingBox
    from celeste_jl_tpu_torch.main import load_results
    from celeste_jl_tpu_torch.parallel import multinode as mn
    from celeste_jl_tpu_torch.utils import telemetry

    workdir = os.path.join(field["dir"], "farm")
    argv = ["--workdir", workdir, "--basedir", field["base"], "--box",
            ",".join(repr(float(v)) for v in field["box"]), "--grid",
            f"{grid[0]}x{grid[1]}", "--group-boxes", str(group),
            "--detect-thresh", "6"]
    telemetry.counters.reset()
    buf = io.StringIO()
    with KernelWidths() as rec, contextlib.redirect_stdout(buf):
        rc = worker.main(argv, device=device, config=config,
                         newton_config=newton_config)
    check(rc == 0, f"phase 16: the worker returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    psf_k3 = summary["tr_launches_by_dim"].get("12", 0)
    launches, failures = rec.launches(), telemetry.counters.failures
    again = _worker(argv, device, "phase 16 resume")

    boxes = mn.split_box(BoundingBox(*field["box"]), *grid)
    queue = mn.FileWorkQueue(workdir)
    results, per_box = [], []
    for b in boxes:
        res = load_results(queue._result_file(b)) if queue.done(b) else []
        per_box.append(len(res))
        results.extend(res)
    saved = [tuple(r.init_pos) for r in results]
    want = sorted(tuple(np.asarray(t.pos, np.float64))
                  for t in field["targets"])
    n_match, acc, _ = app_score(results, field["truth"], field["wcs"])
    completeness = n_match / len(field["truth"])
    elbos = np.array([r.elbo for r in results])
    wall = summary["wall_s"]
    groups = "; ".join(
        f"group {i}: {len(g['boxes'])} boxes, {g['sources']} sources, load "
        f"{g['load_s']:.3f} s, detect {g['detect_s']:.3f} s, infer "
        f"{g['infer_s']:.3f} s" for i, g in enumerate(summary["groups"]))
    print(f"phase 16: worker on phase 11's field, {len(boxes)} boxes "
          f"({grid[0]}x{grid[1]}), {group} a group, f64: "
          f"{summary['boxes_done']} boxes done in {wall:.3f} s, "
          f"{len(results)} sources ({per_box} a box), "
          f"{len(results) / wall:.3f} sources/s; {groups}; phase 11's "
          f"targets {len(want)}, saved once each "
          f"{sorted(saved) == want}; matched {n_match}, completeness "
          f"{completeness:.4f}, type accuracy {acc:.4f}; failures "
          f"{failures}; resume: {again['boxes_done']} boxes done, "
          f"{again['pending']} pending", flush=True)
    print(f"phase 16 kernels: {rec.summary()}; K3 at D = 12 (the PSF "
          f"fits) {psf_k3}", flush=True)
    if bars:
        ok = (all(queue.done(b) for b in boxes) and sorted(saved) == want
              and completeness >= FIELD_COMPLETENESS_BAR
              and acc >= FIELD_TYPE_BAR and failures == 0
              and bool(np.all(np.isfinite(elbos)))
              and again["boxes_done"] == 0 and again["pending"] == 0)
        if device == "cuda":
            ok = ok and psf_k3 > 0 and all(
                n > 0 for n in launches.values())
        check(ok, f"phase 16: boxes done {[queue.done(b) for b in boxes]}, "
              f"targets saved once each {sorted(saved) == want} "
              f"({len(saved)} saved, {len(want)} targets), completeness "
              f"{completeness:.4f}, type accuracy {acc:.4f}, failures "
              f"{failures}, finite ELBOs {bool(np.all(np.isfinite(elbos)))},"
              f" resume {again['boxes_done']} boxes, launches {launches}, "
              f"K3 at D = 12 {psf_k3}")
    print("phase 16 ok", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 17: the science runners and grad_mode="analytic"
# ---------------------------------------------------------------------------

class Launches:
    """Every kernel wrapper's launch count, set to 0 on entry; `counts()`
    reads them (the kernels of SOURCES, by name)."""

    def __enter__(self):
        from celeste_jl_tpu_torch.ops import eigh, refresh, render, tr

        self.fns = {"refresh": refresh.pixel_terms,
                    "jacobi_sweep": eigh.jacobi_sweep,
                    "tr_subproblem": tr.tr_subproblem,
                    "mixture_poisson_ll": render.mixture_poisson_ll,
                    "jacobi_sweep_a": eigh.jacobi_sweep_a,
                    "jacobi_replay_q": eigh.jacobi_replay_q}
        for fn in self.fns.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        pass

    def counts(self):
        return {k: fn.launches for k, fn in self.fns.items()}


def _check_launched(label, counts, names, device):
    if device == "cuda":
        check(all(counts[k] > 0 for k in names),
              f"{label}: a kernel of the path never launched: {counts}")


def experiment_stage(stage, device="cuda", **kw):
    """One stage of phase 17a, "vi" (the joint VI, K1-K3) or "mcmc" (the
    AIS, K4): experiments/mcmc_experiment.run(stage=stage, **kw), f32 on
    the card. Returns run's dict with the stage's launches. The two
    stages are independent (both start from the truth), so the route pool
    runs them in two processes."""
    import torch

    from celeste_jl_tpu_torch.experiments import mcmc_experiment as me

    dtype = torch.float32 if device == "cuda" else torch.float64
    with Launches() as rec:
        res = me.run(stage=stage, device=device, dtype=dtype, **kw)
    return dict(res, launches=rec.counts(), dtype=str(dtype)[6:])


def phase_experiment(device="cuda", parts=None, out=None, bars=True, **kw):
    """17a. The MCMC-vs-VI experiment at its full width (experiments/
    mcmc_experiment: 16 prior-drawn sources on 200 x 200 px, joint VI
    through K1-K3, AIS through K4 at Config()'s 50 temperatures x 10
    samples, f32): its two stages (experiment_stage; `parts`, their
    results when the route pool ran them, else run here one after the
    other), its files (write_outputs), then mcmc_figures' tables from the
    files. Prints each stage's seconds, the MCMC table's p(star), the
    error comparison, the AUCs and the calibration table. Bars: every file
    written, mc.csv one row a source with finite lnZs, finite VI ELBOs,
    K1-K3 and K4 launched, and within_2_sd >= within_1_sd >=
    within_half_sd in every row of both methods. kw: mcmc_experiment.run's
    (a shorter CPU rehearsal). Returns the launches."""
    import contextlib
    import io
    import shutil

    from celeste_jl_tpu_torch.experiments import mcmc_experiment as me
    from celeste_jl_tpu_torch.experiments import mcmc_figures

    vi, mc = parts or (experiment_stage("vi", device, **kw),
                       experiment_stage("mcmc", device, **kw))
    out = out or os.path.join(ROOT, "build", "mcmc_experiment")
    shutil.rmtree(out, ignore_errors=True)
    me.write_outputs(out, vi["catalog"], vi["vi"], mc["mc"], mc["chains"])
    launches = {k: vi["launches"][k] + mc["launches"][k]
                for k in vi["launches"]}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        figs = mcmc_figures.main(["--results-dir", out])
    mc_df, cal = mc["mc"], figs["calibration"]
    n_sources = len(vi["catalog"])
    print(f"phase 17a: experiment, {n_sources} sources, AIS "
          f"{mc['ladder'][0]} temperatures x {mc['ladder'][1]} samples, "
          f"{mc['dtype']}: render {vi['seconds']['render']:.3f} s, joint VI "
          f"{vi['seconds']['vi']:.3f} s, AIS {mc['seconds']['mcmc']:.3f} s; "
          "mc p(star) " + " ".join(f"{v:.3f}" for v in mc_df["is_star"])
          + f"; launches {launches}", flush=True)
    for line in buf.getvalue().splitlines():
        if line.startswith("matplotlib"):
            print("phase 17a: " + line, flush=True)
    print("phase 17a error comparison (VI first, MCMC second):\n"
          + figs["scores"].to_markdown(floatfmt=".6g"), flush=True)
    print(f"phase 17a: AUC {figs['auc']}; calibration:\n"
          + cal.to_markdown(floatfmt=".4f"), flush=True)
    if bars:
        names = ("truth.csv", "vi.csv", "mc.csv", "vi_posterior.csv",
                 "mc_samples.npz", "calibration.csv")
        missing = [n for n in names if not os.path.exists(
            os.path.join(out, n))]
        check(not missing, f"phase 17a: files not written: {missing}")
        finite = [bool(np.all(np.isfinite(mc_df[k])))
                  for k in ("star_lnZ", "gal_lnZ")]
        check(len(mc_df) == n_sources and all(finite),
              f"phase 17a: mc.csv {len(mc_df)} rows, finite lnZs {finite}")
        check(bool(np.all(np.isfinite(vi["vi_elbos"]))),
              "phase 17a: non-finite VI ELBOs")
        order = bool(np.all((cal["within_2_sd"] >= cal["within_1_sd"])
                            & (cal["within_1_sd"] >= cal["within_half_sd"])))
        check(order and set(cal["method"]) == {"vi", "mc"},
              "phase 17a: within_2_sd >= within_1_sd >= within_half_sd "
              "does not hold in every row")
        _check_launched("phase 17a", launches,
                        FIELD_KERNELS + ("mixture_poisson_ll",), device)
    shutil.rmtree(out, ignore_errors=True)
    print("phase 17a ok", flush=True)
    return launches


def phase_bench_elbo(device="cuda", n_sources=512, tile=32, repeats=2,
                     newton_config=None):
    """17b. benchmark/bench_elbo.py's runner at its defaults (512 sources
    on 32 x 32 tiles, f32; `repeats` timed calls a metric after the first,
    2 where the runner's default is 5: a single fit takes ~5 s): its JSON
    lines, every value finite. Returns (its lines, the launches)."""
    import contextlib
    import io

    import torch

    from celeste_jl_tpu_torch.benchmark import bench_elbo

    env = {"BENCH_ELBO_SOURCES": str(n_sources), "BENCH_ELBO_TILE": str(tile),
           "BENCH_ELBO_REPEATS": str(repeats)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with Launches() as rec, contextlib.redirect_stdout(buf):
            lines = bench_elbo.main(
                [], device=device,
                dtype=torch.float32 if device == "cuda" else torch.float64,
                newton_config=newton_config)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = rec.counts()
    for line in lines:
        print("phase 17b json: " + json.dumps(line), flush=True)
    check(all(np.isfinite(l["value"]) and l["value"] > 0 for l in lines),
          f"phase 17b: a value is not finite: {lines}")
    _check_launched("phase 17b", launches, ("refresh",), device)
    print(f"phase 17b ok: launches {launches}", flush=True)
    return lines, launches


def phase_analytic(device="cuda", n_sources=64, n_batch=1024, tile=32,
                   ad_fits_per_s=None, ad_f64=None):
    """17c. grad_mode="analytic" on the card. Phase 4's 64 sources fitted
    in f64 with bench.py's configuration, analytic against autograd: 0
    classification flips and no lane's ELBO further than 1e-6 relative
    (tests/test_analytic_grad.py:77); ad_f64, phase 4's fit of the same
    sources through the kernels, is the autograd side when given. Then the
    1024-source batch of phase 3 in f32 with the analytic mode: its fits/s
    beside phase 3's (ad_fits_per_s, the autograd route's from this call),
    accuracy and launches. Returns the f32 run's launches."""
    import torch

    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources_compacted

    cfg = bench_config()
    an_cfg = cfg._replace(grad_mode="analytic")
    _, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile, seed=1,
                                             dtype=np.float64, device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    ad = (ad_f64 if ad_f64 is not None
          else fit_sources_compacted(vp0, patches, config=cfg))
    an = fit_sources_compacted(vp0, patches, config=an_cfg)
    flips = int(np.sum((ad.vp[:, 26].cpu().numpy() > 0.5)
                       != (an.vp[:, 26].cpu().numpy() > 0.5)))
    ea, en = ad.elbo.cpu().numpy(), an.elbo.cpu().numpy()
    rel = np.abs(en - ea) / np.abs(ea)
    msg = (f"phase 17c: {n_sources} sources f64, analytic vs autograd: "
           f"{flips} flips, ELBO rel worst {rel.max():.3g}, mean "
           f"{rel.mean():.3g}; mean iters "
           f"{float(an.iters.double().mean()):.2f} vs "
           f"{float(ad.iters.double().mean()):.2f}")
    check(flips == 0 and bool(np.all(rel <= ANALYTIC_ELBO_TOL)),
          msg + f" (bars: 0 flips, worst <= {ANALYTIC_ELBO_TOL:g})")
    print(msg, flush=True)

    catalog, vp0s, patches = synthetic_patch_batch(n_batch, tile=tile, seed=1,
                                                   device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    with Launches() as rec:
        t0 = time.perf_counter()
        res = fit_sources_compacted(vp0, patches, config=an_cfg)
        elbo = res.elbo.cpu().numpy()
        wall = time.perf_counter() - t0
    launches = rec.counts()
    truth = np.array([ce.is_star for ce in catalog])
    acc = float(np.mean((res.vp[:, 26].cpu().numpy() > 0.5) == truth))
    check(bool(np.all(np.isfinite(elbo))),
          f"phase 17c: {int(np.sum(~np.isfinite(elbo)))} non-finite ELBOs")
    _check_launched("phase 17c", launches, FIELD_KERNELS, device)
    ad_txt = (f"{ad_fits_per_s:.2f}" if ad_fits_per_s is not None
              else "not run")
    print(f"phase 17c: {n_batch} sources f32 with grad_mode='analytic' in "
          f"{wall:.3f} s = {n_batch / wall:.2f} fits/s (autograd, phase 3: "
          f"{ad_txt} fits/s); mean iters "
          f"{float(res.iters.double().mean()):.2f}; converged {float(res.converged.double().mean()):.4f}; "
          f"star/galaxy accuracy {acc:.4f}; launches {launches}", flush=True)
    print("phase 17c ok", flush=True)
    return launches


def phase_results_to_fits(field, device="cuda"):
    """17d. results_to_fits over phase 16's result files (field: phase
    11's, with the farm's workdir): one FITS row a saved target."""
    import glob

    from celeste_jl_tpu_torch.io.fits import open_fits
    from celeste_jl_tpu_torch.main import load_results
    from celeste_jl_tpu_torch.results_to_fits import results_to_fits

    files = sorted(glob.glob(os.path.join(field["dir"], "farm", "**",
                                          "celeste-*.npz"), recursive=True))
    check(bool(files), "phase 17d: no result files of phase 16")
    out = os.path.join(field["dir"], "catalog.fits")
    n = results_to_fits(files, out)
    saved = sum(sum(not r.is_sky_bad for r in load_results(f))
                for f in files)
    data = open_fits(out)[1].data
    check(n == saved == len(data["ra"]) == len(field["targets"]),
          f"phase 17d: {n} rows written, {saved} saved targets, "
          f"{len(data['ra'])} rows read, {len(field['targets'])} targets")
    print(f"phase 17d ok: {len(files)} result files -> {n} FITS rows, "
          f"{len(data)} columns", flush=True)


def phase_calibration(device="cuda", names=None, newton_config=None):
    """17e. benchmark/calibration.py's runner on galsim.CI_CASES at one
    seed (noise on every scene, joint, f64): its tables and JSON line.
    Returns the launches."""
    import contextlib
    import io

    from celeste_jl_tpu_torch.benchmark import calibration
    from celeste_jl_tpu_torch.benchmark.galsim import CI_CASES

    old = os.environ.get("CAL_SEEDS")
    os.environ["CAL_SEEDS"] = "1"
    buf = io.StringIO()
    try:
        with Launches() as rec, contextlib.redirect_stdout(buf):
            record = calibration.main(
                ["--scenes", ",".join(names or CI_CASES)], device=device,
                newton_config=newton_config)
    finally:
        if old is None:
            os.environ.pop("CAL_SEEDS")
        else:
            os.environ["CAL_SEEDS"] = old
    launches = rec.counts()
    cal = record["calibration"]
    print(f"phase 17e: calibration, {record['scenes']} scenes x 1 seed, "
          f"{sum(record['sources'])} sources, {record['wall_s']:.3f} s: "
          + "; ".join(f"{r['field']} {r['within_half_sd']:.3f} / "
                      f"{r['within_1_sd']:.3f} / {r['within_2_sd']:.3f}"
                      for r in cal) + f"; launches {launches}", flush=True)
    check(bool(cal) and all(np.isfinite(r["within_2_sd"]) for r in cal),
          f"phase 17e: calibration table {cal}")
    _check_launched("phase 17e", launches, FIELD_KERNELS, device)
    print("phase 17e ok", flush=True)
    return launches


def phase_svi_compare(device="cuda", n_sources=32, size=256, steps=500,
                      newton_config=None):
    """17f. benchmark/svi_compare.py's runner at 32 sources on 256 px, one
    pass: its JSON rows (single_vi through K1-K3, svi at pixel fractions
    1.0, 0.5, 0.25), finite ELBOs. Returns the launches."""
    import contextlib
    import io

    import torch

    from celeste_jl_tpu_torch.benchmark import svi_compare

    env = {"SVI_SOURCES": str(n_sources), "SVI_SIZE": str(size),
           "SVI_STEPS": str(steps), "SVI_REPEAT": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with Launches() as rec, contextlib.redirect_stdout(buf):
            rows = svi_compare.main(
                [], device=device,
                dtype=torch.float32 if device == "cuda" else torch.float64,
                newton_config=newton_config)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = rec.counts()
    for r in rows:
        print("phase 17f json: " + json.dumps(r), flush=True)
    check(len(rows) == 4 and all(np.isfinite(r["mean_elbo"]) for r in rows),
          f"phase 17f: rows {rows}")
    _check_launched("phase 17f", launches, FIELD_KERNELS, device)
    print("phase 17f ok", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 18: the sharded fit and the distributed worker, a pod of two ranks
# ---------------------------------------------------------------------------

POD_RANKS = 2
POD_MESHES = ((1, 2), (2, 1))   # (n_src, n_pix): pixel-, source-sharded
POD_ELBO_TOL = 1e-6
POD_TIMEOUT_S = 400.0
POD_JOINT_TOTAL_TOL = 1e-5   # 18c: the field's total ELBO, relative
POD_JOINT_SOURCE_REPORT = 1e-4
# 18c's field: phase 9's density (128 sources on 512 x 512 px) at half
# its sources; its schedule (Config()'s keywords) one warm sweep and one
# polish sweep, every stage still run, to keep the script inside its time
# limit (a rank took 42 s at Config(), 31 s so on the H100)
POD_JOINT_SOURCES, POD_JOINT_SIZE = 64, 362
POD_JOINT_CONFIG = dict(num_joint_vi_iters=1, polish_sweeps=1)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pod_rank(vp0s, patches, config, meshes, worker_argv, worker_config,
             device, joint=None):
    """One rank of phase 18's pod (parallel/mesh.spawn_pod), f64: (a)
    fit_sources_sharded of vp0s / patches (numpy; to the rank's device)
    over each (n_src, n_pix) mesh of `meshes` with `config`; (b) with
    worker_argv, the worker CLI's main with --distributed (newton_config
    worker_config); (c) with `joint` (pod_joint_kwargs'), the joint
    schedule's one_node_joint_infer on a (POD_RANKS, 1) mesh. Returns
    (every rank gets it; spawn_pod hands back rank 0's) each mesh's whole
    fit with every rank's free vectors, wall and K1-K3 launches, every
    rank's worker summary line, and every rank's joint results, wall and
    K1-K3 launches."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from celeste_jl_tpu_torch import worker
    from celeste_jl_tpu_torch.models.patches import SkyPatch
    from celeste_jl_tpu_torch.parallel.mesh import (fit_sources_sharded,
                                                    make_mesh)
    from celeste_jl_tpu_torch.parallel.run import one_node_joint_infer

    torch.set_num_threads(1)
    dev = torch.device(device)
    vp = torch.as_tensor(vp0s, device=dev)
    p = SkyPatch(*(torch.as_tensor(a, device=dev) for a in patches))
    world = dist.get_world_size()
    fits = []
    for shape in meshes:
        mesh = make_mesh(*shape)
        with Launches() as launches:
            _sync(dev)
            t0 = time.perf_counter()
            res = fit_sources_sharded(vp, p, mesh, config=config)
            _sync(dev)
            mine = dict(free=res.free.cpu().numpy(),
                        wall=time.perf_counter() - t0,
                        launches={k: launches.counts()[k]
                                  for k in FIELD_KERNELS})
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        fits.append(dict(mesh=shape, vp=res.vp.cpu().numpy(),
                         elbo=res.elbo.cpu().numpy(),
                         converged=res.converged.cpu().numpy(), ranks=ranks))
    summaries = None
    if worker_argv is not None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = worker.main(worker_argv + ["--distributed"], device=device,
                             newton_config=worker_config)
        if rc != 0:
            raise RuntimeError(f"the distributed worker returned {rc}")
        summaries = [None] * world
        dist.all_gather_object(
            summaries, json.loads(buf.getvalue().strip().splitlines()[-1]))
    joint_ranks = None
    if joint is not None:
        mesh = make_mesh(POD_RANKS, 1)
        with Launches() as launches:
            _sync(dev)
            t0 = time.perf_counter()
            res = one_node_joint_infer(mesh=mesh, device=device,
                                       dtype=torch.float64, **joint)
            _sync(dev)
            mine = dict(_joint_arrays(res), wall=time.perf_counter() - t0,
                        launches={k: launches.counts()[k]
                                  for k in FIELD_KERNELS})
        joint_ranks = [None] * world
        dist.all_gather_object(joint_ranks, mine)
    return dict(fits=fits, worker=summaries, joint=joint_ranks)


def _joint_arrays(results):
    """A joint run's results as arrays: vs (S, 44), elbo, converged."""
    return dict(vs=np.stack([r.vs for r in results]),
                elbo=np.array([r.elbo for r in results]),
                converged=np.array([r.converged for r in results]))


def pod_joint_kwargs(device="cuda", n_sources=POD_JOINT_SOURCES,
                     size=POD_JOINT_SIZE, config=None, newton_config=None):
    """Phase 18c's one_node_joint_infer arguments: field_scene(n_sources,
    size, 7) drawn on `device` and detected as phase 9 detects, its
    catalog, images and active boxes (host arrays, so that they pickle to
    the ranks), Config(**POD_JOINT_CONFIG); config and newton_config
    shorten the schedule for a CPU rehearsal."""
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel.run import detect_sources
    from celeste_jl_tpu_torch.parallel.state import detection_active_boxes
    from celeste_jl_tpu_torch.utils.config import Config

    images, _ = field_scene(n_sources, size, 7, device)
    catalog, det_boxes = detect_sources(images, thresh=6.0,
                                        boxsize=(size, size),
                                        match_radius_deg=1.0)
    print(f"phase 18c: field {n_sources} sources, {size}x{size} px, seed 7, "
          f"{len(catalog)} detected", flush=True)
    return dict(catalog=catalog, images=images,
                active_boxes=detection_active_boxes(catalog, det_boxes,
                                                    images),
                config=config or Config(**POD_JOINT_CONFIG),
                newton_config=newton_config or NewtonConfig())


def _pod_joint_check(ranks, ref, ref_wall, cuda):
    """Phase 18c's line and bars: every rank's joint results (pod_rank's)
    against the one-process schedule's arrays `ref`. Returns (message,
    ok)."""
    from celeste_jl_tpu_torch.models.params import ids

    got = ranks[0]
    equal = all(np.array_equal(r[k], got[k]) for r in ranks
                for k in ("vs", "elbo", "converged"))
    star = ids.is_star[0]
    flips = int(np.sum((got["vs"][:, star] > 0.5)
                       != (ref["vs"][:, star] > 0.5)))
    total = abs(got["elbo"].sum() - ref["elbo"].sum()) / abs(
        ref["elbo"].sum())
    rel = np.abs(got["elbo"] - ref["elbo"]) / np.abs(ref["elbo"])
    same_conv = bool(np.array_equal(got["converged"], ref["converged"]))
    launched = all(all(n > 0 for n in r["launches"].values())
                   for r in ranks)
    msg = (f"phase 18c: one_node_joint_infer on a ({POD_RANKS}, 1) mesh "
           f"over its field, {len(ref['elbo'])} sources, f64, against "
           f"the one-process schedule: ranks' results bit for bit equal "
           f"{equal}; {flips} flips; total ELBO rel {total:.3g} (bar "
           f"{POD_JOINT_TOTAL_TOL:g}); per source worst rel {rel.max():.3g}"
           f", {int(np.sum(rel > POD_JOINT_SOURCE_REPORT))} over "
           f"{POD_JOINT_SOURCE_REPORT:g} (printed, not held); converged "
           f"flags equal {same_conv}; walls by rank "
           f"{[round(r['wall'], 3) for r in ranks]} s, one process "
           f"{ref_wall:.3f} s; K1-K3 launches by rank "
           f"{[r['launches'] for r in ranks]}")
    ok = (equal and flips == 0 and total <= POD_JOINT_TOTAL_TOL
          and (launched or not cuda))
    return msg, bool(ok)


def _pod_mesh_check(fit, ref, e_at_vp, ref_label, elbo_tol, n_sources, tile,
                    cuda):
    """One mesh's lines and bars of phase 18a: `fit` (pod_rank's, by rank)
    against `ref` (a one-process FitResult of the same lanes), with
    e_at_vp the full tiles' ELBO at the pod's parameters (or None).
    Returns (message, ok)."""
    n_src, n_pix = fit["mesh"]
    e1 = ref.elbo.cpu().numpy()
    flips = int(np.sum((fit["vp"][:, 26] > 0.5)
                       != (ref.vp[:, 26].cpu().numpy() > 0.5)))
    rel = np.abs(fit["elbo"] - e1) / np.abs(e1)
    same_conv = bool(np.array_equal(fit["converged"],
                                    ref.converged.cpu().numpy()))
    ranks = fit["ranks"]
    equal = all(np.array_equal(r["free"], ranks[0]["free"]) for r in ranks)
    launched = all(all(n > 0 for n in r["launches"].values()) for r in ranks)
    msg = (f"phase 18a: {n_sources} sources {tile}x{tile} f64 on a "
           f"({n_src}, {n_pix}) mesh ({POD_RANKS} ranks) against {ref_label}"
           f": {flips} flips, converged flags equal {same_conv}, ELBO rel "
           f"worst {rel.max():.3g} (bar {elbo_tol:g}; bit for bit "
           f"{bool(np.array_equal(fit['elbo'], e1))})")
    ok = flips == 0 and same_conv and bool(np.all(rel <= elbo_tol))
    if e_at_vp is not None:
        exact = np.abs(fit["elbo"] - e_at_vp) / np.abs(e_at_vp)
        msg += (f"; its ELBO against the whole tiles' ELBO at its parameters"
                f" rel worst {exact.max():.3g} (bar {POD_ELBO_TOL:g})")
        ok = ok and bool(np.all(exact <= POD_ELBO_TOL))
    msg += (f"; ranks' free vectors bit for bit equal {equal}; walls "
            f"{[round(r['wall'], 3) for r in ranks]} s; K1-K3 launches by "
            f"rank {[r['launches'] for r in ranks]}")
    ok = ok and (equal or n_pix == 1) and (launched or not cuda)
    return msg, ok


def phase_pod(field=None, device="cuda", n_sources=64, tile=32,
              meshes=POD_MESHES, config=None, joint=None):
    """18. A pod of two ranks (parallel/mesh.spawn_pod, Gloo: on one card
    the two processes share it), f64:
    (a) phase 4's sources (synthetic_patch_batch(n_sources, tile, seed
    1)) fitted by fit_sources_sharded on each mesh of `meshes` with
    run.card_newton_config (K1-K3; config overrides it, the worker's
    too). A (1, 2) mesh splits each source's tile rows over the ranks: it
    is held to the one-process fit of the batch (0 flips, the same
    converged flags, no ELBO further than 1e-4 relative: the order of the
    (f, g, H) sums differs, and the Newton trajectories carry that to
    ~1e-5, as phase 4's kernels against twins) and its ELBOs to the
    whole tiles' ELBO at its parameters (1e-6); its ranks' free vectors
    must be equal bit for bit. A (2, 1) mesh splits the sources: each
    rank's block is held to the one-process fit of that block (0 flips,
    the same converged flags, ELBO within 1e-6; the Jacobi sweeps stop on
    the whole batch's test, so a lane's fit depends on its batch). Each
    rank's K1-K3 launched. The one-process fits run here while the pod
    runs;
    (b) with `field` (phase 11's, from phase_app(field=...)): the worker
    CLI's main with --distributed on both ranks over phase 11's files,
    its box split 2 x 1, detection as phase 11's. Bars: every box saved,
    each of phase 11's targets saved once, at its catalog position,
    finite ELBOs, each rank's K1-K3 launched;
    (c) with `joint` (pod_joint_kwargs' field): the joint
    schedule, one_node_joint_infer(mesh=) on a (2, 1) mesh, each class
    step's and wide pass's fit split over the ranks, against the same
    call at mesh=None run here beside the pod (_pod_joint_check's bars).
    Prints each mesh's walls and launches by rank and the pod's
    sources/s. Returns the pod's launches (both ranks, (a), (b) and (c))
    by kernel."""
    import concurrent.futures
    import shutil

    import torch

    from celeste_jl_tpu_torch.io.dataset import BoundingBox
    from celeste_jl_tpu_torch.main import load_results
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel import multinode as mn
    from celeste_jl_tpu_torch.parallel.mesh import spawn_pod
    from celeste_jl_tpu_torch.parallel.run import (card_newton_config,
                                                   one_node_joint_infer)
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.elbo import elbo
    from celeste_jl_tpu_torch.vi.optimize import FitResult, fit_sources

    cfg = config or card_newton_config(NewtonConfig(), torch.float64)
    _, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile, seed=1,
                                             dtype=np.float64, device=device)
    vp = torch.as_tensor(vp0s, device=device)
    argv = workdir = None
    if field is not None:
        workdir = os.path.join(field["dir"], "pod")
        shutil.rmtree(workdir, ignore_errors=True)
        argv = ["--workdir", workdir, "--basedir", field["base"], "--box",
                ",".join(repr(float(v)) for v in field["box"]), "--grid",
                "2x1", "--detect-thresh", "6"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        pending = ex.submit(
            spawn_pod, POD_RANKS, pod_rank, vp0s,
            tuple(t.cpu().numpy() for t in patches), cfg, meshes, argv,
            config, device, joint, device=device, timeout_s=POD_TIMEOUT_S)
        whole = fit_sources(vp, patches, config=cfg)
        refs = {}
        for n_src, _ in meshes:
            block = -(-n_sources // n_src)
            parts = [fit_sources(vp[i:i + block],
                                 patches.index(slice(i, i + block)),
                                 config=cfg)
                     for i in range(0, n_sources, block)]
            refs[n_src] = FitResult(*(torch.cat(f) for f in zip(*parts)))
        if joint is not None:
            _sync(torch.device(device))
            t1 = time.perf_counter()
            joint_ref = _joint_arrays(one_node_joint_infer(
                device=device, dtype=torch.float64, **joint))
            _sync(torch.device(device))
            joint_wall = time.perf_counter() - t1
        out = pending.result()
    pod_wall = time.perf_counter() - t0
    cuda = device == "cuda"
    total = {k: 0 for k in SOURCES}
    failed = []
    for fit in out["fits"]:
        for r in fit["ranks"]:
            for k, n in r["launches"].items():
                total[k] += n
        n_src, n_pix = fit["mesh"]
        if n_pix > 1:
            at_vp = elbo(torch.as_tensor(fit["vp"], device=device),
                         patches).cpu().numpy()
            msg, ok = _pod_mesh_check(fit, whole, at_vp,
                                      "the one-process fit",
                                      SLICE_ELBO_TOL, n_sources, tile, cuda)
        else:
            msg, ok = _pod_mesh_check(fit, refs[n_src], None,
                                      f"one process's fits of its "
                                      f"{n_src} blocks", POD_ELBO_TOL,
                                      n_sources, tile, cuda)
        print(msg, flush=True)
        if not ok:
            failed.append(msg)
    if field is not None:
        summaries = out["worker"]
        boxes = mn.split_box(BoundingBox(*field["box"]), 2, 1)
        queue = mn.FileWorkQueue(workdir)
        results = [r for b in boxes if queue.done(b)
                   for r in load_results(queue._result_file(b))]
        saved = sorted(tuple(r.init_pos) for r in results)
        want = sorted(tuple(np.asarray(t.pos, np.float64))
                      for t in field["targets"])
        finite = bool(np.all(np.isfinite([r.elbo for r in results])))
        by_rank = [s["kernel_launches"] for s in summaries]
        for launches in by_rank:
            for k, n in launches.items():
                total[k] += n
        wall = summaries[0]["wall_s"]
        msg = (f"phase 18b: the worker --distributed on {POD_RANKS} ranks "
               f"over phase 11's field, 2 x 1 boxes: "
               f"{summaries[0]['boxes_done']} boxes done in {wall:.3f} s, "
               f"{len(results)} sources, {len(results) / wall:.3f} "
               f"sources/s; phase 11's targets {len(want)}, saved once each "
               f"at the catalog position {saved == want}; finite ELBOs "
               f"{finite}; K1-K3 launches by rank {by_rank}; K3 at D = 12 "
               f"by rank "
               f"{[s['tr_launches_by_dim'].get('12', 0) for s in summaries]}")
        print(msg, flush=True)
        ok = (all(queue.done(b) for b in boxes) and saved == want and finite
              and all(s["world_size"] == POD_RANKS for s in summaries))
        if cuda:
            ok = ok and all(n > 0 for launches in by_rank
                            for n in launches.values())
        if not ok:
            failed.append(msg)
    if joint is not None:
        for r in out["joint"]:
            for k, n in r["launches"].items():
                total[k] += n
        msg, ok = _pod_joint_check(out["joint"], joint_ref, joint_wall, cuda)
        print(msg, flush=True)
        if not ok:
            failed.append(msg)
    print(f"phase 18: pod wall {pod_wall:.1f} s (spawn, every part, exit; "
          f"the one-process runs beside it)", flush=True)
    check(not failed, "; ".join(failed))
    print("phase 18 ok", flush=True)
    return total


SOURCES = {
    "refresh": ("celeste_jl_tpu_torch/csrc/refresh.cu",
                "celeste_jl_tpu/ops/pallas_refresh.py:186"),
    "jacobi_sweep": ("celeste_jl_tpu_torch/csrc/jacobi_sweep.cu",
                     "celeste_jl_tpu/ops/pallas_eigh.py:220"),
    "tr_subproblem": ("celeste_jl_tpu_torch/csrc/tr_subproblem.cu",
                      "celeste_jl_tpu/ops/pallas_tr.py:36"),
    "mixture_poisson_ll": ("celeste_jl_tpu_torch/csrc/render.cu",
                           "celeste_jl_tpu/ops/pallas_render.py:29"),
    "jacobi_sweep_a": ("celeste_jl_tpu_torch/csrc/jacobi_sweep_split.cu",
                       "celeste_jl_tpu/ops/pallas_eigh.py:164"),
    "jacobi_replay_q": ("celeste_jl_tpu_torch/csrc/jacobi_sweep_split.cu",
                        "celeste_jl_tpu/ops/pallas_eigh.py:202"),
}


def main():
    sys.path.insert(0, ROOT)
    import shutil

    import torch
    app_field = {}
    try:
        t0 = time.perf_counter()
        phase_setup()
        _phase_clock(1, t0)
        t0 = time.perf_counter()
        rec = phase_kernels()
        _phase_clock(2, t0)
        t0 = time.perf_counter()
        launches, ad_fits_per_s = phase_slice(rec=rec)
        _phase_clock(3, t0)
        t0 = time.perf_counter()
        ad_f64 = phase_compare()
        _phase_clock(4, t0)
        t0 = time.perf_counter()
        scene = mcmc_scene("cuda")
        rec.update(phase_new_kernels(scene))
        _phase_clock(5, t0)
        t0 = time.perf_counter()
        launches.update(phase_mcmc(scene))
        _phase_clock(6, t0)
        t0 = time.perf_counter()
        launches.update(phase_split_fit())
        _phase_clock(8, t0)
        t0 = time.perf_counter()
        field = phase_field(rec=rec)
        _phase_clock(9, t0)
        t0 = time.perf_counter()
        app = phase_app(rec=rec, field=app_field)
        _phase_clock(11, t0)
        t0 = time.perf_counter()
        multi = phase_multifield()
        _phase_clock(13, t0)
        t0 = time.perf_counter()
        pool = phase_routes(galsim={}, farm={"field": app_field,
                                             "grid": (2, 1)},
                            experiment={}, runners={}, mcmc={}, app={})
        galsim, farm = pool.pop("galsim"), pool.pop("farm")
        _phase_clock("7, 10, 12, 14, 15, 16, 17a, 17e and 17f", t0)
        t0 = time.perf_counter()
        science = dict(pool, bench_elbo=phase_bench_elbo()[1])
        _phase_clock("17b", t0)
        t0 = time.perf_counter()
        science["analytic"] = phase_analytic(ad_fits_per_s=ad_fits_per_s,
                                             ad_f64=ad_f64)
        _phase_clock("17c", t0)
        t0 = time.perf_counter()
        phase_results_to_fits(app_field)
        _phase_clock("17d", t0)
        t0 = time.perf_counter()
        pod = phase_pod(app_field, joint=pod_joint_kwargs())
        _phase_clock(18, t0)
    except PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    finally:
        if app_field:
            shutil.rmtree(app_field["dir"], ignore_errors=True)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0],
             replaces=SOURCES[k][1], launches=launches[k],
             field_launches=field.get(k, 0), app_launches=app.get(k, 0),
             multifield_launches=multi.get(k, 0),
             galsim_launches=galsim.get(k, 0), farm_launches=farm.get(k, 0),
             pod_launches=pod.get(k, 0),
             **{f"{path}_launches": n.get(k, 0)
                for path, n in science.items()},
             **rec[k])
        for k in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
