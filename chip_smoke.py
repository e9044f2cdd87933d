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
     least 7 of 8 sources;
  8. the fit of phase 4 with the split sweep (NewtonConfig.eigh_fused =
     False) against the fused one, f64, 256 sources: no flip, the same
     iterations per lane, ELBOs within 1e-9 relative;
  9. one sky box end to end: benchmark/run_field.py's field of record (512
     sources on 1024 x 1024 px, seed 7) drawn on the card, then
     infer_box(joint_vi): detection (native labelling) and the host-driven
     joint schedule through K1-K3, f32, scored as run_field.py scores it;
     then single_vi on the same images and detections. Prints detect and
     infer seconds, sources/s, completeness, type accuracy, median r-flux
     error, the fit launches by lane width and K1-K3's launches by width,
     and times K1-K3 at the joint run's median fit-launch width. Bars:
     every ELBO finite, no failure, K1-K3 each launched, native detection
     built, completeness >= 0.95 and (joint_vi) type accuracy >= 0.90;
 10. the joint field path through the kernels and through the plain twins
     (infer_box(plain=True)), f64, 32 sources on 256 x 256 px (phase 9's
     density): 0 classification flips, no source's ELBO worse than 1e-4
     relative; each departure printed.
Each phase prints its wall time. The line before the last is the kernels'
JSON record (each kernel's launches counted on its path: phase 3 for K1-K3,
6 for K4, 8 for K2a/K2b, and `field_launches` on phase 9's joint run; its
bound from this run's shapes at the H100's published f32 and memory
peaks); the last line is {"ok": true, "device": {...}}. Imports nothing of
JAX.
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

# published peaks of one H100 SXM (NVIDIA's datasheet): float32
# outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
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


def bound(flops, nbytes):
    """The least time the card could take for `flops` f32 operations and
    `nbytes` of device memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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
    at B = 1 (`floor_ms`: their chains of dependent steps alone)."""
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
    return launches


def phase_compare(device="cuda", n_sources=64, tile=32):
    """The same sources fitted through the kernels and through the plain
    twins. The bar is held in f64: in f32 a lane's final ELBO carries
    rounding noise of ~1e-4 relative on 32x32 tiles, so either f32 route
    lands within that noise of the other and near-tie star/galaxy lanes
    may swap; the f32 comparison is printed beside it."""
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
    """benchmark/run_field.py's field: n_sources from default_rng(seed),
    the first half stars (r-flux lognormal(3.0, 0.6)), the rest galaxies
    (lognormal(3.2, 0.5), radius lognormal(0.7, 0.3) px, axis ratio
    0.25-0.9, any angle), 16 px from the edges of a size x size 5-band
    image (sky 0.05 nMgy, 800 e-/nMgy), drawn by gen_images_fast on
    `device`. Returns (images, truth)."""
    from celeste_jl_tpu_torch.synthetic import (gen_images_fast,
                                                make_blank_images,
                                                sample_galaxy, sample_star)

    margin = 16.0
    rng = np.random.default_rng(seed)
    truth = []
    pos = margin + rng.random((n_sources, 2)) * (size - 2 * margin)
    for i in range(n_sources):
        p = tuple(pos[i])
        if i < n_sources // 2:
            truth.append(sample_star(pos=p, r_flux=float(
                np.exp(rng.normal(3.0, 0.6)))))
        else:
            truth.append(sample_galaxy(
                pos=p, r_flux=float(np.exp(rng.normal(3.2, 0.5))),
                gal_radius_px=float(np.exp(rng.normal(0.7, 0.3))),
                gal_axis_ratio=float(rng.uniform(0.25, 0.9)),
                gal_angle=float(rng.uniform(0.0, np.pi))))
    images = make_blank_images(H=size, W=size, sky_nmgy=0.05,
                               nelec_per_nmgy=800.0)
    gen_images_fast(images, truth, seed=seed, device=device)
    return images, truth


def field_score(results, truth):
    """benchmark/run_field.py's score(): results matched to the truth
    within 2 px (identity WCS), type accuracy over the matched, and the
    r-flux relative errors of the matched under the fitted type. Returns
    (matched, type accuracy, errors)."""
    from scipy.spatial import cKDTree

    from celeste_jl_tpu_torch.models.params import ids

    if not results:
        return 0, 0.0, []
    tpos = np.array([t.pos for t in truth])
    rpos = np.array([r.init_pos for r in results])
    dist, nearest = cKDTree(tpos).query(rpos, k=1)
    matched = dist < 2.0
    type_ok, errs = 0, []
    for r, t_i, m in zip(results, nearest, matched):
        if not m:
            continue
        t = truth[t_i]
        p_star = r.vs[ids.is_star[0]]
        type_ok += int((p_star > 0.5) == t.is_star)
        tf = (t.star_fluxes if t.is_star else t.gal_fluxes)[2]
        j = 0 if p_star > 0.5 else 1
        f = float(np.exp(r.vs[ids.flux_loc[j]]
                         + 0.5 * r.vs[ids.flux_scale[j]]))
        errs.append(abs(f - tf) / tf)
    n_match = int(matched.sum())
    return n_match, type_ok / max(n_match, 1), errs


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


def phase_field(device="cuda", n_sources=512, size=1024, seed=7, rec=None,
                config=None, single_newton=None, bars=True):
    """benchmark/run_field.py's field at its size of record through the
    port's infer_box (detection, then joint_vi's host-driven schedule),
    f32, scored as run_field.py scores it; then single_vi on the same
    images, detected catalog and footprints. With `rec`, K1-K3 are timed
    at the joint run's median fit-launch width. config (default Config())
    and single_newton (the single_vi run's NewtonConfig, default
    NewtonConfig()) shorten the schedule for a CPU rehearsal, bars=False
    skips the quality bars there. Returns the joint run's launches."""
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
              newton_config=single_newton or NewtonConfig())
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


def refresh_kernel_at(n_sources, tile, device="cuda"):
    """K1 at n_sources lanes (5 rows each) on tile x tile, f32, timed."""
    import torch

    from celeste_jl_tpu_torch.ops import refresh

    rows, ks, pdims = refresh_rows(n_sources, tile, device, torch.float32)
    time_fn = ((lambda fn, spin=False: timed_ms(fn, torch, spin=spin))
               if device == "cuda" else (lambda fn, spin=False: float("nan")))
    kernel = lambda: refresh.pixel_terms(*rows, ks=ks, pdims=pdims)
    G, C = rows[2].shape
    N = rows[6].shape[-1]
    nbytes = 4 * (G * C * 42 + G * 6 + 5 * G * N + G * C * 15 + G * 72)
    return dict(B=G, ms=time_fn(kernel), device_ms=time_fn(kernel, spin=True),
                **bound(float(rows[7].sum()) * (60 * C + 400), nbytes))


def phase_field_routes(device="cuda", n_sources=32, size=256, seed=7,
                       config=None):
    """The field path through the kernels and through their plain twins
    (infer_box(plain=True)), f64, on run_field.py's density: phase 4's bar
    (0 classification flips, no source's ELBO worse than 1e-4 relative),
    each departure printed."""
    import torch

    from celeste_jl_tpu_torch.models.params import ids
    from celeste_jl_tpu_torch.parallel.run import infer_box
    from celeste_jl_tpu_torch.utils.config import Config

    images, _ = field_scene(n_sources, size, seed, device)
    kw = dict(method="joint_vi", config=config or Config(), device=device,
              dtype=torch.float64, thresh=6.0, boxsize=(size, size),
              match_radius_deg=1.0)
    t0 = time.perf_counter()
    with KernelWidths() as rk_rec:
        rk = infer_box(images, **kw)
    t1 = time.perf_counter()
    rp = infer_box(images, plain=True, **kw)
    t2 = time.perf_counter()
    check(len(rk) == len(rp) > 0 and all(
        np.array_equal(a.init_pos, b.init_pos) for a, b in zip(rk, rp)),
        "phase 10: the two routes detected different catalogs")
    star_k = np.array([r.vs[ids.is_star[0]] > 0.5 for r in rk])
    star_p = np.array([r.vs[ids.is_star[0]] > 0.5 for r in rp])
    ek = np.array([r.elbo for r in rk])
    ep = np.array([r.elbo for r in rp])
    rel = (ek - ep) / np.abs(ep)
    for i in np.nonzero((star_k != star_p) | (rel != 0.0))[0]:
        print(f"phase 10: source {i} at {rk[i].init_pos}: star {star_k[i]} "
              f"(kernels) / {star_p[i]} (plain), ELBO rel {rel[i]:.3g}",
              flush=True)
    flips = int(np.sum(star_k != star_p))
    msg = (f"phase 10: {len(rk)} sources f64, kernels vs plain twins: "
           f"{flips} classification flips; ELBO rel worst {rel.min():.3g}, "
           f"best {rel.max():.3g}; kernels {t1 - t0:.3f} s, plain "
           f"{t2 - t1:.3f} s; {rk_rec.summary()}; bar: 0 flips, worst > "
           f"-{SLICE_ELBO_TOL:g}")
    check(flips == 0 and bool(np.all(np.isfinite(ek)))
          and bool(np.all(rel > -SLICE_ELBO_TOL)), msg)
    if device == "cuda":
        check(all(n > 0 for n in rk_rec.launches().values()),
              f"phase 10: a field kernel never launched: {rk_rec.launches()}")
    print(msg, flush=True)
    print("phase 10 ok", flush=True)


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
    import torch
    try:
        t0 = time.perf_counter()
        phase_setup()
        _phase_clock(1, t0)
        t0 = time.perf_counter()
        rec = phase_kernels()
        _phase_clock(2, t0)
        t0 = time.perf_counter()
        launches = phase_slice(rec=rec)
        _phase_clock(3, t0)
        t0 = time.perf_counter()
        phase_compare()
        _phase_clock(4, t0)
        t0 = time.perf_counter()
        scene = mcmc_scene("cuda")
        rec.update(phase_new_kernels(scene))
        _phase_clock(5, t0)
        t0 = time.perf_counter()
        launches.update(phase_mcmc(scene))
        _phase_clock(6, t0)
        t0 = time.perf_counter()
        phase_mcmc_routes(scene)
        _phase_clock(7, t0)
        t0 = time.perf_counter()
        launches.update(phase_split_fit())
        _phase_clock(8, t0)
        t0 = time.perf_counter()
        field = phase_field(rec=rec)
        _phase_clock(9, t0)
        t0 = time.perf_counter()
        phase_field_routes()
        _phase_clock(10, t0)
    except PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0],
             replaces=SOURCES[k][1], launches=launches[k],
             field_launches=field.get(k, 0), **rec[k])
        for k in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
