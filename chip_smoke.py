#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (celeste_jl_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the repo root, one card

Phases, one line each; the first failure exits non-zero:
  1. set-up: needs a CUDA device, prints the card's name and power limit
     (nvidia-smi), builds the three kernels from csrc/ with nvcc;
  2. each kernel against its plain torch twin on the card, at the main
     path's shapes, in f64 (tight) and f32 (the working type), with both
     median times;
  3. the slice: synthetic_patch_batch(1024, tile=32, seed=1) fitted by
     fit_sources_compacted with bench.py's configuration in f32; every ELBO
     finite and every kernel launched; fits/s, mean iterations, converged
     fraction and star/galaxy accuracy against the synthetic truth;
  4. the kernels against the plain twins on the slice: 64 sources fitted
     twice with bench.py's configuration; in f64 the classifications agree
     and no lane's ELBO is worse than the plain run's by more than 1e-4
     relative; the same comparison in f32 is reported.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
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


class PhaseError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def timed_ms(fn, torch, reps=10):
    """Median wall time of fn() on the card, ms: CUDA events around each
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    time_fn = ((lambda fn: timed_ms(fn, torch)) if device == "cuda"
               else (lambda fn: float("nan")))
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
                ms = time_fn(lambda: refresh.pixel_terms(*rows, ks=ks,
                                                         pdims=pdims))
                plain_ms = time_fn(lambda: refresh.pixel_terms_plain(
                    *rows, ks=ks, pdims=pdims))
                rec["refresh"] = dict(max_abs_err=abs_err, ms=ms,
                                      plain_ms=plain_ms)
                msg += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
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
            ms = time_fn(lambda: eigh.jacobi_sweep(H, eye))
            plain_ms = time_fn(lambda: eigh.jacobi_sweep_plain(H, eye))
            rec["jacobi_sweep"] = dict(max_abs_err=abs_err, ms=ms,
                                       plain_ms=plain_ms)
            msg += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
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
            # assert_allclose(rtol=atol=2e-5) of tests/test_pallas_tr.py,
            # non-finite entries (the near-hard lane overflows in f32) equal
            def excess(a, b):
                fin = torch.isfinite(b)
                same = torch.equal(fin, torch.isfinite(a))
                d = ((a - b).abs() - K3_F32_TOL * (1 + b.abs()))[fin]
                return float(d.max()) if same else float("inf")

            ok = max(excess(p1, p2), excess(r1, r2)) <= 0
            fin = torch.isfinite(p2)
            err = max(float((p1 - p2).abs()[fin].max()),
                      float((r1 - r2).abs()[torch.isfinite(r2)].max()))
            tol_txt = f"max abs err {err:.3g} (rtol = atol = {K3_F32_TOL:g})"
        msg = f"K3 tr_subproblem {str(dtype)[6:]} B={n_mats} D=42: {tol_txt}"
        check(ok, msg)
        if dtype == torch.float32:
            ms = time_fn(lambda: tr.tr_subproblem(gq, w, delta, 48))
            plain_ms = time_fn(lambda: tr.tr_subproblem_plain(gq, w, delta,
                                                              48))
            rec["tr_subproblem"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms)
            msg += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
        print(msg, flush=True)
    print("phase 2 ok: K1, K2, K3 agree with their plain twins", flush=True)
    return rec


def bench_config():
    """bench.py's configuration of the main path."""
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig

    return NewtonConfig(tr_solver="pjacobi", jacobi_max_sweeps=4,
                        tr_kernel="pallas", refresh_kernel="pallas",
                        grad_mode="ad", hess_every=6, bisect_iters=48,
                        secular="bisect")


def phase_slice(device="cuda", n_sources=1024, tile=32):
    import torch

    from celeste_jl_tpu_torch.ops import eigh, refresh, tr
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources_compacted

    catalog, vp0s, patches = synthetic_patch_batch(n_sources, tile=tile,
                                                   seed=1, device=device)
    vp0 = torch.as_tensor(vp0s, device=device)
    counters = {"refresh": refresh.pixel_terms,
                "jacobi_sweep": eigh.jacobi_sweep,
                "tr_subproblem": tr.tr_subproblem}
    for fn in counters.values():
        fn.launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_sources_compacted(vp0, patches, config=bench_config())
    elbo = res.elbo.cpu().numpy()
    wall = time.perf_counter() - t0
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
          f"{acc:.4f}; launches {launches}", flush=True)
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


SOURCES = {
    "refresh": ("celeste_jl_tpu_torch/csrc/refresh.cu",
                "celeste_jl_tpu/ops/pallas_refresh.py:186"),
    "jacobi_sweep": ("celeste_jl_tpu_torch/csrc/jacobi_sweep.cu",
                     "celeste_jl_tpu/ops/pallas_eigh.py:220"),
    "tr_subproblem": ("celeste_jl_tpu_torch/csrc/tr_subproblem.cu",
                      "celeste_jl_tpu/ops/pallas_tr.py:36"),
}


def main():
    sys.path.insert(0, ROOT)
    import torch
    try:
        phase_setup()
        rec = phase_kernels()
        launches = phase_slice()
        phase_compare()
    except PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0],
             replaces=SOURCES[k][1], launches=launches[k], **rec[k])
        for k in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
