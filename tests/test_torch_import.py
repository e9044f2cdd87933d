"""The PyTorch port imports neither JAX nor the JAX package (nor PyYAML),
its smoke script refuses to run without a CUDA device or outside a
checkout, its phases run at tiny sizes on the CPU twins, and the argument
types it gives ctypes match its kernels' C entry points."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import celeste_jl_tpu_torch as pkg
# __main__ runs the CLI when imported; _RUN_MAIN runs it
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')
        if m.name != pkg.__name__ + '.__main__']
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'celeste_jl_tpu', 'yaml',
                                    'pandas', 'matplotlib'))
print(len(mods), bad, mods)
assert not bad, bad
"""

_RUN_MAIN = """
import runpy, sys
for mod in ('celeste_jl_tpu_torch', 'celeste_jl_tpu_torch.worker',
            'celeste_jl_tpu_torch.benchmark.galsim_suite',
            'celeste_jl_tpu_torch.experiments.mcmc_experiment',
            'celeste_jl_tpu_torch.experiments.mcmc_figures',
            'celeste_jl_tpu_torch.benchmark.bench_elbo',
            'celeste_jl_tpu_torch.benchmark.calibration',
            'celeste_jl_tpu_torch.benchmark.svi_compare',
            'celeste_jl_tpu_torch.results_to_fits'):
    sys.argv = [mod, '--help']
    try:
        runpy.run_module(mod, run_name='__main__')
    except SystemExit as e:
        assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'celeste_jl_tpu', 'yaml',
                                    'pandas', 'matplotlib'))
print(bad)
assert not bad, bad
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_import_without_jax():
    """No module named jax, jax.*, celeste_jl_tpu, celeste_jl_tpu.*, yaml,
    pandas or matplotlib is loaded after every port module (the runners
    and the worker CLI among them) and chip_smoke are imported, nor after
    `python -m celeste_jl_tpu_torch --help`, `python -m
    celeste_jl_tpu_torch.worker --help` and every runner's --help
    (GalSim suite, MCMC experiment and figures, bench_elbo, calibration,
    SVI compare, results_to_fits) have run."""
    # a subprocess: tests/conftest.py has imported jax into this one;
    # the imports, then the --help runs, in one
    proc = _run(["-c", _IMPORT_ALL + _RUN_MAIN], ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 60, proc.stdout
    for m in ("utils.log", "utils.telemetry", "utils.coordinates",
              "utils.device", "io.dataset", "io.fits", "io.wcs", "io.sdss",
              "io.decals", "detection._native", "detection.background",
              "detection.extract", "detection.detect", "models.psf_fit",
              "parallel.partition", "parallel.packing", "parallel.run",
              "parallel.fused", "utils.flops", "benchmark.multifield",
              "vi.stochastic", "main", "benchmark.accuracy",
              "benchmark.galsim", "benchmark.bundle",
              "benchmark.independent_render", "benchmark.galsim_suite",
              "benchmark.worker_farm", "models.fit_priors",
              "parallel.multinode", "parallel.mesh", "worker",
              "experiments.mcmc_experiment",
              "experiments.mcmc_figures", "benchmark.bench_elbo",
              "benchmark.calibration", "benchmark.svi_compare",
              "results_to_fits"):
        assert f"celeste_jl_tpu_torch.{m}'" in proc.stdout, m
    assert "--method" in proc.stdout and "svi" in proc.stdout
    assert "--workdir" in proc.stdout and "--group-boxes" in proc.stdout
    assert "--scenes" in proc.stdout and "--radius" in proc.stdout
    assert "--num-sources" in proc.stdout and "--results-dir" in proc.stdout
    assert "BENCH_ELBO_SOURCES" in proc.stdout and "--out" in proc.stdout
    assert "output FITS path" in proc.stdout


def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path):
    if torch.cuda.is_available():
        # only the checkout-less half applies on a machine with a card
        runs = []
    else:
        runs = [_run(["chip_smoke.py"], ROOT)]
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs.append(_run(["chip_smoke.py"], str(tmp_path)))
    for proc in runs:
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout, proc.stdout


def test_chip_smoke_phases_run_on_cpu_twins(monkeypatch):
    """Phases 2-9 of chip_smoke.py at tiny sizes on CPU tensors, where every
    wrapper runs its plain twin: this holds the script's control flow and
    checks, not the kernels (those run only on the card). Phase 10 runs in
    phase_routes, as main runs it
    (test_chip_smoke_multifield_phases_run_on_cpu_twins)."""
    import chip_smoke as cs

    rec = cs.phase_kernels(device="cpu", k1_sets=((2, 16), (1, 40)), n_mats=4)
    launches, fits_per_s = cs.phase_slice(device="cpu", n_sources=4,
                                          tile=16, rec=rec)
    assert fits_per_s > 0
    # the fit's stage 2 runs (in place, B = 4): K2 and K3 checked there too
    assert rec["jacobi_sweep"]["stage2"]["B"] == 4
    assert rec["tr_subproblem"]["stage2"]["bound_ms"] > 0
    assert {"floor_ms"} <= set(rec["jacobi_sweep"]) & set(rec["tr_subproblem"])
    # the fits of phases 4 and 8 cut to three refresh cycles: the routes'
    # comparison and bars, not the fit, are rehearsed
    short_fit = cs.bench_config()._replace(max_iters=3)
    monkeypatch.setattr(cs, "bench_config", lambda: short_fit)
    cs.phase_compare(device="cpu", n_sources=2, tile=16)
    scene = cs.mcmc_scene("cpu", n_sources=2)
    rec.update(cs.phase_new_kernels(scene, device="cpu", tiles=(16,),
                                    n_samples=2, n_mats=4, fit_batch=3))
    # the split sweep at phase 8's batch (here 3) and at B = 1 too
    assert rec["jacobi_sweep_a"]["split_fit"]["B"] == 3
    assert rec["jacobi_replay_q"]["split_fit"]["bound_ms"] > 0
    assert {"floor_ms"} <= (set(rec["jacobi_sweep_a"])
                            & set(rec["jacobi_replay_q"]))
    launches.update(cs.phase_mcmc(scene, device="cpu", bars=False, ais=dict(
        num_temperatures=2, num_samples=2, num_samples_per_chain=1)))
    cs.phase_mcmc_routes(scene, device="cpu", n_sources=2, ais=dict(
        num_temperatures=2, num_samples=2, num_samples_per_chain=1))
    launches.update(cs.phase_split_fit(device="cpu", n_sources=2, tile=16))
    # the field phases on a 4-source 48x48 field, the schedule cut short
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.utils.config import Config

    tiny = Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                  polish_refreshes=1, polish_sweeps=1, probe_refreshes=1)
    field = cs.phase_field(device="cpu", n_sources=4, size=48, rec=rec,
                           config=tiny, single_newton=NewtonConfig(
                               max_iters=1), bars=False)
    assert field == {k: 0 for k in cs.FIELD_KERNELS}
    assert all(rec[k]["field"]["bound_ms"] > 0 for k in cs.FIELD_KERNELS)
    assert set(rec) == set(launches) == set(cs.SOURCES)
    assert all(r["max_abs_err"] == 0.0 for r in rec.values())
    assert all(r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
               and r["library_ms"] is None for r in rec.values())
    assert launches == {k: 0 for k in cs.SOURCES}   # CPU: no kernel runs


def test_entry_points_match_the_c_signatures():
    """Each C entry point of csrc/*.cu takes, in order, the pointers and
    ints that `_build.ENTRY_POINTS` declares to ctypes (ctypes would pass a
    wrong list without an error)."""
    import ctypes
    import glob
    import re

    from celeste_jl_tpu_torch.ops import _build

    declared = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read().replace("\\\n", " ")
        for name, params in re.findall(
                r'extern "C" int celeste_(\w+?)_(?:f32|##SUFFIX)\s*\(([^)]*)\)',
                src):
            declared[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                              for p in params.split(",")]
    assert declared == _build.ENTRY_POINTS


def _cut_psf_fits(mp):
    """Every PSF fit of this process (models/psf_fit._fit, under
    fit_psfs_batched) cut to 3 refresh cycles."""
    from celeste_jl_tpu_torch.models import psf_fit

    fit = psf_fit._fit
    mp.setattr(psf_fit, "_fit", lambda stamps, K, config, plain: fit(
        stamps, K, config._replace(max_iters=3), plain))


def test_chip_smoke_app_phases_run_on_cpu_twins(monkeypatch):
    """Phases 11, 12, 16, 17d and 18 of chip_smoke.py (the survey app, the
    farm worker, results_to_fits over its files and the pod) on a 96 x 64
    and a 64 x 64 SDSS field of a few sources on the CPU, the schedules
    cut short (SVI to 50 steps, main's single_vi fits to 3 refresh
    cycles; phases 11's and 16's PSF fits, in this process, to 3 as
    well; phase 12 holds its PSF fits to a process of its own, which
    runs them whole): the field writer, main, the scorer through the TAN
    WCS, the route comparisons, the worker CLI over phase 11's files with
    its resume, the FITS catalog of its files, and phase 18's pod of two
    ranks (a (1, 2) mesh's fit of 2 sources on 16 x 16 tiles, the worker
    CLI --distributed over phase 11's files, and 18c's joint schedule on
    a (2, 1) mesh over its field cut to 4 sources on 48 x 48 px, a
    refresh a fit), not the kernels."""
    import functools
    import shutil

    import chip_smoke as cs
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel import run
    from celeste_jl_tpu_torch.utils.config import Config
    from celeste_jl_tpu_torch.vi.stochastic import SVIConfig

    monkeypatch.setattr(run, "SVIConfig", lambda: SVIConfig(steps=50))
    monkeypatch.setattr(run, "one_node_single_infer", functools.partial(
        run.one_node_single_infer, newton_config=NewtonConfig(max_iters=3)))
    rec = {"tr_subproblem": {}}
    field = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            _cut_psf_fits(mp)
            launches = cs.phase_app(device="cpu", H=96, W=64, n_sources=4,
                                    method="single_vi", rec=rec, bars=False,
                                    field=field)
        assert launches == {k: 0 for k in cs.FIELD_KERNELS}
        assert len(field["targets"]) == 4 and os.path.isdir(field["base"])
        k3 = rec["tr_subproblem"]["psf_fit"]
        assert (k3["B"], k3["D"]) == (4, 12) and k3["max_abs_err"] == 0.0
        assert k3["bound_ms"] > 0 and k3["bound_by"] in ("bytes",
                                                          "operations")
        tiny = Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                      polish_refreshes=1, polish_sweeps=1, probe_refreshes=1)
        cs.phase_app_routes(device="cpu", size=64, n_sources=3, config=tiny)
        # phase 16 on phase 11's files: every target saved once, the
        # resume completing nothing (bars=False: the fits are cut short);
        # main hands the field to a process of its own, so it pickles
        import pickle

        field = pickle.loads(pickle.dumps(field))
        with pytest.MonkeyPatch.context() as mp:
            _cut_psf_fits(mp)
            farm = cs.phase_farm(field, device="cpu", grid=(2, 1),
                                 config=tiny,
                                 newton_config=NewtonConfig(max_iters=3),
                                 bars=False)
        assert farm == {k: 0 for k in cs.FIELD_KERNELS}
        # phase 17d: the farm's result files as one FITS catalog
        cs.phase_results_to_fits(field, device="cpu")
        # phase 18: the pod, every bar held; 18c on its field cut to 4
        # sources on 48 x 48 px
        joint = cs.pod_joint_kwargs(
            device="cpu", n_sources=4, size=48,
            config=Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                          polish_refreshes=1, polish_sweeps=1,
                          probe_refreshes=1),
            newton_config=NewtonConfig(max_iters=1, hess_every=2))
        pod = cs.phase_pod(field, device="cpu", n_sources=2, tile=16,
                           meshes=((1, 2),),
                           config=NewtonConfig(max_iters=3), joint=joint)
        assert pod == {k: 0 for k in cs.SOURCES}
    finally:
        if field:
            shutil.rmtree(field["dir"], ignore_errors=True)


def test_chip_smoke_multifield_phases_run_on_cpu_twins():
    """Phases 13-15 of chip_smoke.py (the multi-field fused schedule and the
    GalSim suite's CI subset) on two 48 x 48 fields of 6 sources and on a
    noise-free and a noisy GalSim scene at radius 8 on the CPU, the
    schedules cut to a refresh a step: the runner, the staging spy, the
    class count across fields, the route comparisons, the GalSim runner
    with its noise-free rerun and the artifact rows, not the kernels;
    phases 14 and 15 beside phase 10 (4 sources on 48 x 48), as main
    runs them."""
    import chip_smoke as cs
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.utils.config import Config

    short = Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                   polish_refreshes=1, polish_sweeps=1, probe_refreshes=1)
    newton = NewtonConfig(max_iters=1, hess_every=2)
    with cs.FusedStagings() as fs:
        launches = cs.phase_multifield(device="cpu", n_fields=2,
                                       n_sources=6, size=48, config=short,
                                       newton_config=newton, bars=False)
    assert launches == {k: 0 for k in cs.FIELD_KERNELS}
    # the phase's own spy nests inside this one: one merged staging,
    # with classes that hold sources of both fields
    (states, classes, handle), = fs.calls
    assert len(states) == 2 and handle is not None
    assert fs.multi_field_classes() > 0
    assert handle["schedule_s"] > 0 and handle["stage_s"] > 0
    # phases 14 and 15 as main runs them, in one pool with phase 10's runs
    out = cs.phase_routes(
        device="cpu", field=dict(n_sources=4, size=48, config=short),
        multi=dict(n_sources=6, size=48, config=short, newton_config=newton,
                   bars=False),
        galsim=dict(names=["simple_star", "star_with_noise"], radius=8.0,
                    newton_config=NewtonConfig(max_iters=2), bars=False),
        runners=dict(calibration=dict(names=["overlapping_stars"],
                                      newton_config=newton),
                     svi_compare=dict(n_sources=4, size=64, steps=3,
                                      newton_config=newton)))
    zero = {k: 0 for k in cs.SOURCES}
    assert out == {"galsim": {k: 0 for k in cs.FIELD_KERNELS},
                   "calibration": zero, "svi_compare": zero}


def test_chip_smoke_science_phases_run_on_cpu_twins(monkeypatch, tmp_path):
    """Phases 17a-c of chip_smoke.py on the CPU (17d runs in
    test_chip_smoke_app_phases_run_on_cpu_twins, 17e and 17f in the route
    pool of test_chip_smoke_multifield_phases_run_on_cpu_twins): the MCMC
    experiment's two stages through mcmc_experiment.run, its files,
    figures and bars at 2 sources on 64 x 64 px with a 2 x 2 ladder and
    posterior chains of one draw (run_ais_batched's length, patched
    here); bench_elbo at 2 sources on 16 x 16 tiles; the analytic mode
    against autograd on 2 sources, the fits cut to three refresh cycles.
    Not the kernels."""
    import functools

    import chip_smoke as cs
    from celeste_jl_tpu_torch.mcmc import infer
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.utils.config import Config

    short = Config(num_joint_vi_iters=1, joint_step_refreshes=1,
                   polish_refreshes=1, polish_sweeps=1, probe_refreshes=1)
    newton = NewtonConfig(max_iters=1, hess_every=2)
    monkeypatch.setattr(infer, "run_ais_batched", functools.partial(
        infer.run_ais_batched, num_samples_per_chain=1))
    zero = {k: 0 for k in cs.SOURCES}
    assert cs.phase_experiment(
        device="cpu", out=str(tmp_path / "experiment"), num_sources=2,
        size=64, temperatures=2, samples=2, config=short,
        newton_config=newton) == zero
    assert not (tmp_path / "experiment").exists()
    lines, launches = cs.phase_bench_elbo(device="cpu", n_sources=2, tile=16,
                                          repeats=1, newton_config=newton)
    assert len(lines) == 5 and launches == zero
    short_fit = cs.bench_config()._replace(max_iters=3)
    monkeypatch.setattr(cs, "bench_config", lambda: short_fit)
    assert cs.phase_analytic(device="cpu", n_sources=2, n_batch=2,
                             tile=16) == zero


def test_dryrun_multichip_runs_a_pod_of_two():
    """parallel/mesh.dryrun_multichip(2): a (1, 2) mesh's sharded fit on a
    spawned pod of two CPU ranks, shape and finite ELBOs checked."""
    from celeste_jl_tpu_torch.parallel.mesh import dryrun_multichip

    out = dryrun_multichip(2)
    assert out["mesh"] == (1, 2) and out["vp_shape"] == (2, 44)
