"""The PyTorch port imports neither JAX nor the JAX package, and its smoke
script refuses to run without a CUDA device or outside a checkout."""

import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import celeste_jl_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'celeste_jl_tpu'))
print(len(mods), bad)
assert not bad, bad
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_import_without_jax():
    """No module named jax, jax.*, celeste_jl_tpu or celeste_jl_tpu.* is
    loaded after every port module and chip_smoke are imported."""
    # a subprocess: tests/conftest.py has imported jax into this one
    proc = _run(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 16, proc.stdout


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


def test_chip_smoke_phases_run_on_cpu_twins():
    """Phases 2-8 of chip_smoke.py at tiny sizes on CPU tensors, where every
    wrapper runs its plain twin: this holds the script's control flow and
    checks, not the kernels (those run only on the card)."""
    import chip_smoke as cs

    rec = cs.phase_kernels(device="cpu", k1_sets=((2, 16), (1, 40)), n_mats=4)
    launches = cs.phase_slice(device="cpu", n_sources=3, tile=16)
    cs.phase_compare(device="cpu", n_sources=2, tile=16)
    scene = cs.mcmc_scene("cpu", n_sources=2)
    rec.update(cs.phase_new_kernels(scene, device="cpu", tiles=(16,),
                                    n_samples=2, n_mats=4))
    launches.update(cs.phase_mcmc(scene, device="cpu", bars=False, ais=dict(
        num_temperatures=2, num_samples=2, num_samples_per_chain=1)))
    cs.phase_mcmc_routes(scene, device="cpu", n_sources=2, ais=dict(
        num_temperatures=2, num_samples=2, num_samples_per_chain=1))
    launches.update(cs.phase_split_fit(device="cpu", n_sources=2, tile=16))
    assert set(rec) == set(launches) == set(cs.SOURCES)
    assert all(r["max_abs_err"] == 0.0 for r in rec.values())
    assert all(r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
               and r["library_ms"] is None for r in rec.values())
    assert launches == {k: 0 for k in cs.SOURCES}   # CPU: no kernel runs
