"""The fit path's sweep (K2), TR subproblem (K3) and split sweep (K2a, K2b)
of two checkouts of the PyTorch port, timed in turns on one CUDA device.

    python3 tools/kernel_ab.py --other DIR [--batches 1024 256] [--turns 2]

DIR is another checkout of the repository, such as an earlier commit
unpacked with `git archive` into the git-ignored build/. Its package is
loaded beside this one under another name and builds its own kernels into
DIR/build/kernels. Both wrappers get the same f32 inputs (chip_smoke.py's
wide-spectrum matrices and TR cases; K2b this checkout's K2a log of them)
at each batch size, in turns: other,
this, this, other, `--turns` times. Per call it prints chip_smoke.timed_ms's
caller time (`ms`) and card time (`device_ms`), and the host's time to
enqueue one call (a loop of calls without a wait, `host_ms`). It first
prints, in f64 and f32, the largest difference between the two checkouts'
results, relative to ||H|| for K2's A, and absolute for K2a's A and log
and K2b's Q.
"""

import argparse
import importlib
import importlib.util
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from celeste_jl_tpu_torch.ops import eigh, tr  # noqa: E402


def load_other(root, name="other_celeste_jl_tpu_torch"):
    """The package of the checkout at `root`, imported as `name`; returns
    its (ops.eigh, ops.tr)."""
    path = os.path.join(os.path.abspath(root), "celeste_jl_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.eigh"),
            importlib.import_module(f"{name}.ops.tr"))


def host_ms(fn, calls=200):
    """The host's time to enqueue one call of fn, ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def inputs(B, dtype, device="cuda"):
    """chip_smoke.py's K2 and K3 inputs at batch B: (H, I), (gq, w, delta)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    H = t(cs.wide_spectrum_batch(np.random.default_rng(0), B))
    eye = torch.eye(42, dtype=dtype, device=device).expand_as(H)
    return (H, eye), tuple(map(t, cs.tr_cases(np.random.default_rng(7), B)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--batches", type=int, nargs="+", default=[1024])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    o_eigh, o_tr = load_other(a.other)
    sides = {"other": (o_eigh, o_tr), "this": (eigh, tr)}
    print(f"{torch.cuda.get_device_name(0)}; other = {a.other}", flush=True)

    for dtype in (torch.float64, torch.float32):
        (H, eye), k3 = inputs(1024, dtype)
        A1, Q1 = o_eigh.jacobi_sweep(H, eye)
        A2, Q2 = eigh.jacobi_sweep(H, eye)
        p1, r1 = o_tr.tr_subproblem(*k3, 48)
        p2, r2 = tr.tr_subproblem(*k3, 48)
        norm = torch.linalg.matrix_norm(H.double())[:, None, None]
        fin = torch.isfinite(p1) & torch.isfinite(p2)
        print(f"{str(dtype)[6:]} B=1024, this vs other: K2 A "
              f"{float(((A1 - A2).double().abs() / norm).max()):.3g} of "
              f"||H||, Q {float((Q1 - Q2).abs().max()):.3g}"
              f" (bit-identical {torch.equal(A1, A2) and torch.equal(Q1, Q2)})"
              f"; K3 p {float((p1 - p2).abs()[fin].max()):.3g}, pred "
              f"{float((r1 - r2).abs().nan_to_num().max()):.3g}", flush=True)
        (A1, c1), (A2, c2) = o_eigh.jacobi_sweep_a(H), eigh.jacobi_sweep_a(H)
        Q1, Q2 = o_eigh.jacobi_replay_q(eye, c1), eigh.jacobi_replay_q(eye, c2)
        same = all(torch.equal(x, y)
                   for x, y in ((A1, A2), (c1, c2), (Q1, Q2)))
        print(f"{str(dtype)[6:]} B=1024, this vs other: K2a A "
              f"{float((A1 - A2).abs().max()):.3g}, log "
              f"{float((c1 - c2).abs().max()):.3g}; K2b Q "
              f"{float((Q1 - Q2).abs().max()):.3g} (bit-identical {same})",
              flush=True)

    timed = lambda fn, spin: cs.timed_ms(fn, torch, reps=a.reps, spin=spin)
    for B in a.batches:
        (H, eye), k3 = inputs(B, torch.float32)
        cs_log = eigh.jacobi_sweep_a(H)[1]
        for turn in range(a.turns):
            for side in ("other", "this", "this", "other"):
                e, t = sides[side]
                for name, fn in (("K2", lambda: e.jacobi_sweep(H, eye)),
                                 ("K3", lambda: t.tr_subproblem(*k3, 48)),
                                 ("K2a", lambda: e.jacobi_sweep_a(H)),
                                 ("K2b",
                                  lambda: e.jacobi_replay_q(eye, cs_log))):
                    print(f"turn {turn} {side} {name} f32 B={B}: ms "
                          f"{timed(fn, False):.4f} device_ms "
                          f"{timed(fn, True):.4f} host_ms "
                          f"{host_ms(fn):.4f}", flush=True)


if __name__ == "__main__":
    main()
