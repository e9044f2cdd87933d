#!/usr/bin/env python3
"""How far a sharded fit ends from the one-process fit of the same
sources, and why: chip_smoke.py phase 18a's sources
(synthetic_patch_batch(n, tile 32, seed 1), f64) fitted with
run.card_newton_config's solver (pjacobi, up to 8 sweeps to 1e-12) in
one process, as one process's fits of the two halves of the batch, and
on a pod of two ranks (parallel/mesh.spawn_pod) over a (2, 1) mesh (the
sources split) and a (1, 2) mesh (the tiles' rows split).

    python3 tools/pod_witness.py [--sources 16] [--device cpu] \\
        [--variant card|tol0|ftol]

--variant tol0 fixes the Jacobi sweeps' count (jacobi_tol 0: every
refresh runs all 8), ftol tightens the Newton stop (ftol_rel 1e-12).
Prints one JSON line: each route's ELBO departure from the one-process
fit of the whole batch, lane by lane (|e - e1| / |e1|), and whether the
(2, 1) pod's ELBOs equal the halves' bit for bit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel.mesh import spawn_pod
    from celeste_jl_tpu_torch.parallel.run import card_newton_config
    from celeste_jl_tpu_torch.synthetic import synthetic_patch_batch
    from celeste_jl_tpu_torch.vi.optimize import fit_sources

    ap = argparse.ArgumentParser(prog="tools/pod_witness.py")
    ap.add_argument("--sources", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--variant", default="card",
                    choices=["card", "tol0", "ftol"])
    args = ap.parse_args(argv)
    cfg = card_newton_config(NewtonConfig(), torch.float64)
    if args.variant == "tol0":
        cfg = cfg._replace(jacobi_tol=0.0)
    elif args.variant == "ftol":
        cfg = cfg._replace(ftol_rel=1e-12)
    n, dev = args.sources, args.device
    _, vp0s, patches = synthetic_patch_batch(n, tile=32, seed=1,
                                             dtype=np.float64, device=dev)
    vp = torch.as_tensor(vp0s, device=dev)
    one = fit_sources(vp, patches, config=cfg).elbo.cpu().numpy()
    h = n // 2
    halves = np.concatenate([
        fit_sources(vp[i:i + h], patches.index(slice(i, i + h)),
                    config=cfg).elbo.cpu().numpy() for i in (0, h)])
    out = spawn_pod(2, cs.pod_rank, vp0s,
                    tuple(t.cpu().numpy() for t in patches), cfg,
                    ((2, 1), (1, 2)), None, None, dev, device=dev,
                    timeout_s=1800.0)
    rel = lambda e: [float(x) for x in np.abs(e - one) / np.abs(one)]
    pods = {f"{f['mesh'][0]}x{f['mesh'][1]}": f["elbo"] for f in out["fits"]}
    print(json.dumps({
        "sources": n, "device": dev, "variant": args.variant,
        "halves": rel(halves), "pod_2x1": rel(pods["2x1"]),
        "pod_1x2": rel(pods["1x2"]),
        "pod_2x1_equals_halves": bool(np.array_equal(pods["2x1"], halves)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
