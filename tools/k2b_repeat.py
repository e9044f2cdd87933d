#!/usr/bin/env python3
"""K2b (jacobi_replay_q) against its plain twin, twice on the same input in
one process: chip_smoke.py phase 5's f32 comparison (1024 wide-spectrum
matrices from default_rng(0), K2a's log replayed on an expanded identity).

    python3 tools/k2b_repeat.py        # from the repo root, one card

Prints one JSON line: per repetition the SHA-256 of K2a's log, of K2b's Q
and of the twin's Q, the max abs difference, and how many entries differ;
and whether each side's bytes were the same in both repetitions.
"""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs_mod
    from celeste_jl_tpu_torch.ops import eigh

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    digest = lambda t: hashlib.sha256(
        t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    H64 = cs_mod.wide_spectrum_batch(np.random.default_rng(0), 1024)
    reps, keep = [], []
    for _ in range(2):
        H = torch.as_tensor(H64, dtype=torch.float32, device="cuda")
        eye = torch.eye(42, dtype=torch.float32, device="cuda").expand_as(H)
        _, log = eigh.jacobi_sweep_a(H)
        q_kernel = eigh.jacobi_replay_q(eye, log)
        q_twin = eigh.jacobi_replay_q_plain(eye, log)
        torch.cuda.synchronize()
        diff = (q_kernel - q_twin).abs()
        reps.append(dict(log=digest(log), kernel=digest(q_kernel),
                         twin=digest(q_twin), max_abs_err=float(diff.max()),
                         n_differ=int((diff > 0).sum())))
        keep.append((log, q_kernel, q_twin))
    same = {name: bool(torch.equal(keep[0][i], keep[1][i]))
            for i, name in enumerate(("log", "kernel", "twin"))}
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), reps=reps,
                          same_bytes=same)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
