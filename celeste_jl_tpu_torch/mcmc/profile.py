"""Where the MCMC slice's time goes, on one CUDA device.

    python -m celeste_jl_tpu_torch.mcmc.profile [--sources 64] [--temps 4]
        [--chain 2] [--device cuda] [--k4-warps W]

Runs run_ais_batched on benchmark/bench_mcmc.py's scene (f32, 10 AIS
samples per source, both models) once to warm up, once timed and once
under torch.profiler, with a shortened ladder and chain: every sweep of
the production program does the same kind of work, so per-sweep figures
carry over.
Prints the wall time per sweep, host reads and K4 launches per sweep, the
ops dispatched per likelihood evaluation, the device's busy share, K4's
share of device time and its mean time a launch, and the top operators by
device and by host time. --k4-warps sets the most rows (warps) of a K4
block for the run (ops/render.K4_WARPS), to compare block widths on the
AIS's own launches.
"""

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ops import render
from ..synthetic import ais_bench_scene
from ..utils.config import Config
from .infer import run_ais_batched
from .slice import slicesample


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", type=int, default=64)
    ap.add_argument("--temps", type=int, default=4)
    ap.add_argument("--chain", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k4-warps", type=int, default=render.K4_WARPS)
    a = ap.parse_args(argv)
    render.K4_WARPS = a.k4_warps
    cuda = a.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    images, catalog = ais_bench_scene(a.sources, device=a.device)
    kw = dict(config=Config(min_radius_pix=8.0), device=a.device,
              dtype=torch.float32, num_temperatures=a.temps, num_samples=10,
              num_samples_per_chain=a.chain)
    run_ais_batched(catalog, images, seed=1, **kw)          # warm-up
    sync()
    t0 = time.perf_counter()
    run_ais_batched(catalog, images, seed=0, **kw)
    sync()
    plain_wall = time.perf_counter() - t0

    render.mixture_poisson_ll.launches = 0
    slicesample.host_reads = 0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_ais_batched(catalog, images, seed=0, **kw)
        sync()
        wall = time.perf_counter() - t0
    sweeps = a.temps - 1 + a.chain
    launches = render.mixture_poisson_ll.launches
    evals = launches                # one K4 launch scores both models
    events = prof.key_averages()
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    # device-side events only (kernels, copies): an operator's self device
    # time repeats its kernels'
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    on_device = [e for e in events if e.device_type != DeviceType.CPU]
    device_total = sum(dev_us(e) for e in on_device) / 1e6
    k4 = sum(dev_us(e) for e in on_device
             if "render_ll_kernel" in e.key) / 1e6
    reads = sum(e.count for e in events
                if e.key == "aten::_local_scalar_dense")
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"device {name}; {a.sources} sources, {sweeps} sweeps "
          f"({a.temps - 1} AIS steps + {a.chain} chain steps), f32; K4 "
          f"blocks of at most {render.K4_WARPS} warps")
    print(f"wall {plain_wall:.3f} s = {plain_wall / sweeps:.3f} s per sweep "
          f"(under the profiler {wall:.3f} s); K4 launches {launches} "
          f"({launches / sweeps:.1f} per sweep); "
          f"slice-loop host reads {slicesample.host_reads} "
          f"({slicesample.host_reads / sweeps:.1f} per sweep); all "
          f"device-to-host reads {reads}")
    if cuda:
        print(f"aten ops dispatched {n_ops} = {n_ops / evals:.1f} per "
              f"likelihood evaluation of both models ({evals:.0f} "
              f"evaluations)")
        print(f"device time {device_total:.3f} s = busy share "
              f"{device_total / plain_wall:.4f} of the unprofiled wall "
              f"({device_total / wall:.4f} profiled); K4 {k4:.4f} s = "
              f"{k4 / max(device_total, 1e-12):.4f} of device time, "
              f"{k4 / max(launches, 1) * 1e3:.4f} ms a launch")
        print(events.table(sort_by="self_cuda_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=20))


if __name__ == "__main__":
    main()
