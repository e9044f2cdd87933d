"""Work counters and launch telemetry (the port's copy of
celeste_jl_tpu/utils/telemetry.py; the reference's tracing subsystem).

The reference counts pixel-visits per ELBO evaluation
(elbo_args.jl:62-63, elbo_objective.jl:352-357) and logs per-batch thread
wall times and idle percentage (ParallelRun.jl:327-365). Recorded here:

  * pixel_visits      - mask-true pixels x Newton f-calls, summed over fits;
  * padded_visits     - the same for padding lanes and masked-out pixels:
                        work a perfectly ragged launch would not do;
  * launches, launch_s - batched fit launches and their summed wall time;
  * lane_widths       - fit launches by lane width (real + padding lanes);
  * busy_s()          - the union of the launch-pending intervals;
  * serial_steps      - the fused joint schedule's serial depth: over its
                        sub-fits, the sum of the slowest lane's TR steps;
  * model_flops       - the real lanes' useful work priced by
                        utils/flops.py's model; mfu() sets it over busy_s()
                        against the card's peak.

Utilization = pixel_visits / (pixel_visits + padded_visits).
"""

import collections
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from . import log as Log


@dataclass
class Counters:
    pixel_visits: int = 0
    padded_visits: int = 0
    launches: int = 0
    launch_s: float = 0.0
    sources_fit: int = 0
    newton_iters: int = 0
    failures: int = 0
    # fused-schedule serial depth: over its sub-fits, the slowest lane's TR
    # steps (a batched fit runs until its slowest lane stops)
    serial_steps: int = 0
    # model FLOPs of the real lanes' useful work (utils/flops.py)
    model_flops: float = 0.0
    lane_widths: collections.Counter = field(
        default_factory=collections.Counter)
    # (t_dispatch, t_results) spans of every launch, for busy_s()
    intervals: list = field(default_factory=list)

    def reset(self):
        self.__init__()

    def busy_s(self):
        """Union length of the launch-pending intervals: the time at least
        one launch was in flight (launch_s over-counts overlapped ones)."""
        total, end = 0.0, -1.0
        for a, b in sorted(self.intervals):
            if a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def mfu(self, device=None):
        """(model FLOP/s over busy_s(), fraction of the card's peak or
        None: the CPU, or an unknown card)."""
        from .flops import mfu as _mfu
        busy = self.busy_s()
        if busy <= 0:
            return 0.0, None
        return _mfu(self.model_flops, busy, device)

    def utilization(self):
        total = self.pixel_visits + self.padded_visits
        return self.pixel_visits / total if total else 1.0

    def lane_fill(self):
        """Real lanes over all lanes of the fit launches."""
        lanes = sum(w * n for w, n in self.lane_widths.items())
        return self.sources_fit / lanes if lanes else 1.0

    def report(self, prefix="telemetry", device=None):
        """Log the counters; `device` is the fits' device, for the MFU."""
        busy = self.busy_s()
        visits_per_s = self.pixel_visits / busy if busy > 0 else 0.0
        achieved, mfu = self.mfu(device)
        Log.info(
            f"{prefix}: {self.sources_fit} fits in {self.launches} launches "
            f"({busy:.2f}s busy, {self.launch_s:.2f}s summed), lane fill "
            f"{100 * self.lane_fill():.1f}%, {self.pixel_visits:.3g} "
            f"pixel-visits ({visits_per_s:.3g}/s), utilization "
            f"{100 * self.utilization():.1f}%, {self.newton_iters} newton "
            f"iters"
            + (f" ({self.serial_steps} serialized)" if self.serial_steps
               else "")
            + f", {achieved / 1e9:.3g} model GFLOP/s"
            + (f" (MFU {100 * mfu:.3f}%)" if mfu is not None else "")
            + f", {self.failures} failures")


# module-level counters, reset per box by the schedules
counters = Counters()


def now():
    return time.perf_counter()


def fit_kernel_launches(reset=False):
    """{name: launches} of the fit's kernels (K1 refresh, K2 Jacobi sweep,
    K3 TR subproblem) since their counters were last set to 0; reset=True
    sets them to 0 first (and K3's launches by D)."""
    from ..ops import eigh, refresh, tr

    fns = {"refresh": refresh.pixel_terms, "jacobi_sweep": eigh.jacobi_sweep,
           "tr_subproblem": tr.tr_subproblem}
    if reset:
        tr.tr_subproblem.launches_by_dim = {}
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def tr_launches_by_dim():
    """{D: launches} of K3 since fit_kernel_launches(reset=True): D = 12
    are the PSF fits' (models/psf_fit), the source fits' D = 42."""
    from ..ops import tr

    return dict(tr.tr_subproblem.launches_by_dim)


def record_launch_wall(t0, label=""):
    """Account one batched launch spanning dispatch -> results on the host.
    Set CELESTE_LOG_LAUNCHES=1 to log each launch."""
    t1 = time.perf_counter()
    dt = t1 - t0
    counters.launches += 1
    counters.launch_s += dt
    counters.intervals.append((t0, t1))
    if os.environ.get("CELESTE_LOG_LAUNCHES"):
        Log.info(f"launch {label}: {dt:.2f}s")


@contextmanager
def launch_timer(label=""):
    """Times one batched launch into the global counters (the
    context-manager form of record_launch_wall)."""
    t0 = now()
    try:
        yield
    finally:
        record_launch_wall(t0, label)


def record_fit_launch(n_real, n_padded, pixels_per_lane_real,
                      pixels_per_lane_total, f_calls, tile=None, bands=5,
                      hess_every=6):
    """Account one fit launch: n_real real lanes and n_padded padding lanes
    of a tile with `pixels_per_lane_total` pixel slots, of which
    `pixels_per_lane_real` (per real lane) were mask-true. f_calls:
    per-lane function evaluations, length n_real + n_padded. With `tile`,
    the real lanes' work is also priced in model FLOPs (utils/flops.py) at
    `bands` bands and a refresh every `hess_every` TR steps."""
    f = np.asarray(f_calls)
    real_calls = f[:n_real]
    counters.sources_fit += n_real
    counters.newton_iters += int(real_calls.sum())
    counters.lane_widths[n_real + n_padded] += 1
    real = float((np.asarray(pixels_per_lane_real) * real_calls).sum())
    total = float(pixels_per_lane_total) * float(f.sum())
    counters.pixel_visits += int(real)
    counters.padded_visits += int(max(total - real, 0.0))
    if tile is not None and n_real:
        from .flops import fit_flops
        iters = np.maximum(real_calls - 1, 0)   # f_calls = 1 + TR steps
        counters.model_flops += fit_flops(iters, real_calls, tile,
                                          B=bands, hess_every=hess_every)
