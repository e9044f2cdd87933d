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
  * busy_s()          - the union of the launch-pending intervals.

Utilization = pixel_visits / (pixel_visits + padded_visits).

No model-FLOP count: the JAX package prices fits with XLA's cost analysis
(utils/flops.py), which has no port yet, so `model_flops` stays 0 and
`report` prints no MFU.
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
    # stays 0 until utils/flops.py is ported (ROADMAP queue 1 item 4)
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

    def utilization(self):
        total = self.pixel_visits + self.padded_visits
        return self.pixel_visits / total if total else 1.0

    def lane_fill(self):
        """Real lanes over all lanes of the fit launches."""
        lanes = sum(w * n for w, n in self.lane_widths.items())
        return self.sources_fit / lanes if lanes else 1.0

    def report(self, prefix="telemetry"):
        busy = self.busy_s()
        visits_per_s = self.pixel_visits / busy if busy > 0 else 0.0
        # MFU waits for a port of utils/flops.py (ROADMAP queue 1 item 4)
        Log.info(
            f"{prefix}: {self.sources_fit} fits in {self.launches} launches "
            f"({busy:.2f}s busy, {self.launch_s:.2f}s summed), lane fill "
            f"{100 * self.lane_fill():.1f}%, {self.pixel_visits:.3g} "
            f"pixel-visits ({visits_per_s:.3g}/s), utilization "
            f"{100 * self.utilization():.1f}%, {self.newton_iters} newton "
            f"iters, {self.failures} failures; MFU not computed (no FLOP "
            f"model yet)")


# module-level counters, reset per box by the schedules
counters = Counters()


def now():
    return time.perf_counter()


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
                      pixels_per_lane_total, f_calls):
    """Account one fit launch: n_real real lanes and n_padded padding lanes
    of a tile with `pixels_per_lane_total` pixel slots, of which
    `pixels_per_lane_real` (per real lane) were mask-true. f_calls:
    per-lane function evaluations, length n_real + n_padded. (The JAX
    package's tile, bands and hess_every arguments feed its FLOP model,
    which has no port yet.)"""
    f = np.asarray(f_calls)
    real_calls = f[:n_real]
    counters.sources_fit += n_real
    counters.newton_iters += int(real_calls.sum())
    counters.lane_widths[n_real + n_padded] += 1
    real = float((np.asarray(pixels_per_lane_real) * real_calls).sum())
    total = float(pixels_per_lane_total) * float(f.sum())
    counters.pixel_visits += int(real)
    counters.padded_visits += int(max(total - real, 0.0))
