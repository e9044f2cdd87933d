"""Run the GalSim-style accuracy suite on the port and write its results
(the port's counterpart of benchmark/run_galsim_suite.py).

    python -m celeste_jl_tpu_torch.benchmark.galsim_suite [--joint|--single]
        [--scenes a,b,c] [--radius 40] [--out build/galsim]

Each of the 28 ground-truth scenes (benchmark/galsim.SCENES) is rendered
by the independent truth renderer, inferred end to end on the card in
float64 (one_node_joint_infer, or one_node_single_infer with --single) and
scored against its truth; then the noisy-by-design scenes are run again
without noise, the deterministic gate (0 violations of the reference's
tolerances). Writes galsim_results.md (field scores, both gates, the
uncertainty table, every source's truth and estimate) and
galsim_results.csv under --out, and prints, as its last line, one JSON
object: the field scores, the violations of both gates, the
misclassified sources, the wall seconds, K1-K3's launches and the card's
name and power limit. main(argv, device="cpu") runs it on the CPU.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..utils import telemetry
from ..utils.device import resolve
from . import accuracy as ab
from .galsim import (SCENES, SCENES_BY_NAME, estimate_violations,
                     run_benchmarks, truth_comparison_df)


def card_name_and_power_limit(device):
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else torch.cuda.get_device_name(device)


def _scene_of(objids):
    return np.array([o.rsplit("_", 1)[0] for o in objids], dtype=object)


def run_suite(names=None, joint=True, radius=40.0, *, device="cuda",
              dtype=torch.float64, plain=False, config=None,
              newton_config=None):
    """The suite as run_galsim_suite.py runs it: the scenes as defined,
    then the noisy ones without noise. Returns a dict: truth_df, pred_df,
    scores (objid-aligned), matched_scores (position-matched), the
    violations as defined and noise-free, the uncertainty table, the
    misclassified sources, the walls and K1-K3's launches."""
    names = list(names) if names is not None else [s.name for s in SCENES]
    kw = dict(joint_inference=joint, min_radius_pix=radius, device=device,
              dtype=dtype, plain=plain, config=config,
              newton_config=newton_config)
    telemetry.fit_kernel_launches(reset=True)
    t0 = time.perf_counter()
    truth_df, pred_df = run_benchmarks(names, **kw)
    wall = time.perf_counter() - t0

    err = ab.get_error_df(truth_df, pred_df)
    scores = ab.get_scores_df(truth_df, err)
    matched_scores = ab.score_predictions(truth_df, [pred_df])
    try:
        unc = ab.score_uncertainty(
            ab.get_uncertainty_df(truth_df, pred_df, aligned=True))
    except (ValueError, AssertionError):
        unc = None
    violations = estimate_violations(truth_comparison_df(truth_df, pred_df))

    # the noise-free gate: noisy-by-design scenes re-run with noise off
    noisy = [n for n in names if SCENES_BY_NAME[n].include_noise]
    nf_violations, nf_wall = [], 0.0
    if noisy:
        t1 = time.perf_counter()
        t_nf, p_nf = run_benchmarks(noisy, force_noise_free=True, **kw)
        nf_wall = time.perf_counter() - t1
        quiet = ~np.isin(_scene_of(truth_df["objid"]), noisy)
        nf_violations = estimate_violations(truth_comparison_df(
            ab.concat([truth_df[quiet], t_nf]),
            ab.concat([pred_df[quiet], p_nf])))
    missed = [str(o) for o, t, p in zip(truth_df["objid"],
                                         truth_df["is_star"],
                                         pred_df["is_star"])
              if (t > 0.5) != (p > 0.5)]
    return dict(names=names, joint=joint, radius=radius,
                truth_df=truth_df, pred_df=pred_df, scores=scores,
                matched_scores=matched_scores, uncertainty=unc,
                violations=violations, nf_violations=nf_violations,
                missed=missed, wall_s=wall, nf_wall_s=nf_wall,
                launches=telemetry.fit_kernel_launches())


def _violation_text(bad):
    return "; ".join(f"{o}.{v} truth={t:.3f} est={e:.3f}"
                     for o, v, t, e, _ in bad[:20])


def write_results(res, outdir, device_text):
    """galsim_results.md and galsim_results.csv under outdir."""
    os.makedirs(outdir, exist_ok=True)
    truth_df, pred_df = res["truth_df"], res["pred_df"]
    merged = ab.Table({"objid": truth_df["objid"]})
    cols = ("is_star", "flux_r_nmgy", "gal_axis_ratio", "gal_radius_px",
            "gal_angle_deg")
    for c in cols:
        merged[f"true_{c}"] = truth_df[c]
    for c in cols:
        merged[f"est_{c}"] = pred_df[c]
    csv_path = os.path.join(outdir, "galsim_results.csv")
    merged.to_csv(csv_path)
    md_path = os.path.join(outdir, "galsim_results.md")
    with open(md_path, "w") as f:
        f.write("# GalSim-style accuracy suite results "
                "(celeste_jl_tpu_torch)\n\n")
        f.write(f"{len(res['names'])} scenes, {len(truth_df)} sources, "
                f"{'joint' if res['joint'] else 'single'} inference, "
                f"float64 on {device_text}, {res['wall_s']:.1f}s wall "
                f"(noise-free rerun {res['nf_wall_s']:.1f}s).\n\n")
        f.write("## Field scores (mean abs error over sources "
                "with that field defined; objid-aligned rows)\n\n")
        f.write(res["scores"].to_markdown())
        f.write(f"\n\nReference tolerance gate "
                f"(disabled_test_galsim_benchmarks.jl), scenes as defined "
                f"(incl. noisy), radius {res['radius']:.0f}px: "
                f"{len(res['violations'])} violations"
                + (" — " + _violation_text(res["violations"])
                   if res["violations"] else "") + "\n")
        f.write(f"\nNOISE-FREE gate (noisy-by-design scenes re-run with "
                f"noise off — the deterministic bar): "
                f"{len(res['nf_violations'])} violations"
                + (" — " + _violation_text(res["nf_violations"])
                   if res["nf_violations"] else "") + "\n")
        f.write(f"\nStar/galaxy misclassifications: {len(res['missed'])}"
                + (" — " + ", ".join(res["missed"]) if res["missed"]
                   else "") + "\n")
        if res["uncertainty"] is not None:
            f.write("\n## Posterior uncertainty (fraction of errors within "
                    "k posterior std errs; noise-free scenes included, so "
                    "not a calibration measurement)\n\n")
            f.write(res["uncertainty"].to_markdown())
        f.write("\n\n## Per-source truth vs estimate\n\n")
        f.write(merged.to_markdown(floatfmt=".3f"))
        f.write("\n")
    return md_path, csv_path


def summary(res, device_text):
    """The run's one-line JSON record."""
    scores = res["scores"]
    return {
        "metric": "galsim_suite",
        "scenes": len(res["names"]),
        "sources": len(res["truth_df"]),
        "joint": res["joint"],
        "radius_px": res["radius"],
        "field_scores": {str(f): {"N": int(n), "mean_abs_err": float(m)}
                         for f, n, m in zip(scores["field"], scores["N"],
                                            scores["first"])},
        "violations": len(res["violations"]),
        "violation_rows": [list(v[:2]) for v in res["violations"]],
        "noise_free_violations": len(res["nf_violations"]),
        "noise_free_violation_rows": [list(v[:2])
                                      for v in res["nf_violations"]],
        "missed": len(res["missed"]),
        "wall_s": res["wall_s"],
        "noise_free_wall_s": res["nf_wall_s"],
        "launches": res["launches"],
        "device": device_text,
    }


def main(argv=None, *, device="cuda"):
    ap = argparse.ArgumentParser(
        prog="celeste_jl_tpu_torch.benchmark.galsim_suite",
        description="The GalSim-style accuracy suite on the port.")
    ap.add_argument("--joint", dest="joint", action="store_true",
                    default=True, help="joint (deblended) inference (default)")
    ap.add_argument("--single", dest="joint", action="store_false",
                    help="per-source single inference")
    ap.add_argument("--scenes", default=None,
                    help="comma-separated subset of scene names")
    ap.add_argument("--out", default=os.path.join("build", "galsim"),
                    help="output directory (default build/galsim)")
    ap.add_argument("--radius", type=float, default=40.0,
                    help="min active radius in px (the reference forces 40, "
                         "ACTIVE_PIXELS_MIN_RADIUS_PX)")
    args = ap.parse_args(argv)
    resolve(device)
    names = args.scenes.split(",") if args.scenes else None
    res = run_suite(names, joint=args.joint, radius=args.radius,
                    device=device)
    device_text = card_name_and_power_limit(device)
    md_path, csv_path = write_results(res, args.out, device_text)
    # every scene has its own sky, so position matching must find the
    # objid-aligned rows: a different N means a match across scenes
    aligned_n = dict(zip(res["scores"]["field"], res["scores"]["N"]))
    for f, n in zip(res["matched_scores"]["field"],
                    res["matched_scores"]["N"]):
        if f in aligned_n and n != aligned_n[f]:
            print(f"WARNING: matched-vs-aligned N mismatch for {f}: {n} vs "
                  f"{aligned_n[f]}", flush=True)
    for v in res["violations"]:
        print("VIOLATION:", v, flush=True)
    for v in res["nf_violations"]:
        print("NF-VIOLATION:", v, flush=True)
    print(f"wrote {md_path} and {csv_path}", flush=True)
    print(json.dumps(summary(res, device_text)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
