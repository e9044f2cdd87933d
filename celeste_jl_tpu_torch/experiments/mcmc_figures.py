"""Tables and figures of an MCMC-vs-VI experiment run (the port's
counterpart of experiments/mcmc_figures.py; the reference's
make_mcmc_results_figures.py).

    python -m celeste_jl_tpu_torch.experiments.mcmc_figures \
        [--results-dir build/mcmc_experiment]

Reads the CSVs of experiments/mcmc_experiment.py (the port's or the JAX
package's) and writes into the same directory:

- calibration.csv           within-k-sigma fractions of both posteriors
- error_comparison.png      per-field mean |error| of VI and MCMC
- pstar_roc_comparison.png  star/galaxy ROC from each method's P(star)
- posterior_comparison.png  MCMC log-flux histograms and the VI Gaussian

The figures are drawn where matplotlib imports; where it does not, one
line names the figures left undrawn, and the tables are written all the
same. Chart conventions as the JAX package's: one axis a panel, two fixed
series hues (VI #2a78d6, MCMC #eb6834), a recessive grey grid.
"""

import argparse
import os

import numpy as np

from ..benchmark.accuracy import (concat, get_uncertainty_df,
                                  match_catalogs, read_csv,
                                  score_predictions, score_uncertainty)

VI_COLOR = "#2a78d6"
MC_COLOR = "#eb6834"
INK = "#3d3d3a"
GRID = "#e3e2da"

ERROR_FIELDS = ["position", "flux_r_mag", "color_ug", "color_gr",
                "color_ri", "color_iz", "gal_frac_dev", "gal_axis_ratio",
                "gal_radius_px", "gal_angle_deg"]
FIGURES = ("error_comparison.png", "pstar_roc_comparison.png",
           "posterior_comparison.png")


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _style(ax):
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=INK, labelsize=8)
    ax.grid(True, color=GRID, linewidth=0.6)
    ax.set_axisbelow(True)


def make_error_comparison(truth, vi_df, mc_df, out_png=None):
    """Mean |error| per field of VI and MCMC on the matched sources
    (make_mcmc_results_figures.py:177-310); drawn into out_png if given
    and matplotlib imports. Returns the scores Table."""
    scores = score_predictions(truth, [vi_df, mc_df])
    scores = scores[np.isin(scores["field"].astype(str), ERROR_FIELDS)]
    plt = _pyplot() if out_png else None
    if plt is None:
        return scores
    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=200)
    y = np.arange(len(scores))
    ax.hlines(y, scores["first"], scores["second"], color=GRID,
              linewidth=1.2, zorder=1)
    ax.scatter(scores["first"], y, s=34, color=VI_COLOR, zorder=2,
               label="VI")
    ax.scatter(scores["second"], y, s=34, color=MC_COLOR, zorder=2,
               label="MCMC")
    ax.set_yticks(y, list(scores["field"]))
    ax.set_xlabel("mean |error|  (matched sources)", color=INK, fontsize=9)
    ax.invert_yaxis()
    _style(ax)
    ax.legend(frameon=False, fontsize=8, loc="lower right")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return scores


def _roc(is_star, score):
    order = np.argsort(-score)
    tp = np.cumsum(is_star[order])
    fp = np.cumsum(~is_star[order])
    tpr = np.r_[0.0, tp / max(is_star.sum(), 1)]
    fpr = np.r_[0.0, fp / max((~is_star).sum(), 1)]
    # the trapezoid rule (numpy's trapezoid, named trapz before numpy 2)
    auc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))
    return fpr, tpr, auc


def make_roc(truth, vi_df, mc_df, out_png=None):
    """Star/galaxy ROC from P(star) of both methods
    (make_mcmc_results_figures.py:395-422). Returns {method: AUC}."""
    m_truth, (m_vi, m_mc) = match_catalogs(truth, [vi_df, mc_df])
    is_star = m_truth["is_star"] > 0.5
    curves = {name: _roc(is_star, df["is_star"].astype(float))
              for name, df in (("VI", m_vi), ("MCMC", m_mc))}
    plt = _pyplot() if out_png else None
    if plt is not None:
        fig, ax = plt.subplots(figsize=(4.2, 4.0), dpi=200)
        for (name, (fpr, tpr, auc)), c in zip(curves.items(),
                                              (VI_COLOR, MC_COLOR)):
            ax.plot(fpr, tpr, color=c, linewidth=2,
                    label=f"{name}  (AUC {auc:.3f})", drawstyle="steps-post")
        ax.plot([0, 1], [0, 1], color=GRID, linewidth=1, linestyle="--")
        ax.set_xlabel("False positive rate", color=INK, fontsize=9)
        ax.set_ylabel("True positive rate", color=INK, fontsize=9)
        _style(ax)
        ax.legend(frameon=False, fontsize=8, loc="lower right")
        fig.savefig(out_png, bbox_inches="tight")
        plt.close(fig)
    return {name: c[2] for name, c in curves.items()}


def make_calibration_table(truth, vi_df, mc_df, out_csv=None):
    """Within-k-sigma fractions of both posteriors
    (make_mcmc_results_figures.py:32-57), written to out_csv if given."""
    tables = []
    for name, df in (("vi", vi_df), ("mc", mc_df)):
        t = score_uncertainty(get_uncertainty_df(truth, df))
        t.insert(0, "method", name)
        tables.append(t)
    out = concat(tables)
    if out_csv:
        out.to_csv(out_csv)
    return out


def make_posterior_comparison(samples_npz, vi_post_csv, mc_df, out_png,
                              max_sources=4):
    """MCMC log-flux histograms against the VI Gaussian posterior of the
    first few sources (make_mcmc_results_figures.py:449-507); needs
    matplotlib. Returns whether it drew."""
    plt = _pyplot()
    if plt is None:
        return False
    samples = np.load(samples_npz)
    vi_post = read_csv(vi_post_csv)
    n = min(max_sources, len(vi_post), len(mc_df))
    fig, axes = plt.subplots(1, n, figsize=(3.0 * n, 2.6), dpi=200,
                             squeeze=False)
    for i in range(n):
        ax = axes[0][i]
        is_star = float(mc_df["is_star"][i]) > 0.5
        lnf = samples[f"{'star' if is_star else 'gal'}_{i}"][:, 2]
        ax.hist(lnf, bins=30, density=True, color=MC_COLOR, alpha=0.45,
                label="MCMC" if i == 0 else None)
        mu = float(vi_post["log_flux_r_mean"][i])
        sd = max(float(vi_post["log_flux_r_stderr"][i]), 1e-6)
        xs = np.linspace(min(lnf.min(), mu - 4 * sd),
                         max(lnf.max(), mu + 4 * sd), 200)
        ax.plot(xs, np.exp(-0.5 * ((xs - mu) / sd) ** 2)
                / (sd * np.sqrt(2 * np.pi)),
                color=VI_COLOR, linewidth=2, label="VI" if i == 0 else None)
        ax.set_xlabel(f"src {i}: log flux_r", color=INK, fontsize=8)
        ax.set_yticks([])
        _style(ax)
    axes[0][0].legend(frameon=False, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(
        description="tables and figures of an MCMC-vs-VI experiment run")
    p.add_argument("--results-dir",
                   default=os.path.join("build", "mcmc_experiment"))
    args = p.parse_args(argv)
    d = args.results_dir

    truth = read_csv(os.path.join(d, "truth.csv"))
    vi_df = read_csv(os.path.join(d, "vi.csv"))
    mc_df = read_csv(os.path.join(d, "mc.csv"))
    scores = make_error_comparison(truth, vi_df, mc_df,
                                   os.path.join(d, FIGURES[0]))
    aucs = make_roc(truth, vi_df, mc_df, os.path.join(d, FIGURES[1]))
    calib = make_calibration_table(truth, vi_df, mc_df,
                                   os.path.join(d, "calibration.csv"))
    drew = make_posterior_comparison(os.path.join(d, "mc_samples.npz"),
                                     os.path.join(d, "vi_posterior.csv"),
                                     mc_df, os.path.join(d, FIGURES[2]))
    print(scores.to_markdown(floatfmt=".6g"))
    print({"auc": aucs})
    print(calib.to_markdown(floatfmt=".6g"))
    if not drew:
        print(f"matplotlib is not installed: did not draw "
              f"{', '.join(FIGURES)}", flush=True)
    return dict(scores=scores, auc=aucs, calibration=calib, drew=drew)


if __name__ == "__main__":
    main()
