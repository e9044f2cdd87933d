"""Turn celeste-<box>.npz result files into one FITS binary-table catalog
(the port's counterpart of tools/results_to_fits.py; the reference's
contrib/nersc/optimized_sources_to_fits.jl).

    python -m celeste_jl_tpu_torch.results_to_fits out/celeste-*.npz \
        -o catalog.fits

Reads the per-box result files (main.save_results's, the port's or the
JAX package's: the format is the same), maps each good-sky source's
variational parameters to catalog quantities (position, star/galaxy
probability, fluxes and colors with their standard errors, galaxy shape;
accuracy.celeste_to_df), adds each row's box file, convergence flag and
ELBO, and writes one FITS bintable (io/fits.write_fits). Host-only: it
reads and writes files and runs no kernel.
"""

import argparse
import os


from .benchmark.accuracy import celeste_to_df, concat
from .io.fits import write_fits
from .main import load_results


def results_to_fits(npz_paths, out_path):
    """Writes the catalog of `npz_paths` to out_path; returns its rows."""
    frames = []
    for p in npz_paths:
        results = [r for r in load_results(p) if not r.is_sky_bad]
        df = celeste_to_df(results)
        df["box_file"] = [os.path.basename(p)] * len(results)
        df["converged"] = [r.converged for r in results]
        df["elbo"] = [r.elbo for r in results]
        frames.append(df)
    cat = concat(frames) if frames else None
    if cat is None or not len(cat):
        raise SystemExit("no (good-sky) sources in the given result files")

    columns = {}
    for name in cat.columns:
        col = cat[name]
        if col.dtype == object:
            col = col.astype("U32")
        columns[name] = col
    write_fits(out_path, [(None, [("NSRC", int(len(cat)), "sources")]),
                          (columns, [("EXTNAME", "CATALOG", "")])])
    return len(cat)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="celeste-<box>.npz result files -> FITS catalog")
    ap.add_argument("npz", nargs="+", help="result files (celeste-*.npz)")
    ap.add_argument("-o", "--out", required=True, help="output FITS path")
    args = ap.parse_args(argv)
    n = results_to_fits(args.npz, args.out)
    print(f"wrote {n} sources to {args.out}")
    return n


if __name__ == "__main__":
    main()
