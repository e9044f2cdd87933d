"""Console entry point and config file reader (port of
celeste_jl_tpu/main.py; main.jl).

`python -m celeste_jl_tpu_torch <datasets> <ramin> <ramax> <decmin> <decmax>
 [--config celeste.yml] [--method joint_vi] [--outdir .]
 [--detect-thresh 1.3]`

The config schema is the reference's (main.jl:12-44): universal keys
(min_radius_pix, num_ais_temperatures, num_ais_samples, num_joint_vi_iters)
plus `datasets.sdss.{basedir, dirlayout, slurp, compressed}` and
`datasets.decals.basedir`. The file is read by `load_yaml`, a reader of the
YAML subset the schema uses, so PyYAML is not needed. Results are saved as
celeste-<ramin>-<ramax>-<decmin>-<decmax>.npz in the JAX package's format.

The CLI runs on the card, in float64: survey world coordinates (~150 deg,
with 1e-7-deg position boxes) do not survive float32. `main(argv,
device="cpu")` runs the same path on the CPU.
"""

import argparse
import os
import re

import numpy as np
import torch

from .io.dataset import BoundingBox
from .parallel.run import OptimizedSource, infer_box
from .utils import log as Log
from .utils.config import Config
from .utils.device import resolve

# PyYAML's (YAML 1.1) implicit scalar types, the part the schema can use
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": np.inf, ".Inf": np.inf, ".INF": np.inf,
                  "+.inf": np.inf, "+.Inf": np.inf, "+.INF": np.inf,
                  "-.inf": -np.inf, "-.Inf": -np.inf, "-.INF": -np.inf,
                  ".nan": np.nan, ".NaN": np.nan, ".NAN": np.nan}
_KEY = re.compile(r"""("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^'"#:][^:#]*?)"""
                  r"\s*:(?:\s+(.*))?$")


def _strip_comment(line):
    """The line without its comment (a # after a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text):
    text = text.strip()
    if text[:1] == "'" and text[-1:] == "'" and len(text) > 1:
        return text[1:-1].replace("''", "'")
    if text[:1] == '"' and text[-1:] == '"' and len(text) > 1:
        return text[1:-1].encode().decode("unicode_escape")
    if text[:1] in "[{|>&*!" or text == "-" or text.startswith("- "):
        raise ValueError(f"unsupported YAML value {text!r} (the reader "
                         "takes block mappings of plain scalars)")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    return text


def load_yaml(text):
    """Parse the YAML subset of celeste.yml: nested block mappings by
    indentation, with int, float, bool, null and (plain or quoted) string
    values, and comments. Returns what yaml.safe_load returns on such a
    document; anything else (sequences, flow style, anchors, block
    scalars) raises ValueError."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError("tabs do not indent YAML")
        lines.append((len(line) - len(body), body))
    root = {}
    stack = [(-1, root)]     # (indent, mapping)
    for i, (indent, body) in enumerate(lines):
        while indent <= stack[-1][0]:
            stack.pop()
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"unsupported YAML line {body!r}")
        key = _scalar(m.group(1))
        rest = m.group(2)
        parent = stack[-1][1]
        if key in parent:
            raise ValueError(f"duplicate YAML key {key!r}")
        nested = i + 1 < len(lines) and lines[i + 1][0] > indent
        if rest is None or not rest.strip():
            if nested:
                parent[key] = {}
                stack.append((indent, parent[key]))
            else:
                parent[key] = None
        else:
            if nested:
                raise ValueError(f"YAML key {key!r} has a value and a block")
            parent[key] = _scalar(rest)
    return root or None


def read_config(filename, *, device="cuda"):
    """Config file -> (Config, {name: SurveyDataSet}) (main.jl:12-44). The
    SDSS dataset fits its PSFs on `device`."""
    with open(filename) as f:
        data = load_yaml(f.read()) or {}

    cfg_keys = ["min_radius_pix", "num_ais_temperatures",
                "num_ais_samples", "num_joint_vi_iters"]
    cfg = Config(**{k: data[k] for k in cfg_keys if k in data})

    datasets = {}
    for name, ds_cfg in (data.get("datasets") or {}).items():
        if name == "sdss":
            from .io.sdss import SDSSDataSet
            datasets[name] = SDSSDataSet(
                ds_cfg["basedir"],
                dirlayout=ds_cfg.get("dirlayout", "celeste"),
                compressed=ds_cfg.get("compressed", False),
                slurp=ds_cfg.get("slurp", False), device=device)
        elif name == "decals":
            from .io.decals import DECALSDataSet
            datasets[name] = DECALSDataSet(ds_cfg["basedir"])
        else:
            raise ValueError(f"unrecognized dataset name: {name}")
    return cfg, datasets


def save_results(outdir, box: BoundingBox, results):
    """OptimizedSource records -> one npz per sky box (main.jl:50-56), in
    the JAX package's format. Resume granularity is the box."""
    if any(not isinstance(r, OptimizedSource) for r in results):
        # --method mcmc returns AIS records, which this format has no
        # fields for (the JAX package's save_results fails on them too)
        raise TypeError("save_results takes OptimizedSource records")
    os.makedirs(outdir, exist_ok=True)
    fname = os.path.join(
        outdir, f"celeste-{box.ramin:.4f}-{box.ramax:.4f}"
                f"-{box.decmin:.4f}-{box.decmax:.4f}.npz")
    np.savez(
        fname,
        init_pos=np.stack([r.init_pos for r in results])
        if results else np.zeros((0, 2)),
        vs=np.stack([r.vs for r in results]) if results
        else np.zeros((0, 44)),
        elbo=np.array([r.elbo for r in results]),
        converged=np.array([r.converged for r in results]),
        is_sky_bad=np.array([r.is_sky_bad for r in results]))
    return fname


def load_results(fname):
    d = np.load(fname)
    return [OptimizedSource(init_pos=d["init_pos"][i], vs=d["vs"][i],
                            elbo=float(d["elbo"][i]),
                            converged=bool(d["converged"][i]),
                            is_sky_bad=bool(d["is_sky_bad"][i]))
            for i in range(d["vs"].shape[0])]


def main(argv=None, *, device="cuda"):
    """The CLI: load the box's images, infer, save. Runs on `device` (the
    card unless the caller asks for the CPU), in float64."""
    parser = argparse.ArgumentParser(
        prog="infer-box",
        description="Infer a catalog for one RA/Dec box of the sky.")
    parser.add_argument("datasets",
                        help="comma-separated dataset names from the config")
    parser.add_argument("ramin", type=float)
    parser.add_argument("ramax", type=float)
    parser.add_argument("decmin", type=float)
    parser.add_argument("decmax", type=float)
    parser.add_argument("--config", default="celeste.yml",
                        help="YAML configuration file")
    parser.add_argument("--method", default="joint_vi",
                        choices=["joint_vi", "single_vi", "svi", "mcmc"])
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--detect-thresh", type=float, default=1.3,
                        help="detection threshold in sky-noise sigmas "
                             "(detection.jl uses 1.3)")
    args = parser.parse_args(argv)
    resolve(device)

    config, known = read_config(args.config, device=device)
    box = BoundingBox(args.ramin, args.ramax, args.decmin, args.decmax)

    images = []
    for name in args.datasets.split(","):
        images.extend(known[name].load_images(box))
    Log.info(f"loaded {len(images)} images for box {box}")

    boxsize = (min(256, images[0].H), min(256, images[0].W)) if images \
        else (256, 256)
    results = infer_box(images, box=box, method=args.method, config=config,
                        thresh=args.detect_thresh, boxsize=boxsize,
                        device=device, dtype=torch.float64)
    fname = save_results(args.outdir, box, results)
    Log.info(f"saved {len(results)} sources to {fname}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
