"""GalSim scenes through the JAX package and the PyTorch port on the CPU, in
float64, side by side: each source's ELBO, Newton iterations, P(star),
r-band flux, axis ratio and radius, from the same rendered images and the
same initialisation catalog, with one_node_joint_infer's defaults at
radius 40 (as benchmark/run_galsim_suite.py runs the suite).

    python3 tools/galsim_parity.py [--scenes simple_star,galaxy_with_all]
        [--pjacobi]

--pjacobi runs the port with the card's float64 solver
(parallel/run.card_newton_config: pjacobi, through the plain twins)
instead of eig. Needs JAX (the reference); takes
about a minute a scene.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="simple_star,galaxy_with_all")
    ap.add_argument("--pjacobi", action="store_true")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from celeste_jl_tpu.benchmark import galsim as jgs
    from celeste_jl_tpu.parallel.run import one_node_joint_infer as jjoint
    from celeste_jl_tpu.utils.config import Config as JaxConfig
    from celeste_jl_tpu_torch import convert
    from celeste_jl_tpu_torch.models.params import ids
    from celeste_jl_tpu_torch.ops.newton import NewtonConfig
    from celeste_jl_tpu_torch.parallel.run import (card_newton_config,
                                                   one_node_joint_infer)
    from celeste_jl_tpu_torch.utils.config import Config

    torch.set_num_threads(1)
    newton = (card_newton_config(NewtonConfig(), torch.float64)
              if args.pjacobi else NewtonConfig())
    for name in args.scenes.split(","):
        images, truth = jgs.render_scene(jgs.SCENES_BY_NAME[name])
        init = jgs.make_initialization_catalog(truth)
        want = jjoint(init, images, config=JaxConfig(min_radius_pix=40.0))
        got = one_node_joint_infer(
            convert.catalog(init), convert.images(images),
            config=Config(min_radius_pix=40.0), newton_config=newton,
            device="cpu", dtype=torch.float64)
        for i, (g, w) in enumerate(zip(got, want)):
            row = []
            for label, r in (("jax", w), ("port", g)):
                vs = np.asarray(r.vs)
                k = 0 if vs[ids.is_star[0]] > 0.5 else 1
                row.append(
                    f"{label}: elbo {r.elbo:.10f}, P(star) "
                    f"{vs[ids.is_star[0]]:.10f}, r-flux "
                    f"{np.exp(vs[ids.flux_loc[k]]):.8f}, axis ratio "
                    f"{vs[ids.gal_axis_ratio]:.8f}, radius "
                    f"{vs[ids.gal_radius_px]:.8f}")
            print(f"{name}_{i:03d} ({'pjacobi' if args.pjacobi else 'eig'}): "
                  + "; ".join(row) + f"; ELBO rel (port - jax) "
                  f"{(g.elbo - w.elbo) / abs(w.elbo):.3g}", flush=True)


if __name__ == "__main__":
    main()
