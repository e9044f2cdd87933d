"""The port's survey app (main.py: read_config, save_results, load_results,
main) against the JAX package's, f64 on the CPU:

- read_config: its YAML reader against yaml.safe_load on the test configs,
  the same Config and datasets as tests/test_main.py expects, with the
  yaml module made unimportable; an unknown dataset raises;
- save_results / load_results: each package reads the other's file;
- main(argv, device="cpu") against the JAX package's main on
  tests/sdss_fixtures.make_sdss_field's field with single_vi: the same
  sources, init_pos equal, the same classifications, ELBOs within 1e-4
  relative (ROADMAP's fit bar);
- main asked for the card without one raises before it reads anything.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

from celeste_jl_tpu.io.dataset import BoundingBox as JaxBox
from celeste_jl_tpu.main import load_results as jax_load_results
from celeste_jl_tpu.main import main as jax_main
from celeste_jl_tpu.main import save_results as jax_save_results
from celeste_jl_tpu.parallel.run import OptimizedSource as JaxSource
from celeste_jl_tpu_torch.io.dataset import BoundingBox
from celeste_jl_tpu_torch.io.sdss import SDSSDataSet
from celeste_jl_tpu_torch.main import (load_results, load_yaml, main,
                                       read_config, save_results)
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.parallel.run import OptimizedSource
from sdss_fixtures import make_sdss_field

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

CONFIGS = [
    # tests/test_main.py's, through yaml.safe_dump
    {"min_radius_pix": 9.0, "num_joint_vi_iters": 2, "num_ais_samples": 7,
     "datasets": {"sdss": {"basedir": "/data/sdss"}}},
    {"datasets": {"hubble": {"basedir": "x"}}},
    {"num_ais_temperatures": 20, "datasets": {
        "sdss": {"basedir": "http://127.0.0.1:8000/sdss", "dirlayout": "sdss",
                 "compressed": True, "slurp": False},
        "decals": {"basedir": "/data/decals dr7"}}},
]
HAND_WRITTEN = """\
# celeste.yml
min_radius_pix: 8      # px
num_joint_vi_iters: 3
flag: on
ratio: 1.0e+3
exponent_without_dot: 1e3
quoted: 'it''s'
datasets:
    sdss:
        basedir: "/data/sdss"   # the survey files
        compressed: false
        dirlayout: celeste
"""


@pytest.mark.parametrize("doc", [yaml.safe_dump(c) for c in CONFIGS]
                         + [HAND_WRITTEN])
def test_yaml_reader_matches_safe_load(doc):
    assert load_yaml(doc) == yaml.safe_load(doc)


def test_yaml_reader_refuses_what_it_does_not_read():
    for doc in ("a:\n  - 1\n  - 2\n", "a: [1, 2]\n", "a: {b: 1}\n",
                "a: &x 1\n", "a: |\n  text\n"):
        with pytest.raises(ValueError):
            load_yaml(doc)


def _write_config(path, basedir, **extra):
    cfg = {"min_radius_pix": 9.0, "num_joint_vi_iters": 2,
           "datasets": {"sdss": {"basedir": str(basedir)}}}
    cfg.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def test_read_config_without_yaml(tmp_path, monkeypatch):
    _write_config(tmp_path / "celeste.yml", tmp_path / "data",
                  num_ais_samples=7)
    with open(tmp_path / "bad.yml", "w") as f:
        yaml.safe_dump({"datasets": {"hubble": {"basedir": "x"}}}, f)
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml fails
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    cfg, datasets = read_config(tmp_path / "celeste.yml", device="cpu")
    assert cfg.min_radius_pix == 9.0
    assert cfg.num_joint_vi_iters == 2
    assert cfg.num_ais_samples == 7
    assert cfg.num_ais_temperatures == 50  # default preserved
    assert isinstance(datasets["sdss"], SDSSDataSet)
    assert datasets["sdss"].dirlayout == "celeste"
    assert datasets["sdss"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="hubble"):
        read_config(tmp_path / "bad.yml", device="cpu")


def test_results_files_cross_read(tmp_path):
    rng = np.random.default_rng(2)
    recs = [(rng.normal(size=2), rng.normal(size=44), float(-100 - i),
             bool(i % 2), bool(i == 1)) for i in range(3)]
    box = (1.0, 2.0, 3.0, 4.0)
    mine = save_results(tmp_path / "port", BoundingBox(*box),
                        [OptimizedSource(*r) for r in recs])
    theirs = jax_save_results(tmp_path / "jax", JaxBox(*box),
                              [JaxSource(*r) for r in recs])
    assert os.path.basename(mine) == os.path.basename(theirs) == \
        "celeste-1.0000-2.0000-3.0000-4.0000.npz"
    for fname in (mine, theirs):
        for loaded in (load_results(fname), jax_load_results(fname)):
            assert len(loaded) == 3
            for got, want in zip(loaded, recs):
                np.testing.assert_array_equal(got.init_pos, want[0])
                np.testing.assert_array_equal(got.vs, want[1])
                assert (got.elbo, got.converged, got.is_sky_bad) == want[2:]
    empty = save_results(tmp_path / "empty", BoundingBox(*box), [])
    assert jax_load_results(empty) == []
    with pytest.raises(TypeError):
        save_results(tmp_path / "mcmc", BoundingBox(*box), [{"objid": "x"}])


def test_main_matches_jax_on_the_fixture_field(tmp_path):
    base = tmp_path / "sdss"
    rcf, truth, wcs = make_sdss_field(base)
    _write_config(tmp_path / "celeste.yml", base)
    lo = wcs.pix_to_world([10.0, 10.0])
    hi = wcs.pix_to_world([90.0, 60.0])
    argv = ["sdss", str(min(lo[0], hi[0])), str(max(lo[0], hi[0])),
            str(min(lo[1], hi[1])), str(max(lo[1], hi[1])),
            "--config", str(tmp_path / "celeste.yml"),
            "--method", "single_vi", "--detect-thresh", "8.0"]
    # outdir not pre-created: save_results makes it
    out = tmp_path / "out" / "nested"
    assert main(argv + ["--outdir", str(out / "port")], device="cpu") == 0
    assert jax_main(argv + ["--outdir", str(out / "jax")]) == 0
    (got_file,) = (out / "port").glob("celeste-*.npz")
    (want_file,) = (out / "jax").glob("celeste-*.npz")
    assert got_file.name == want_file.name
    got, want = load_results(got_file), jax_load_results(want_file)
    assert len(got) == len(want) == len(truth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.init_pos, w.init_pos)
        assert (g.vs[ids.is_star[0]] > 0.5) == (w.vs[ids.is_star[0]] > 0.5)
        assert np.isfinite(g.elbo)
        assert abs(g.elbo - w.elbo) <= 1e-4 * abs(w.elbo), (g.elbo, w.elbo)
        assert g.is_sky_bad == w.is_sky_bad


def test_main_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["sdss", "1", "2", "3", "4", "--config",
              str(tmp_path / "absent.yml")])
