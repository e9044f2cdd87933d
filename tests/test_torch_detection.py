"""The port's detection, coordinate matching and catalog init against the
JAX package's, on the same numpy inputs (both are numpy/scipy code: the
outputs must agree to rounding, positions to 1e-12).

- Background mesh, back() and rms() to 1e-12;
- extract with the native and the scipy labelling: the same catalog;
- detect_sources on a 60x60 two-source scene: the same catalog and
  detection boxes; a blank image gives an empty catalog;
- match_coordinates and catalog_init_source: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from celeste_jl_tpu.detection import _native as jax_native
from celeste_jl_tpu.detection.background import Background as JaxBackground
from celeste_jl_tpu.detection.detect import detect_sources as jax_detect
from celeste_jl_tpu.detection.extract import extract as jax_extract
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.utils.coordinates import (
    match_coordinates as jax_match)
from celeste_jl_tpu.vi.init import catalog_init_source as jax_init
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.detection import _native
from celeste_jl_tpu_torch.detection.background import Background
from celeste_jl_tpu_torch.detection.detect import detect_sources
from celeste_jl_tpu_torch.detection.extract import extract
from celeste_jl_tpu_torch.utils.coordinates import match_coordinates
from celeste_jl_tpu_torch.vi.init import catalog_init_source

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _blob_field(seed, H=96, W=80, n=6):
    rng = np.random.default_rng(seed)
    ii, jj = np.mgrid[0:H, 0:W]
    data = 2.0 + 0.3 * rng.standard_normal((H, W))
    for cx, cy, s, f in zip(rng.uniform(5, H - 5, n), rng.uniform(5, W - 5, n),
                            rng.uniform(1.0, 3.0, n), rng.uniform(50, 400, n)):
        data += f * np.exp(-((ii + 1 - cx) ** 2 + (jj + 1 - cy) ** 2)
                           / (2 * s ** 2)) / (2 * np.pi * s ** 2)
    data[3, 7] = np.nan
    return data


def _assert_catalogs_equal(got, want):
    assert len(got) == len(want)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if np.asarray(b).dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_background_matches_jax():
    data = _blob_field(0)
    got = Background(data, boxsize=(32, 24))
    want = JaxBackground(data, boxsize=(32, 24))
    for name in ("mesh_back", "mesh_rms"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.back(), want.back(), rtol=1e-12)
    np.testing.assert_allclose(got.rms(), want.rms(), rtol=1e-12)
    assert got.global_rms() == pytest.approx(want.global_rms(), rel=1e-12)


@pytest.mark.parametrize("use_native", [True, False])
def test_extract_matches_jax(use_native):
    data = _blob_field(1)
    if use_native:
        assert _native.available() and jax_native.available()
    noise = JaxBackground(data, boxsize=(32, 32)).global_rms()
    got = extract(data, 3.0, noise=noise, use_native=use_native)
    want = jax_extract(data, 3.0, noise=noise, use_native=use_native)
    assert len(want) >= 3
    _assert_catalogs_equal(got, want)


def test_native_build_stays_outside_the_package():
    """The port builds its library under build/native/, never beside its
    source."""
    import os

    path = _native._build()
    assert os.path.dirname(path) == _native.BUILD_DIR
    native_dir = os.path.dirname(_native._SRC)
    assert os.listdir(native_dir) == ["sep_native.cpp"]


@pytest.fixture(scope="module")
def two_sources():
    images = make_blank_images(H=60, W=60, sky_nmgy=0.05,
                               nelec_per_nmgy=2000.0)
    bodies = [sample_star(pos=(18.0, 18.0), r_flux=15.0),
              sample_galaxy(pos=(42.0, 40.0), r_flux=25.0)]
    gen_images(images, bodies, seed=1)
    return images


def test_detect_sources_matches_jax(two_sources):
    images = two_sources
    kw = dict(thresh=6.0, boxsize=(60, 60), match_radius_deg=1.0)
    want, want_boxes = jax_detect(images, **kw)
    got, got_boxes = detect_sources(convert.images(images), **kw)
    assert len(want) == 2 and len(got) == 2
    assert got_boxes == want_boxes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.pos, w.pos, rtol=1e-12, atol=1e-12)
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, str):
                assert a == b
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f.name)


def test_detect_sources_blank_image_is_empty():
    images = convert.images(make_blank_images(H=40, W=40))
    catalog, boxes = detect_sources(images, thresh=6.0, boxsize=(40, 40),
                                    match_radius_deg=1.0)
    assert catalog == [] and boxes == []


def test_match_coordinates_matches_jax():
    rng = np.random.default_rng(5)
    ra1, dec1 = rng.uniform(10, 11, 40), rng.uniform(-1, 1, 40)
    ra2, dec2 = rng.uniform(10, 11, 70), rng.uniform(-1, 1, 70)
    idx, dist = match_coordinates(ra1, dec1, ra2, dec2)
    want_idx, want_dist = jax_match(ra1, dec1, ra2, dec2)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(dist, want_dist)


def test_catalog_init_source_matches_jax(two_sources):
    images = two_sources
    catalog, _ = jax_detect(images, thresh=6.0, boxsize=(60, 60),
                            match_radius_deg=1.0)
    catalog = catalog + [sample_star(pos=(3.0, 4.0), r_flux=0.05),
                         sample_galaxy(pos=(9.0, 2.0), r_flux=40.0,
                                       gal_radius_px=0.1)]
    for ce, pce in zip(catalog, convert.catalog(catalog)):
        np.testing.assert_array_equal(catalog_init_source(pce),
                                      jax_init(ce))
