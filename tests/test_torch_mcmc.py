"""The port's MCMC/AIS slice (celeste_jl_tpu_torch/mcmc) against the JAX
package: the batched log densities against JAX's vmapped ones on the same
targets (both JAX likelihood routes), the samplers against known answers,
and run_ais_batched on a two-source JAX scene, its chain densities held to
JAX's log posteriors draw by draw. JAX's samplers draw other random
numbers, so no test compares draws; none runs JAX's AIS or slice
programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from celeste_jl_tpu import synthetic as jsyn
from celeste_jl_tpu.mcmc import log_prob as jlp
from celeste_jl_tpu.mcmc.infer import potential_scale_reduction as jpsrf
from celeste_jl_tpu.models.patches import make_patches_batched as jpatches
from celeste_jl_tpu.mcmc.ais import sigmoid_schedule as jschedule
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.mcmc import ais, infer, log_prob, slice as tslice
from celeste_jl_tpu_torch.models.patches import make_patches_batched
from celeste_jl_tpu_torch.parallel.common import _tile_for_radius
from celeste_jl_tpu_torch.parallel.state import find_neighbors, patch_radii
from celeste_jl_tpu_torch.synthetic import gen_images_fast
from celeste_jl_tpu_torch.utils.config import Config
from celeste_jl_tpu_torch.vi.elbo import default_prior

F64 = torch.float64
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """The two-source scene of tests/test_mcmc.py:132-143, built by the JAX
    package (its batched renderer): a bright star and an extended galaxy."""
    images = jsyn.make_blank_images(H=60, W=60, sky_nmgy=0.1,
                                    nelec_per_nmgy=1000.0)
    star = jsyn.sample_star(pos=(15.0, 15.0), r_flux=25.0)
    gal = jsyn.sample_galaxy(pos=(42.0, 44.0), r_flux=40.0,
                             gal_radius_px=2.5, gal_axis_ratio=0.8)
    jsyn.gen_images_fast(images, [star, gal], seed=6)
    return images, [star, gal]


def _jax_targets(images, catalog, radius=8.0, tile=32):
    patches = jpatches(images, [c.pos for c in catalog],
                       [radius] * len(catalog), tile)
    return [jlp.make_source_target(p, image=images[0], entry_pos=c.pos)
            for p, c in zip(patches, catalog)]


def _lanes(rng, n_per, is_star):
    """n_per parameter vectors per source near the truth, the last two of
    each source outside the prior's support."""
    D = 7 if is_star else 11
    th = np.zeros((n_per, D))
    th[:, :5] = np.log(20.0) + rng.normal(0.0, 0.3, (n_per, 5))
    th[:, 5:7] = rng.uniform(0.2, 0.8, (n_per, 2))
    if not is_star:
        th[:, 7:11] = np.stack([rng.uniform(0.1, 0.9, n_per),
                                rng.uniform(0.3, 0.9, n_per),
                                rng.uniform(0.0, np.pi, n_per),
                                rng.uniform(0.5, 3.0, n_per)], 1)
        th[-1, 8] = 1.3           # axis ratio above 1
    th[-2, 5] = -0.1              # position outside the box
    return th


@pytest.mark.parametrize("fused", ["0", "1"])
def test_log_densities_match_jax(scene, fused, monkeypatch):
    monkeypatch.setenv("CELESTE_FUSED_MCMC", fused)
    images, catalog = scene
    jt = _jax_targets(images, catalog)
    tgt = convert.source_target(
        jax.tree.map(lambda *xs: np.stack(xs), *jt), "cpu", F64)
    src = np.repeat([0, 1], 4)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *[jt[s] for s in src])
    rng = np.random.default_rng(4)
    for is_star in (True, False):
        th = np.concatenate([_lanes(rng, 4, is_star) for _ in range(2)])
        kind = "star" if is_star else "gal"
        th_t, src_t = torch.tensor(th), torch.tensor(src)
        for name in ("loglike", "logprior", "logpost"):
            jf = jax.jit(jax.vmap(getattr(jlp, f"{kind}_{name}")))
            want = np.asarray(jf(jnp.asarray(th), jstack))
            got = getattr(log_prob, f"{kind}_{name}")(th_t, tgt,
                                                      src_t).numpy()
            fin = np.isfinite(want)
            assert np.array_equal(fin, np.isfinite(got)), (kind, name)
            if name != "loglike":
                assert np.all(np.isneginf(got[~fin])), (kind, name)
                assert (~fin).sum() == (2 if is_star else 4), (kind, name)
            # f64, the bar of tests/test_pallas_render.py:52
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10,
                                       err_msg=f"{kind}_{name}")
        want = np.asarray(jax.jit(jax.vmap(lambda t: jlp.logflux_logprior(
            t, is_star)))(jnp.asarray(th[:, :5])))
        got = log_prob.logflux_logprior(th_t[:, :5], is_star).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_merged_evaluator_matches_jax(scene, monkeypatch):
    """The AIS evaluator scores star and galaxy lanes, and m stacked copies
    of them, in one K4 call per evaluation; its (loglike, logprior) equal
    JAX's log densities lane by lane (f64, as above)."""
    from celeste_jl_tpu_torch.ops import render

    images, catalog = scene
    jt = _jax_targets(images, catalog)
    tgt = convert.source_target(
        jax.tree.map(lambda *xs: np.stack(xs), *jt), "cpu", F64)
    src = np.repeat([0, 1], 3)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *[jt[s] for s in src])
    rng = np.random.default_rng(12)
    ths = [np.concatenate([_lanes(rng, 3, s) for _ in range(2)])
           for s in (True, False)]
    want = []
    for kind, th in zip(("star", "gal"), ths):
        want.append([np.asarray(jax.jit(jax.vmap(getattr(
            jlp, f"{kind}_{name}")))(jnp.asarray(th), jstack))
            for name in ("loglike", "logprior")])
    calls = []
    ragged = render.mixture_poisson_ll_ragged
    monkeypatch.setattr(render, "mixture_poisson_ll_ragged",
                        lambda *a: calls.append(1) or ragged(*a))
    src_t = torch.tensor(src)
    evaluate = infer._evaluator(tgt, [(True, src_t), (False, src_t)])
    x = torch.tensor(np.concatenate(
        [np.pad(ths[0], ((0, 0), (0, 4))), ths[1]]))
    for m in (1, 2):
        ll, lp = evaluate(x.repeat(m, 1))
        assert len(calls) == m      # one K4 call per evaluation
        for j, got in enumerate((ll, lp)):
            got = got.reshape(m, 2, -1).numpy()
            for k in range(2):
                w = want[k][j]
                fin = np.isfinite(w)
                for copy in got[:, k]:
                    assert np.array_equal(np.isfinite(copy), fin)
                    np.testing.assert_allclose(copy[fin], w[fin],
                                               rtol=1e-10)


def test_prior_carried_across():
    """JAX's PRIOR through convert.py equals the port's own prior (its copy
    of data/priors.npz), field by field."""
    from celeste_jl_tpu.vi.elbo import PRIOR

    got = convert.prior_constants(PRIOR, "cpu", F64)
    want = default_prior(torch.device("cpu"), F64)
    for f in ("is_star", "flux_mean", "flux_var", "k", "color_mean",
              "color_cov_inv", "color_cov_logdet"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-12,
                                   err_msg=f)
    assert (got.gal_radius_px_mean, got.gal_radius_px_var) == (
        want.gal_radius_px_mean, want.gal_radius_px_var)


def test_render_route_matches_jax(scene):
    """The plain render + score (neighbor backgrounds) against JAX's."""
    images, catalog = scene
    jt = _jax_targets(images, catalog[:1])[0]
    tgt = convert.source_target(jt, "cpu", F64)
    pos, flux = np.array([15.2, 14.9]), np.full(5, 20.0)
    shape = np.array([0.4, 0.6, 1.0, 2.0])
    for sh in (None, shape):
        jimg = jax.jit(lambda p, f: jlp._render(
            jt, p, f, None if sh is None else jnp.asarray(sh)))(
                jnp.asarray(pos), jnp.asarray(flux))
        img = log_prob._render(tgt, torch.tensor(pos)[None],
                               torch.tensor(flux)[None],
                               None if sh is None else torch.tensor(sh)[None])
        np.testing.assert_allclose(img[0].numpy(), np.asarray(jimg),
                                   rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(
            log_prob._poisson_ll(tgt, img).numpy()[0],
            float(jax.jit(jlp._poisson_ll)(jt, jimg)), rtol=1e-12)


def test_schedule_and_psrf():
    for n in (1, 20, 50):
        np.testing.assert_array_equal(ais.sigmoid_schedule(n, 4.0),
                                      jschedule(n, 4.0))
    chains = np.random.default_rng(0).normal(size=(4, 50, 3))
    np.testing.assert_allclose(infer.potential_scale_reduction(chains),
                               jpsrf(chains), rtol=1e-12)


def test_slicesample_gaussian_moments():
    """64 independent chains of a 2-D Gaussian (tests/test_mcmc.py:21-33
    with lanes in place of one long chain)."""
    mu = torch.tensor([1.0, -2.0], dtype=F64)
    var = torch.tensor([0.5, 2.0], dtype=F64)
    evaluate = lambda x: (-0.5 * torch.sum((x - mu) ** 2 / var, dim=-1),)
    combine = lambda p: p[0]
    x0 = torch.zeros(64, 2, dtype=F64)
    gen = torch.Generator().manual_seed(0)
    samps, lls, _ = tslice.slicesample_chain(
        gen, x0, evaluate(x0), torch.full((64,), 2), evaluate, combine, 60)
    s = samps[10:].reshape(-1, 2)
    torch.testing.assert_close(lls, evaluate(samps.reshape(-1, 2))[0]
                               .reshape(lls.shape), rtol=0, atol=0)
    np.testing.assert_allclose(s.mean(0).numpy(), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(s.var(0).numpy(), var.numpy(), rtol=0.25)


def test_ais_normalizer_of_scaled_gaussian():
    """Prior N(0, 1), posterior = prior + c: lnZ estimates c
    (tests/test_mcmc.py:36-53)."""
    c = 3.0
    gen = torch.Generator().manual_seed(1)
    evaluate = lambda z: (torch.full(z.shape[:1], c, dtype=F64),
                          -0.5 * torch.sum(z ** 2, dim=-1)
                          - 0.5 * np.log(2 * np.pi))
    z0 = torch.randn(16, 1, generator=gen, dtype=F64)
    _, _, ws = ais.ais(gen, evaluate, z0, evaluate(z0), torch.ones(16),
                       ais.sigmoid_schedule(30, rad=4.0))
    lnZ = float(ais.log_mean_exp(ws))
    assert abs(lnZ - c) < 0.2, lnZ


def test_prior_samplers_and_bootstrap():
    prior = default_prior(torch.device("cpu"), F64)
    gen = torch.Generator().manual_seed(3)
    ths = log_prob.sample_star_prior(gen, 32, prior)
    thg = log_prob.sample_gal_prior(gen, 32, prior)
    assert ths.shape == (32, 7) and thg.shape == (32, 11)
    assert torch.all(torch.isfinite(ths)) and torch.all(torch.isfinite(thg))
    assert torch.all(thg[:, 10] > 0)
    assert torch.all((thg[:, 7:9] >= 0) & (thg[:, 7:9] <= 1))

    w = torch.tensor(np.random.default_rng(2).normal(-50.0, 3.0, (3, 10)))
    boots = ais.bootstrap_lnZ(torch.Generator().manual_seed(9), w, 7)
    idx = torch.randint(0, 10, (3, 7, 10),
                        generator=torch.Generator().manual_seed(9)).numpy()
    want = logsumexp(w.numpy()[np.arange(3)[:, None, None], idx],
                     axis=-1) - np.log(10)
    np.testing.assert_allclose(boots.numpy(), want, rtol=1e-13)


def test_scene_helpers_match_jax(scene):
    """Patches, radii, neighbors and tile buckets as the JAX package makes
    them; gen_images_fast renders the expected image JAX's does."""
    from celeste_jl_tpu.parallel import state as jstate
    from celeste_jl_tpu.parallel.common import _tile_for_radius as jtile
    from celeste_jl_tpu.utils.config import Config as JConfig

    images, jcat = scene
    imgs, cat = convert.images(images), convert.catalog(jcat)
    cat.append(convert.catalog([jsyn.sample_star(pos=(20.0, 24.0))])[0])
    jcat = jcat + [jsyn.sample_star(pos=(20.0, 24.0))]
    radii = patch_radii(cat, imgs, Config())
    np.testing.assert_array_equal(radii,
                                  jstate.patch_radii(jcat, images, JConfig()))
    assert find_neighbors(cat, radii, imgs) == jstate.find_neighbors(
        jcat, radii, images)
    assert [_tile_for_radius(r) for r in (3.0, 8.0, 13.0, 30.0, 99.0)] == [
        jtile(r) for r in (3.0, 8.0, 13.0, 30.0, 99.0)]
    for a, b in zip(make_patches_batched(imgs, [c.pos for c in cat], radii,
                                         32),
                    jpatches(images, [c.pos for c in jcat], radii, 32)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    blank = lambda: jsyn.make_blank_images(H=40, W=44)
    want = jsyn.gen_images_fast(blank(), jcat, expectation=True, seed=1)
    got = gen_images_fast(convert.images(blank()), cat, expectation=True,
                          seed=1, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.pixels, w.pixels, rtol=1e-12)


@pytest.fixture(scope="module")
def ais_run(scene):
    images, catalog = scene
    cat = convert.catalog(catalog)
    res = infer.run_ais_batched(cat, convert.images(images), radii=[8.0, 8.0],
                                num_temperatures=8, num_samples=2,
                                num_samples_per_chain=4, seed=0,
                                device="cpu", dtype=F64)
    return res


def test_batched_ais_two_sources(ais_run):
    """The extended galaxy is classified; the star's posterior r-flux is
    near the truth (the star-vs-galaxy Bayes factor of a bright star is
    below AIS noise at test budgets, tests/test_mcmc.py:87-91)."""
    star, gal = ais_run
    assert 0.0 <= star["ave_pstar"] <= 1.0
    assert gal["ave_pstar"] < 0.1, gal["ave_pstar"]
    flux = np.exp(np.median(star["star_samples"][:, 2]))
    assert abs(flux - 25.0) / 25.0 < 0.2, flux
    pos = star["star_samples"][:, 5:7].mean(0)
    assert np.linalg.norm(pos - np.array([15.0, 15.0])) < 0.5
    for r in ais_run:
        assert r["star_samples"].shape == (8, 7)
        assert r["gal_samples"].shape == (8, 11)
        for k in ("star_lnZ", "gal_lnZ", "star_lls", "gal_lls"):
            assert np.all(np.isfinite(r[k])), k


def test_batched_ais_chain_densities_match_jax(scene, ais_run):
    """JAX's log posteriors at the port's chain draws equal the densities
    the port recorded for them (f64; the draws pass through world
    coordinates and back, ~1e-16 relative)."""
    images, catalog = scene
    jt = _jax_targets(images, catalog)
    for s, r in enumerate(ais_run):
        lo, hi = np.asarray(jt[s].world_lo), np.asarray(jt[s].world_hi)
        for kind in ("star", "gal"):
            th = r[f"{kind}_samples"].copy()
            th[:, 5:7] = (th[:, 5:7] - lo) / (hi - lo)
            f = jax.jit(jax.vmap(getattr(jlp, f"{kind}_logpost"),
                                 in_axes=(0, None)))
            want = np.asarray(f(jnp.asarray(th), jt[s]))
            np.testing.assert_allclose(r[f"{kind}_lls"], want, rtol=1e-8)


def test_run_mcmc_chain_recovers_flux(scene):
    images, catalog = scene
    samps, lls = infer.run_mcmc(convert.catalog(catalog)[0],
                                convert.images(images), num_samples=30,
                                seed=1, device="cpu", dtype=F64)
    assert samps.shape == (30, 7) and np.all(np.isfinite(lls))
    flux = np.exp(np.median(samps[10:, 2]))
    assert abs(flux - 25.0) / 25.0 < 0.15, flux


def test_run_ais_one_source(scene):
    """The single-source entry point: chains in world coordinates inside
    the position box, finite lnZs, the schema of run_ais_batched."""
    images, catalog = scene
    r = infer.run_ais(convert.catalog(catalog)[0], convert.images(images),
                      num_temperatures=3, num_samples=2,
                      num_samples_per_chain=2, seed=2, device="cpu",
                      dtype=F64)
    assert r["star_samples"].shape == (4, 7)
    assert r["gal_samples"].shape == (4, 11)
    assert r["star_lnZ_bootstrap"].shape == (1000,)
    assert np.isfinite(r["star_lnZ"]) and np.isfinite(r["gal_lnZ"])
    assert 0.0 <= r["ave_pstar"] <= 1.0
    # the box is +-1 pixel around the catalog position (identity WCS)
    assert np.all(np.abs(r["star_samples"][:, 5:7] - 15.0) <= 1.0)


def test_mcmc_to_df(ais_run):
    df = infer.mcmc_to_df(ais_run, num_chains=2)
    assert len(df) == 2
    for c in ("ra", "dec", "is_star", "flux_r_nmgy", "color_ug",
              "log_flux_r_stderr", "star_lnZ", "gal_lnZ", "max_psrf"):
        assert c in df.columns, c
    assert df["gal_radius_px"][1] > 0
