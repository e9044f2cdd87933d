"""High-level MCMC / AIS inference (port of celeste_jl_tpu/mcmc/infer.py;
mcmc/mcmc_infer.jl + mcmc_misc.jl).

Per source: AIS under both the star and the galaxy model estimates each
model's marginal likelihood (lnZ); p(star) comes from bootstrap lnZ draws;
each AIS draw is extended by a slice-sampling chain. `run_ais_batched`
runs all the sources of a chunk as lanes of one batched program: S
sources x num_samples AIS runs per model, star lanes (D = 7) beside galaxy
lanes (D = 11), stepped together by one masked slice sampler, with one K4
launch per evaluation for both models (mcmc/log_prob.blocks_loglike).

Entry points default to device="cuda" and float32, as the TPU bench runs;
they take a seed (a torch.Generator on the device is seeded from it) and
run on the CPU only when asked (device="cpu"). The reporting helpers
(samples_to_dataframe, samples_to_row, mcmc_to_df) return
benchmark/accuracy.Table's with the JAX package's pandas columns.
"""

import logging
import math
import time

import numpy as np
import torch

from ..benchmark.accuracy import Table
from ..models.patches import make_patch_for_source, make_patches_batched
from ..utils.config import Config
from ..vi.elbo import default_prior
from .ais import ais, bootstrap_lnZ, log_mean_exp, sigmoid_schedule
from .log_prob import (NUM_GAL_PARAMS, NUM_STAR_PARAMS, _render,
                       blocks_loglike, fused_tiles, gal_params_from_catalog,
                       lane_blocks, lane_logprior, logpost_from_terms,
                       make_source_target,
                       sample_gal_prior, sample_star_prior, stack_targets,
                       star_params_from_catalog, uniform_to_world)
from .slice import slicesample_chain

log = logging.getLogger(__name__)

# prior odds used to combine marginal likelihoods (mcmc_infer.jl:104-106)
LN_PRIOR_STAR = math.log(0.28)
LN_PRIOR_GAL = math.log(0.72)


def _evaluator(tgt, blocks, plain=False):
    """evaluate(x) -> (loglike, logprior) over lanes made of `blocks`, a
    list of (is_star, src) in lane order, each block's lanes padded to the
    width of x. evaluate also takes m stacked copies of the lanes, (m L, D),
    as the step-out scores both ends at once; one K4 launch scores every
    block (its plain twin if `plain`, one call per block). The blocks'
    Lanes and K4's row plan are gathered once per m."""
    tiles = fused_tiles(tgt)
    prior = default_prior(tgt.pixels.device, tgt.pixels.dtype)
    L = sum(len(src) for _, src in blocks)
    gathered = {}

    def evaluate(x):
        m = x.shape[0] // L
        if m not in gathered:
            gathered[m] = lane_blocks(
                tgt, [(s, src.repeat(m)) for s, src in blocks], tiles)
        lb = gathered[m]
        x = x.reshape(m, L, x.shape[-1])
        ths, i0 = [], 0
        for is_star, src in blocks:
            n, D = len(src), NUM_STAR_PARAMS if is_star else NUM_GAL_PARAMS
            ths.append(x[:, i0:i0 + n, :D].reshape(m * n, D))
            i0 += n
        lls = blocks_loglike(ths, lb, plain)
        lps = [lane_logprior(th, s, ln.log_area, prior)
               for th, s, ln in zip(ths, lb.is_star, lb.lanes)]
        return (torch.cat([v.reshape(m, -1) for v in lls], dim=1).reshape(-1),
                torch.cat([v.reshape(m, -1) for v in lps], dim=1).reshape(-1))

    return evaluate


def _logpost(parts):
    return logpost_from_terms(*parts)


def _neighbor_arrays(neighbors, NB):
    """Padded catalog parameters of each source's neighbors: `neighbors` is
    a list (one per source) of CatalogEntry lists, at most NB used each."""
    S = len(neighbors)
    nb = dict(pos=np.zeros((S, NB, 2)), sf=np.zeros((S, NB, 5)),
              gf=np.zeros((S, NB, 5)),
              shape=np.tile(np.array([0.5, 0.7, 0.0, 1.0]), (S, NB, 1)),
              star=np.zeros((S, NB), dtype=bool), valid=np.zeros((S, NB)))
    for i, entries in enumerate(neighbors):
        for k, ce in enumerate(list(entries)[:NB]):
            nb["pos"][i, k] = np.asarray(ce.pos)
            nb["sf"][i, k] = np.asarray(ce.star_fluxes)
            nb["gf"][i, k] = np.asarray(ce.gal_fluxes)
            nb["shape"][i, k] = [ce.gal_frac_dev, ce.gal_axis_ratio,
                                 ce.gal_angle, ce.gal_radius_px]
            nb["star"][i, k] = bool(ce.is_star)
            nb["valid"][i, k] = 1.0
    return nb


def _neighbor_bg(tgt, nb):
    """Sky plus every valid neighbor rendered from its catalog parameters
    on each source's tiles (plain torch render), (S, B, P, P)."""
    S, NB = nb["valid"].shape
    if not NB:
        return tgt.bg_nmgy
    kw = dict(dtype=tgt.pixels.dtype, device=tgt.pixels.device)
    t = lambda a: torch.as_tensor(a, **kw).reshape((S * NB,) + a.shape[2:])
    src = torch.arange(S, device=kw["device"]).repeat_interleave(NB)
    pos = t(nb["pos"])
    star_img = _render(tgt, pos, t(nb["sf"]), None, src)
    gal_img = _render(tgt, pos, t(nb["gf"]), t(nb["shape"]), src)
    is_star = torch.as_tensor(nb["star"], device=kw["device"]).reshape(-1)
    img = t(nb["valid"])[:, None, None, None] * torch.where(
        is_star[:, None, None, None], star_img, gal_img)
    return tgt.bg_nmgy + img.reshape((S, NB) + img.shape[1:]).sum(1)


def render_catalog_bg(tgt, neighbor_entries):
    """Fixed background of a one-source target: sky plus its neighbors
    rendered from their catalog parameters (mcmc_misc.jl:284-305)."""
    entries = list(neighbor_entries)
    return _neighbor_bg(tgt, _neighbor_arrays([entries], len(entries)))


def _ais_both_models(gen, tgt, num_temperatures=50, num_samples=10,
                     num_samples_per_chain=25, num_bootstrap=1000,
                     plain=False, history=None):
    """AIS + posterior chains for the star and galaxy models of every
    source of `tgt` (leading S axis, background final). Returns a dict of
    tensors with a leading S axis. plain=True scores through K4's plain
    twin; a `history` list receives the lanes (2 S n, 11), star lanes
    first, after each AIS step."""
    S = tgt.pixels.shape[0]
    dev, dtype = tgt.pixels.device, tgt.pixels.dtype
    n = num_samples
    Ls = S * n
    src = torch.arange(S, device=dev).repeat_interleave(n)    # lane -> source
    evaluate = _evaluator(tgt, [(True, src), (False, src)], plain)
    ndim = torch.cat([torch.full((Ls,), NUM_STAR_PARAMS, device=dev),
                      torch.full((Ls,), NUM_GAL_PARAMS, device=dev)])

    prior = default_prior(dev, dtype)
    z_star = sample_star_prior(gen, Ls, prior)
    z_gal = sample_gal_prior(gen, Ls, prior)
    z0 = torch.cat([torch.nn.functional.pad(
        z_star, (0, NUM_GAL_PARAMS - NUM_STAR_PARAMS)), z_gal])
    schedule = sigmoid_schedule(num_temperatures, rad=4.0)
    z, parts, logw = ais(gen, evaluate, z0, evaluate(z0), ndim, schedule,
                         history=history)
    ws_star, ws_gal = logw[:Ls].reshape(S, n), logw[Ls:].reshape(S, n)

    # continue each AIS draw with a posterior slice chain
    # (mcmc_infer.jl:46-56)
    samps, lls, _ = slicesample_chain(gen, z, parts, ndim, evaluate,
                                      _logpost, num_samples_per_chain)
    T = num_samples_per_chain
    chains = samps.reshape(T, 2, S, n, -1).permute(1, 2, 3, 0, 4)
    chain_lls = lls.reshape(T, 2, S, n).permute(1, 2, 3, 0)

    boot_star = bootstrap_lnZ(gen, ws_star, num_bootstrap)
    boot_gal = bootstrap_lnZ(gen, ws_gal, num_bootstrap)
    # p(star | data) ∝ p(data | star) p(star) over the bootstrap draws
    ln_star = boot_star + LN_PRIOR_STAR
    ln_gal = boot_gal + LN_PRIOR_GAL
    type_chain = ln_star - torch.logaddexp(ln_star, ln_gal)
    return {
        "star_lnZ": log_mean_exp(ws_star), "gal_lnZ": log_mean_exp(ws_gal),
        "star_lnZ_bootstrap": boot_star, "gal_lnZ_bootstrap": boot_gal,
        "star_samples": chains[0, ..., :NUM_STAR_PARAMS],
        "star_lls": chain_lls[0],
        "gal_samples": chains[1], "gal_lls": chain_lls[1],
        "type_chain": type_chain,
        "ave_pstar": torch.exp(log_mean_exp(type_chain)),
    }


def _results(out, tgt_list):
    """Per-source result dicts (host numpy) with the chains' position
    columns in world coordinates; tgt_list: the single-source numpy
    targets."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    results = []
    for i, tgt1 in enumerate(tgt_list):
        res = {k: np.array(v[i]) for k, v in out.items()}
        for name in ("star_samples", "gal_samples"):
            flat = res[name].reshape(-1, res[name].shape[-1])
            flat[:, 5:7] = uniform_to_world(flat[:, 5:7], tgt1)
            res[name] = flat
        res["star_lls"] = res["star_lls"].reshape(-1)
        res["gal_lls"] = res["gal_lls"].reshape(-1)
        res["ave_pstar"] = float(res["ave_pstar"])
        results.append(res)
    return results


def run_ais(ce, images, patch=None, neighbor_entries=(), pos_delta=(2.0, 2.0),
            num_temperatures=50, num_samples=10, num_samples_per_chain=25,
            radius=8.0, tile_size=32, seed=0, device="cuda",
            dtype=torch.float32):
    """AIS star-vs-galaxy inference for one source (mcmc_infer.jl:10-135).
    Returns a dict of chains, lnZ bootstrap draws and ave_pstar; the chains'
    position columns are in world coordinates."""
    if patch is None:
        patch = make_patch_for_source(images, ce.pos, radius=radius,
                                      tile_size=tile_size)
    tgt1 = make_source_target(patch, pos_delta=pos_delta,
                              image=images[0] if images else None,
                              entry_pos=ce.pos)
    tgt = stack_targets([tgt1], device, dtype)
    tgt = tgt._replace(bg_nmgy=render_catalog_bg(tgt, neighbor_entries))
    gen = torch.Generator(device=device).manual_seed(seed)
    out = _ais_both_models(gen, tgt, num_temperatures=num_temperatures,
                           num_samples=num_samples,
                           num_samples_per_chain=num_samples_per_chain)
    return _results(out, [tgt1])[0]


def run_ais_batched(catalog, images, targets=None, neighbor_map=None,
                    radii=None, num_temperatures=50, num_samples=10,
                    num_samples_per_chain=25, pos_delta=(2.0, 2.0),
                    max_neighbors=8, seed=0, config=None, chunk_lanes=256,
                    device="cuda", dtype=torch.float32):
    """Batched AIS over many sources: one batched program per chunk of at
    most chunk_lanes target sources (chunk i seeded with seed + 7919 i).
    Returns a list of per-source result dicts in target order, the schema
    of run_ais.

    On the H100 the 64-source bench scene runs as one chunk: a chunk's
    device memory is dominated by the neighbor render, ~20 MB per source in
    f32, so the default of 256 sources stays within a few GB. The JAX
    package's 32-lane cap and power-of-two lane padding were TPU
    workarounds and are not carried over."""
    from ..parallel.common import _tile_for_radius
    from ..parallel.state import find_neighbors, patch_radii

    config = config or Config()
    targets = (list(range(len(catalog))) if targets is None
               else list(targets))
    if not targets:
        return []
    if radii is None:
        radii = patch_radii(catalog, images, config)
    if neighbor_map is None:
        neighbor_map = find_neighbors(catalog, radii, images)

    tile = max(_tile_for_radius(radii[s]) for s in targets)
    results = []
    for i0 in range(0, len(targets), chunk_lanes):
        results.extend(_run_ais_chunk(
            catalog, images, targets[i0:i0 + chunk_lanes], neighbor_map,
            radii, tile, num_temperatures, num_samples,
            num_samples_per_chain, pos_delta, max_neighbors,
            seed + 7919 * (i0 // chunk_lanes), device, dtype))
    return results


def chunk_target(catalog, images, targets, neighbor_map, radii, tile,
                 pos_delta=(2.0, 2.0), max_neighbors=8, device="cuda",
                 dtype=torch.float32):
    """The SourceTarget (leading S axis, neighbor background rendered) of
    the sources `targets`, and its single-source numpy targets."""
    patches = make_patches_batched(images, [catalog[s].pos for s in targets],
                                   [radii[s] for s in targets], tile)
    tgt_list = [make_source_target(p, pos_delta=pos_delta,
                                   image=images[0] if images else None,
                                   entry_pos=catalog[s].pos)
                for p, s in zip(patches, targets)]
    tgt = stack_targets(tgt_list, device, dtype)
    nb = _neighbor_arrays([[catalog[n] for n in neighbor_map.get(s, ())]
                           for s in targets], max_neighbors)
    return tgt._replace(bg_nmgy=_neighbor_bg(tgt, nb)), tgt_list


def _run_ais_chunk(catalog, images, targets, neighbor_map, radii, tile,
                   num_temperatures, num_samples, num_samples_per_chain,
                   pos_delta, max_neighbors, seed, device, dtype):
    """One batched AIS program over the sources `targets`."""
    tgt, tgt_list = chunk_target(catalog, images, targets, neighbor_map,
                                 radii, tile, pos_delta, max_neighbors,
                                 device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = _ais_both_models(gen, tgt, num_temperatures=num_temperatures,
                           num_samples=num_samples,
                           num_samples_per_chain=num_samples_per_chain)
    return _results(out, tgt_list)


def run_mcmc(ce, images, patch=None, neighbor_entries=(),
             pos_delta=(2.0, 2.0), num_samples=500, radius=8.0,
             tile_size=32, seed=0, device="cuda", dtype=torch.float32):
    """Plain slice-sampling chain under the model matching the catalog type
    (mcmc_infer.jl:141+). Returns (samples (num_samples, D) with world
    positions, log posteriors (num_samples,)), numpy."""
    if patch is None:
        patch = make_patch_for_source(images, ce.pos, radius=radius,
                                      tile_size=tile_size)
    tgt1 = make_source_target(patch, pos_delta=pos_delta,
                              image=images[0] if images else None,
                              entry_pos=ce.pos)
    tgt = stack_targets([tgt1], device, dtype)
    tgt = tgt._replace(bg_nmgy=render_catalog_bg(tgt, neighbor_entries))
    th0 = (star_params_from_catalog if ce.is_star
           else gal_params_from_catalog)(ce, tgt1)
    x0 = torch.as_tensor(th0, dtype=dtype, device=device)[None]
    src = torch.zeros(1, dtype=torch.long, device=device)
    evaluate = _evaluator(tgt, [(bool(ce.is_star), src)])
    ndim = torch.full((1,), x0.shape[1], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    samps, lls, _ = slicesample_chain(gen, x0, evaluate(x0), ndim, evaluate,
                                      _logpost, num_samples)
    samps = samps[:, 0].cpu().numpy()
    samps[:, 5:7] = uniform_to_world(samps[:, 5:7], tgt1)
    return samps, lls[:, 0].cpu().numpy()


def potential_scale_reduction(chains):
    """Gelman-Rubin PSRF over (M, N, D) chains (mcmc_misc.jl:339-368)."""
    chains = np.asarray(chains)
    M, N, D = chains.shape
    means = chains.mean(axis=1)                   # (M, D)
    B = N * means.var(axis=0, ddof=1)             # between-chain
    W = chains.var(axis=1, ddof=1).mean(axis=0)   # within-chain
    var_hat = (N - 1) / N * W + B / N
    return np.sqrt(var_hat / np.maximum(W, 1e-30))


def one_node_mcmc_infer(catalog, images, target_sources=None, config=None,
                        seed=0, device="cuda", dtype=torch.float32):
    """MCMC (AIS) over every target source as one batched program;
    neighbors rendered as fixed background from their catalog entries
    (ParallelRun.jl:504-543, threads -> lanes)."""
    config = config or Config()
    targets = (list(range(len(catalog))) if target_sources is None
               else list(target_sources))
    t0 = time.perf_counter()
    results = run_ais_batched(
        catalog, images, targets=targets,
        num_temperatures=config.num_ais_temperatures,
        num_samples=config.num_ais_samples, seed=seed, config=config,
        device=device, dtype=dtype)
    wall = time.perf_counter() - t0
    log.info(f"mcmc: {len(targets)} sources in one batched AIS program "
             f"({wall:.2f}s, {len(targets) / max(wall, 1e-9):.2f} "
             "sources/s)")
    for s, res in zip(targets, results):
        ce = catalog[s]
        res["objid"] = getattr(ce, "objid", "")
        res["init_pos"] = np.asarray(ce.pos)
    return results


# ---------------------------------------------------------------------------
# Chain reporting (mcmc_misc.jl:105-168)
# ---------------------------------------------------------------------------

def samples_to_dataframe(chain, is_star=True):
    """MCMC samples -> Table with catalog-comparable columns
    (mcmc_misc.jl:105-133): reference-band flux + colors from lnfluxes,
    world position, galaxy shape with the radius scaled to the
    effective-radius convention (px * sqrt(axis_ratio))."""
    chain = np.asarray(chain)
    df = Table({
        "log_flux_r": chain[:, 2],
        "flux_r_nmgy": np.exp(chain[:, 2]),
        "color_ug": chain[:, 1] - chain[:, 0],
        "color_gr": chain[:, 2] - chain[:, 1],
        "color_ri": chain[:, 3] - chain[:, 2],
        "color_iz": chain[:, 4] - chain[:, 3],
        "ra": chain[:, 5], "dec": chain[:, 6],
    })
    if not is_star:
        df["gal_frac_dev"] = chain[:, 7]
        df["gal_axis_ratio"] = chain[:, 8]
        df["gal_angle_deg"] = np.degrees(chain[:, 9])
        df["gal_radius_px"] = chain[:, 10] * np.sqrt(chain[:, 8])
    return df


def samples_to_row(sampdf, is_star=True):
    """Summarize a chain Table into one catalog row (posterior means +
    stderr columns, mcmc_misc.jl:137-168)."""
    row = {
        "ra": sampdf["ra"].mean(), "dec": sampdf["dec"].mean(),
        "is_star": 1.0 if is_star else 0.0,
        "flux_r_nmgy": sampdf["flux_r_nmgy"].mean(),
        "log_flux_r": sampdf["log_flux_r"].mean(),
        "log_flux_r_stderr": sampdf["log_flux_r"].std(ddof=1),
        "gal_frac_dev": np.nan, "gal_axis_ratio": np.nan,
        "gal_radius_px": np.nan, "gal_angle_deg": np.nan,
    }
    for c in ("color_ug", "color_gr", "color_ri", "color_iz"):
        row[c] = sampdf[c].mean()
        row[f"{c}_stderr"] = sampdf[c].std(ddof=1)
    if not is_star:
        for c in ("gal_frac_dev", "gal_axis_ratio", "gal_radius_px",
                  "gal_angle_deg"):
            row[c] = sampdf[c].mean()
    return row


def mcmc_to_df(results, num_chains=10):
    """one_node_mcmc_infer results -> catalog Table, with per-source
    p(star), lnZ diagnostics and the Gelman-Rubin PSRF of the winning
    model's chains. num_chains: the AIS num_samples used (each AIS draw
    seeds one posterior chain)."""
    rows = []
    for res in results:
        is_star = res["ave_pstar"] > 0.5
        chain = np.asarray(res["star_samples" if is_star
                               else "gal_samples"])
        row = samples_to_row(samples_to_dataframe(chain, is_star), is_star)
        row["is_star"] = float(res["ave_pstar"])
        row["objid"] = res.get("objid", "")
        row["star_lnZ"] = float(res["star_lnZ"])
        row["gal_lnZ"] = float(res["gal_lnZ"])
        n_per = len(chain) // max(num_chains, 1)
        if num_chains > 1 and n_per > 1:
            shaped = chain[:num_chains * n_per].reshape(
                num_chains, n_per, -1)
            row["max_psrf"] = float(potential_scale_reduction(shaped).max())
        else:
            row["max_psrf"] = np.nan
        rows.append(row)
    return Table.from_rows(rows)
