"""The port's multi-field inference (parallel/run.joint_infer_fields,
joint_infer_fields_pipelined, over parallel/fused.py) against the JAX
package's and against itself, f64 on the CPU, on
tests/test_multifield.py's scenes:

- joint_infer_fields on the two fields and the internal-conflict scene's
  two, one schedule shared by two tests: the two fields against the JAX
  package's merged result to 1e-4 (classifications, ELBOs) and the known
  answers, the conflict scene's classifications and deblended fluxes;
  with a short schedule, each field's result bit for bit against the
  field alone (the CPU launches each isolated member alone);
- the pipeline bit for bit against joint_infer_fields per group, the
  generator a group ahead of the consumer;
- the budget fallback, and a fit failing inside the schedule in
  development and in production.

The JAX package's merged run of the two fields goes in a process of its
own, started with the suite's JAX settings (tests/conftest.py), beside
the port's schedule.
"""

import numpy as np
import pytest
import torch

from celeste_jl_tpu.parallel import run as jrun
from celeste_jl_tpu.synthetic import (gen_images, make_blank_images,
                                      sample_galaxy, sample_star)
from celeste_jl_tpu.utils.config import Config as JaxConfig
from celeste_jl_tpu_torch import convert
from celeste_jl_tpu_torch.models.params import ids
from celeste_jl_tpu_torch.ops.newton import NewtonConfig
from celeste_jl_tpu_torch.parallel import fused, run
from celeste_jl_tpu_torch.parallel.run import (joint_infer_fields,
                                               joint_infer_fields_pipelined,
                                               one_node_joint_infer)
from celeste_jl_tpu_torch.utils import telemetry
from celeste_jl_tpu_torch.utils.config import Config
from _jax_ref import jax_reference

# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# tests/test_multifield.py's config
JMF_CFG = JaxConfig(min_radius_pix=8.0)
MF_CFG = convert.config(JMF_CFG)
# a schedule cut to a refresh a step: what the tests that take it hold is
# the control flow, not the fit
SHORT = Config(min_radius_pix=8.0, num_joint_vi_iters=1,
               joint_step_refreshes=1, polish_refreshes=1, polish_sweeps=1,
               probe_refreshes=1)
SHORT_NEWTON = NewtonConfig(max_iters=1, hess_every=2)


def _mf_field(seed, star_pos=(16.0, 16.0), gal_pos=(44.0, 46.0)):
    """tests/test_multifield.py's field, drawn by the JAX package: (the
    JAX field dict, the port's)."""
    images = make_blank_images(H=60, W=60, sky_nmgy=0.05,
                               nelec_per_nmgy=2000.0)
    truth = [sample_star(pos=star_pos, r_flux=18.0),
             sample_galaxy(pos=gal_pos, r_flux=28.0, gal_radius_px=2.0)]
    gen_images(images, truth, seed=seed)
    return ({"catalog": truth, "images": images},
            {"catalog": convert.catalog(truth),
             "images": convert.images(images)})


def _conflict_fields():
    """tests/test_multifield.py's internal-conflict fields: an overlapping
    star pair in the first, a galaxy in the second (the port's dicts)."""
    f1 = {"catalog": [sample_star(pos=(20.0, 20.0), r_flux=25.0),
                      sample_star(pos=(24.0, 23.0), r_flux=22.0)],
          "images": make_blank_images(H=48, W=48, sky_nmgy=0.05,
                                      nelec_per_nmgy=2000.0)}
    gen_images(f1["images"], f1["catalog"], seed=3)
    f2 = {"catalog": [sample_galaxy(pos=(24.0, 24.0), r_flux=35.0,
                                    gal_radius_px=2.0)],
          "images": make_blank_images(H=48, W=48, sky_nmgy=0.05,
                                      nelec_per_nmgy=2000.0)}
    gen_images(f2["images"], f2["catalog"], seed=4)
    return [{"catalog": convert.catalog(f["catalog"]),
             "images": convert.images(f["images"])} for f in (f1, f2)]


def _two_fields():
    return [_mf_field(seed=1), _mf_field(seed=2, star_pos=(18.0, 40.0))]


def _jax_two_fields():
    """The JAX package's joint_infer_fields of the two fields: each
    field's [(vs, elbo)], numpy."""
    return [[(np.asarray(r.vs), float(r.elbo)) for r in res]
            for res in jrun.joint_infer_fields(
                [j for j, _ in _two_fields()], config=JMF_CFG, seed=42)]


@pytest.fixture(scope="module")
def jax_two_fields():
    """_jax_two_fields (a future), computed in a process of its own while
    this process runs merged_four."""
    with jax_reference(_jax_two_fields) as future:
        yield future


@pytest.fixture(scope="module")
def merged_four():
    """One full schedule over the two fields and the two internal-conflict
    fields together (fields never interact, so each field's result is the
    one it gets merged with its own pair: the two tests that read it
    share one run)."""
    return joint_infer_fields([p for _, p in _two_fields()]
                              + _conflict_fields(), config=MF_CFG, seed=42,
                              **F64)


def test_two_fields_match_each_field_and_jax(jax_two_fields, merged_four):
    """tests/test_multifield.py::test_two_fields_one_launch_matches_per_
    field on the port: the two fields merged (here with the conflict
    fields, merged_four) against the JAX package's merged result (the
    same classifications, ELBOs within 1e-4) and the known answers; and,
    with the schedule cut short (SHORT: the merge's bookkeeping, the same
    program either way), bit for bit against each field alone (on the CPU
    each isolated member is its own launch)."""
    pairs = _two_fields()
    multi = merged_four[:2]
    assert len(merged_four) == 4 and all(len(r) == 2 for r in multi)
    jmulti = jax_two_fields.result()
    for got, want in zip(multi, jmulti):
        for g, (w_vs, w_elbo) in zip(got, want):
            assert (g.vs[ids.is_star[0]] > 0.5) == (w_vs[ids.is_star[0]]
                                                     > 0.5)
            assert abs(g.elbo - w_elbo) <= 1e-4 * abs(w_elbo)
    for got in multi:
        assert got[0].vs[ids.is_star[0]] > 0.5
        assert got[1].vs[ids.is_star[0]] < 0.5
    kw = dict(config=SHORT, newton_config=SHORT_NEWTON, seed=42, **F64)
    short = joint_infer_fields([p for _, p in pairs], **kw)
    for (_, fld), got in zip(pairs, short):
        alone = one_node_joint_infer(fld["catalog"], fld["images"], **kw)
        assert len(alone) == len(got) == 2
        for a, b in zip(alone, got):
            np.testing.assert_array_equal(b.vs, a.vs)
            assert b.elbo == a.elbo


def test_fields_with_internal_conflicts_stay_correct(merged_four):
    """tests/test_multifield.py's conflict scene on the port (merged with
    the two isolated fields, merged_four): the merged packer never
    co-schedules the overlapping pair; classifications and the deblended
    fluxes within 10 %."""
    r1, r2 = merged_four[2:]
    assert all(r.vs[ids.is_star[0]] > 0.5 for r in r1)
    assert r2[0].vs[ids.is_star[0]] < 0.5
    fluxes = sorted(np.exp(r.vs[ids.flux_loc[0]]) for r in r1)
    assert abs(fluxes[0] - 22.0) / 22.0 < 0.1, fluxes
    assert abs(fluxes[1] - 25.0) / 25.0 < 0.1, fluxes


def test_pipelined_matches_sequential():
    """The farm pipeline over three lazy groups (the two isolated fields,
    the conflict fields, whose schedule is staged, and the first field
    again) yields, bit for bit, what joint_infer_fields gives each group;
    group k's results come only after group k+1 was pulled. The schedule
    is cut short (SHORT): the same inputs and program either way."""
    def groups():
        return [[_mf_field(seed=1)[1], _mf_field(2, (18.0, 40.0))[1]],
                _conflict_fields(), [_mf_field(seed=1)[1]]]

    built = []

    def lazy_groups():
        for g in groups():
            built.append(g)
            yield g

    kw = dict(config=SHORT, newton_config=SHORT_NEWTON, seed=42, **F64)
    piped = []
    for res in joint_infer_fields_pipelined(lazy_groups(), **kw):
        piped.append(res)
        assert len(built) >= min(len(piped) + 1, 3)
    assert len(piped) == 3
    for got, group in zip(piped, groups()):
        want = joint_infer_fields(group, **kw)
        for gf, wf in zip(got, want):
            for a, b in zip(gf, wf):
                np.testing.assert_array_equal(a.vs, b.vs)
                assert a.elbo == b.elbo


def test_budget_fallback_runs_each_field(monkeypatch):
    """A staging over the budget returns None, and joint_infer_fields then
    runs one_node_joint_infer on each field."""
    fields = _conflict_fields()
    states, classes, _ = run._merged_states_classes(
        fields, SHORT, 8, 42, "cpu", torch.float64, False)
    assert classes
    assert fused._fused_joint_dispatch(states, classes, SHORT_NEWTON, 1, 1,
                                       budget_bytes=1) is None
    calls = []
    dispatch = run._fused_joint_dispatch
    monkeypatch.setattr(run, "_fused_joint_dispatch",
                        lambda *a, **k: dispatch(*a, **{**k,
                                                        "budget_bytes": 1}))
    monkeypatch.setattr(run, "one_node_joint_infer",
                        lambda catalog, images, *a, **k:
                        calls.append((catalog, k)) or [catalog])
    out = joint_infer_fields(fields, config=SHORT,
                             newton_config=SHORT_NEWTON, seed=42, **F64)
    assert [c for c, _ in calls] == [f["catalog"] for f in fields]
    assert out == [[f["catalog"]] for f in fields]
    assert all(k["device"] == "cpu" and k["dtype"] == torch.float64
               and k["active_boxes"] is None for _, k in calls)


def test_failing_fit_raises_or_keeps_the_states(monkeypatch):
    """A fit that raises inside the schedule propagates; under
    CELESTE_PROD it is logged, its sources counted as failures, and every
    field keeps the state it had before the schedule (the isolated
    target's fit, a separate launch, still lands)."""
    def broken(pad):
        def fit(*a, **k):
            raise RuntimeError("device fault")
        return fit

    monkeypatch.setattr(fused, "fit_for_width", broken)
    kw = dict(config=SHORT, newton_config=SHORT_NEWTON, seed=42, **F64)
    monkeypatch.delenv("CELESTE_PROD", raising=False)
    with pytest.raises(RuntimeError, match="device fault"):
        joint_infer_fields(_conflict_fields(), **kw)

    monkeypatch.setenv("CELESTE_PROD", "1")
    fields = _conflict_fields()
    states, classes, isolated = run._merged_states_classes(
        fields, SHORT, 8, 42, "cpu", torch.float64, False)
    touched = sorted(sum(classes, []))
    assert touched == [0, 1] and isolated == [2]
    r1, r2 = joint_infer_fields(fields, **kw)
    assert telemetry.counters.failures == len(touched)
    # the pair keeps its catalog init and -inf ELBOs; the galaxy was fit
    for r, s0 in zip(r1, states[0].vps):
        np.testing.assert_array_equal(r.vs, s0)
        assert r.elbo == -np.inf
    assert np.isfinite(r2[0].elbo)
