"""The port's trust-region subproblem (ops/tr.py) against the JAX
package's `_solve_tr_eig` (secular="bisect") on the cases of
tests/test_pallas_tr.py: 2e-5 in f32 (test_pallas_tr.py:49) and 1e-12 in
f64. The CUDA kernel is held to the plain twin in
test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celeste_jl_tpu.ops.newton import _solve_tr_eig
from celeste_jl_tpu_torch.ops import tr
# The suite runs test files in parallel worker processes; one intra-op
# thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _cases(rng, B, D, dtype=np.float32):
    """As tests/test_pallas_tr.py: PD interior lanes, indefinite boundary
    lanes, and a near-hard-case lane."""
    w = rng.standard_normal((B, D)).astype(dtype) * 3.0
    w[: B // 3] = np.abs(w[: B // 3]) + 0.5
    gq = rng.standard_normal((B, D)).astype(dtype)
    gq[: B // 6] *= 1e-3
    delta = (10.0 ** rng.uniform(-3, 1, B)).astype(dtype)
    w[-1] = np.linspace(3.0, 0.5, D, dtype=dtype)
    w[-1, -1] = -2.0
    gq[-1, -1] = 1e-6
    delta[-1] = 5.0
    return gq, w, delta


def _jax(gq, w, delta, iters=48):
    return jax.jit(jax.vmap(lambda a, b, d: _solve_tr_eig(
        a, b, d, iters, "bisect")))(jnp.asarray(gq), jnp.asarray(w),
                                    jnp.asarray(delta))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (np.float64, 1e-12)])
def test_tr_plain_matches_jax(dtype, tol):
    gq, w, delta = _cases(np.random.default_rng(7), 48, 42, dtype)
    p_j, pred_j = _jax(gq, w, delta)
    p_t, pred_t = tr.tr_subproblem_plain(torch.tensor(gq), torch.tensor(w),
                                         torch.tensor(delta), 48)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), rtol=tol,
                               atol=tol)
    # every finite step respects the region
    norms = np.linalg.norm(p_t.numpy().astype(np.float64), axis=1)
    fin = np.isfinite(norms)
    assert fin.sum() >= len(norms) - 1
    assert (norms[fin] <= delta[fin] * 1.001 + 1e-6).all()


def test_tr_wrapper_takes_plain_twin_on_cpu():
    gq, w, delta = map(torch.tensor, _cases(np.random.default_rng(3), 10, 42))
    for a, b in zip(tr.tr_subproblem(gq, w, delta, 48),
                    tr.tr_subproblem_plain(gq, w, delta, 48)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        tr.tr_subproblem(gq.to("meta"), w.to("meta"), delta.to("meta"), 48)

