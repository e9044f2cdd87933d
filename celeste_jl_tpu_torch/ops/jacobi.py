"""Jacobi-schedule helpers (port of the parts of celeste_jl_tpu/ops/jacobi.py
that the pjacobi solver uses)."""

import numpy as np
import torch


def _round_robin_perm(n):
    """Static inter-round position permutation of the circle method.

    Pairs sit at positions (2k, 2k+1). After a round, the element at
    position j comes from position perm[j]; n-1 rounds make every unordered
    pair adjacent exactly once (asserted)."""
    A = list(range(n))

    def layout(arr):
        pos = [0] * n
        for k in range(n // 2):
            pos[2 * k] = arr[k]
            pos[2 * k + 1] = arr[n - 1 - k]
        return pos

    L0 = layout(A)
    L1 = layout([A[0]] + [A[-1]] + A[1:-1])
    inv0 = {e: i for i, e in enumerate(L0)}
    perm = [inv0[e] for e in L1]

    L = list(L0)
    seen = set()
    for _ in range(n - 1):
        for k in range(n // 2):
            a, b = L[2 * k], L[2 * k + 1]
            seen.add((min(a, b), max(a, b)))
        L = [L[p] for p in perm]
    assert len(seen) == n * (n - 1) // 2, "round-robin schedule incomplete"
    return np.asarray(perm)


def pad_to_even(H, g=None):
    """Pad (..., D, D) to even D+1 with a decoupled diagonal entry at a
    Gershgorin upper bound, so it is never the bottom eigenvalue and the
    trust-region solve ignores it (its g component is 0).
    Returns (H_padded, g_padded or None)."""
    D = H.shape[-1]
    if D % 2 == 0:
        return H, g
    bound = torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1) * 2.0 + 1.0
    Hp = torch.nn.functional.pad(H, (0, 1, 0, 1))
    Hp[..., D, D] = bound
    if g is None:
        return Hp, None
    return Hp, torch.nn.functional.pad(g, (0, 1))
