"""Variance-aware bit allocation — exact ILP solver.

Copied verbatim from ``vaq_tpu/bitalloc.py``: importing it from there would
run ``vaq_tpu/__init__.py``, which imports jax, and this package never does.

Re-implements the GLPK integer program of the reference (``VAQ.cpp:338-524``)
with an exact dynamic program (no GLPK dependency). The ILP is:

    maximize    Σ_i  var_i · x_i
    subject to  Σ_i  x_i = bit_budget                        (VAQ.cpp:384-391)
                lb_i ≤ x_i ≤ max_bits,  x_i integer          (VAQ.cpp:374-379)
                x_i − x_{i+1} ≤ k_i,  i = 0..m-2             (VAQ.cpp:404-426)

where  lb_i = min_bits if cumvar_i ≤ percent_var else 0, and
       k_i  = nextPow2(var_i / var_{i+1})  clamped to ≥ 0 (nan → 0), with
       nextPow2(x) = 2^⌊log2|x|⌋, 0 for x = 0  (utils/Math.hpp:183-188).

Because the smoothness constraints couple only adjacent variables and the
budget is a single equality, the problem decomposes into a DP over
(subspace, x_i, partial sum) — ≤ 64 × 17 × (budget+1) states — solved exactly
on the host in milliseconds at train time. This is a small host-side solve,
not a TPU kernel (SURVEY §2.1 V5).

The per-*dimension* MILP of the binary engine (``BitVecEngine.hpp:339-507``)
uses the same constraint family and reuses this solver with L=1 subspaces.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from vaq_tpu_torch.errors import ConfigError

NEG_INF = -np.inf


def next_pow2(x: float) -> int:
    """2^⌊log2|x|⌋, 0 for 0 (reference utils/Math.hpp:183-188)."""
    if x == 0 or not math.isfinite(x):
        return 0
    return int(2.0 ** math.floor(math.log2(abs(x))))


def smoothness_bounds(variances: np.ndarray) -> np.ndarray:
    """k_i = nextPow2(var_i / var_{i+1}), nan/≤0 → 0 (VAQ.cpp:404-412)."""
    v = np.asarray(variances, dtype=np.float64)
    m = v.shape[0]
    ks = np.zeros(m - 1, dtype=np.int64)
    for i in range(m - 1):
        ratio = v[i] / v[i + 1] if v[i + 1] != 0 else math.inf
        k = next_pow2(ratio)
        if not math.isfinite(ratio) or math.isnan(k) or k <= 0:
            k = 0
        ks[i] = k
    return ks


def solve_budgeted_dp(
    values: np.ndarray,
    budget: int,
    ub: int,
    lbs: np.ndarray,
    ks: np.ndarray,
) -> np.ndarray:
    """Exact DP for the shared ILP family (one solver for both engines).

        maximize   Σ_i values_i · x_i
        s.t.       Σ_i x_i = budget
                   lbs_i ≤ x_i ≤ ub,  x_i integer
                   x_i − x_{i+1} ≤ ks_i

    This parameterization covers both the VAQ per-subspace program
    (``VAQ.cpp:338-524``) and the binary engine's per-dimension program
    (``BitVecEngine.hpp:339-507``) — same constraint family, different
    (ub, lbs, ratio-cap) choices supplied by the wrappers below.

    Raises ValueError if infeasible (the reference asserts there,
    VAQ.cpp:452-456).
    """
    v = np.asarray(values, dtype=np.float64)
    m = v.shape[0]
    lbs = np.asarray(lbs, dtype=np.int64)
    ks = np.asarray(ks, dtype=np.int64)
    ub = int(ub)
    B = int(budget)

    if B > m * ub or B < int(lbs.sum()):
        raise ConfigError(
            f"bit budget {B} infeasible for {m} variables with bounds "
            f"[{lbs.min()},{ub}]"
        )

    # dp[x, s] = best objective over x_0..x_i with x_i = x and Σ = s.
    dp = np.full((ub + 1, B + 1), NEG_INF)
    for x in range(lbs[0], ub + 1):
        if x <= B:
            dp[x, x] = v[0] * x
    tables = [dp]

    for i in range(1, m):
        k = int(ks[i - 1])
        # prefix_max[x, s] = max_{x' <= x} dp[x', s]
        prefix_max = np.maximum.accumulate(dp, axis=0)
        new_dp = np.full((ub + 1, B + 1), NEG_INF)
        for y in range(int(lbs[i]), ub + 1):
            x_cap = min(ub, y + k)  # allowed previous x: x <= y + k
            if x_cap < 0 or y > B:
                continue
            # new_dp[y, s] = v_i*y + prefix_max[x_cap, s - y]
            src = prefix_max[x_cap, : B + 1 - y]
            new_dp[y, y:] = np.where(src > NEG_INF, src + v[i] * y, NEG_INF)
        dp = new_dp
        tables.append(dp)

    final = dp[:, B]
    if not np.any(final > NEG_INF):
        raise ConfigError("bit allocation ILP infeasible")

    # Backtrack. Ties in the objective are broken deterministically toward the
    # most balanced profile (x closest to budget/m): variance ties mean the
    # subspaces are interchangeable, and balanced bits minimize the worst-case
    # quantization error. (GLPK picks an arbitrary vertex there; parity is
    # defined on recall, not on tie choices — SURVEY §7.5.)
    target_bits = B / m

    def pick(cands: np.ndarray) -> int:
        return int(cands[np.argmin(np.abs(cands - target_bits))])

    bits = np.zeros(m, dtype=np.int64)
    best = final.max()
    x = pick(np.flatnonzero(np.isclose(final, best)))
    s = B
    bits[m - 1] = x
    for i in range(m - 1, 0, -1):
        s -= x
        k = int(ks[i - 1])
        prev_dp = tables[i - 1][:, s]
        target = dp[x, s + x] - v[i] * x  # objective contribution of prefix
        x_cap = min(ub, x + k)
        cand = np.flatnonzero(
            np.isclose(prev_dp[: x_cap + 1], target) & (prev_dp[: x_cap + 1] > NEG_INF)
        )
        if cand.size == 0:
            # numerical fallback: take the max achievable prefix
            cand = np.array([int(np.argmax(prev_dp[: x_cap + 1]))])
        x = pick(cand)
        bits[i - 1] = x
        dp = tables[i - 1]

    assert bits.sum() == B, (bits, B)
    assert np.all(bits <= ub) and np.all(bits >= lbs)
    assert np.all(bits[:-1] - bits[1:] <= ks)
    return bits


def allocate_bits(
    variances: Sequence[float],
    bit_budget: int,
    min_bits: int,
    max_bits: int,
    cum_var: Optional[Sequence[float]] = None,
    percent_var_explained: float = 1.0,
) -> np.ndarray:
    """Exact solution of the VAQ variance-aware bit-allocation ILP.

    Args:
      variances: per-subspace explained variance (already normalized and
        clamped positive by the caller, as VAQ.cpp:301-320 does).
      bit_budget: total bits to distribute (Σ x_i = budget, exactly).
      min_bits / max_bits: per-subspace bounds; min only applies while the
        cumulative variance is ≤ percent_var_explained.
      cum_var: cumulative variance sums (defaults to cumsum(variances)).
      percent_var_explained: threshold for the min-bits lower bound.

    Returns:
      int64 array of per-subspace bit counts.
    """
    v = np.asarray(variances, dtype=np.float64)
    if v.shape[0] == 0:
        raise ConfigError("no subspaces")
    if cum_var is None:
        cum_var = np.cumsum(v)
    cum_var = np.asarray(cum_var, dtype=np.float64)
    lbs = np.where(cum_var <= percent_var_explained, int(min_bits), 0).astype(
        np.int64
    )
    return solve_budgeted_dp(v, bit_budget, int(max_bits), lbs,
                             smoothness_bounds(v))


def allocate_bits_per_dim(
    variances: np.ndarray,
    bit_budget: int,
    lbs: np.ndarray,
    max_bits: int = 8,
    ratio_cap: int = 10,
) -> np.ndarray:
    """The binary engine's per-*dimension* program
    (``BitVecEngine.hpp:339-507``): ub = 8 bits/dim, explicit lower-bound
    vector, and the smoothness cap rule k > ratio_cap → 0 (hpp:413-420) —
    solved by the same exact DP (replacing the reference's GLPK simplex +
    trunc/round-up)."""
    v = np.asarray(variances, dtype=np.float64)
    m = v.shape[0]
    ks = np.zeros(m - 1, dtype=np.int64)
    for i in range(m - 1):
        ratio = v[i] / v[i + 1] if v[i + 1] != 0 else math.inf
        k = next_pow2(ratio)
        if not math.isfinite(ratio) or k > ratio_cap or k < 0:
            k = 0
        ks[i] = k
    return solve_budgeted_dp(v, bit_budget, int(max_bits), lbs, ks)


def fixup_under_budget(bits: np.ndarray, bit_budget: int, max_bits: int) -> np.ndarray:
    """The reference's post-solve fix-up for under-budget solutions
    (VAQ.cpp:474-498). Our DP enforces the equality so this is only used for
    hardcoded allocations; kept for CLI parity."""
    bits = np.asarray(bits, dtype=np.int64).copy()
    total = int(bits.sum())
    m = bits.shape[0]
    if total < bit_budget:
        it = 0
        while it < m and bits[it] > 0:
            it += 1
        while it < m and bits[it] == 0:
            bits[it] += 1
            total += 1
            it += 1
        if total < bit_budget:
            for i in range(m):
                if bits[i] < max_bits:
                    bits[i] += 1
                    total += 1
                    if total >= bit_budget:
                        break
    return bits
