"""Maximum-weight perfect matching with node-coverage constraints.

A copy of ``repro.core.matching`` for the port's host SPECTRA (the OCS
controller tick runs it), so that both give the same matchings: scipy's
``linear_sum_assignment`` where scipy is present, as in the reference.

This is the inner solver of SPECTRA's host DECOMPOSE step (Alg. 1, line 4).

Given the remaining demand ``D_rem`` (weights) and the remaining *uncovered*
support ``S_rem``, we must return a permutation that

  (a) matches every *critical* row/column (a line with ``degree(S_rem)``
      uncovered entries) through one of its uncovered support entries —
      this guarantees the degree of ``S_rem`` drops by one per round, and
  (b) among all such permutations, maximizes the served demand
      ``sum_a D_rem[a, perm[a]]``.

Both are achieved with a single unconstrained max-weight perfect matching by
*weight augmentation*: every uncovered support entry incident to a critical
row or column receives a bonus ``M > sum(D_rem)`` per critical endpoint.  A
perfect matching covering all critical nodes through support edges always
exists (any color class of a König edge coloring covers every maximum-degree
node), and because ``M`` lexicographically dominates the demand weights, the
MWM attains the maximum possible bonus — i.e. covers all critical nodes —
before optimizing served demand.

The assignment itself is solved with the Jonker–Volgenant algorithm: scipy's
``linear_sum_assignment`` (Crouse's JV variant — the same implementation the
paper cites [22][23]) with a pure-numpy O(n^3) Hungarian fallback that is
cross-checked in the tests.
"""

from __future__ import annotations

import numpy as np

try:  # scipy is available in this environment; keep a fallback regardless.
    from scipy.optimize import linear_sum_assignment as _scipy_lsa
except Exception:  # pragma: no cover - exercised only without scipy
    _scipy_lsa = None


def hungarian_min_cost(cost: np.ndarray) -> np.ndarray:
    """Pure-numpy O(n^3) Hungarian algorithm (potentials + shortest paths).

    Returns ``perm`` with ``perm[i] = j`` minimizing ``sum_i cost[i, perm[i]]``
    over permutations. Classic "e-maxx" formulation, vectorized over columns.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"cost must be square, got {cost.shape}")
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    # p[j] = row matched to column j (rows/cols 1..n; column 0 is virtual).
    p = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        way = np.zeros(n + 1, dtype=np.int64)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # Relax all unused columns from column j0.
            cols = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = cols & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:] = np.where(better, j0, way[1:])
            masked = np.where(used[1:], INF, minv[1:])
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            # Update potentials.
            used_cols = used.copy()
            rows_of_used = p[used_cols]
            u[rows_of_used] += delta
            v[used_cols] -= delta
            minv[1:] = np.where(used[1:], minv[1:], minv[1:] - delta)
            j0 = j1
            if p[j0] == 0:
                break
        # Augment along the alternating path.
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    perm = np.empty(n, dtype=np.int64)
    perm[p[1:] - 1] = np.arange(n)
    return perm


def max_weight_perfect_matching(weights: np.ndarray, *, use_scipy: bool | None = None) -> np.ndarray:
    """Permutation ``perm`` maximizing ``sum_i weights[i, perm[i]]``."""
    weights = np.asarray(weights, dtype=np.float64)
    if use_scipy is None:
        use_scipy = _scipy_lsa is not None
    if use_scipy and _scipy_lsa is not None:
        rows, cols = _scipy_lsa(weights, maximize=True)
        perm = np.empty(weights.shape[0], dtype=np.int64)
        perm[rows] = cols
        return perm
    return hungarian_min_cost(-weights)


def critical_lines(S_rem: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Critical rows/cols of a 0/1 support matrix and its degree ``k``."""
    S_rem = np.asarray(S_rem)
    row_deg = S_rem.sum(axis=1)
    col_deg = S_rem.sum(axis=0)
    k = int(max(row_deg.max(initial=0), col_deg.max(initial=0)))
    return row_deg == k, col_deg == k, k


def mwm_node_coverage(
    D_rem: np.ndarray,
    S_rem: np.ndarray,
    *,
    use_scipy: bool | None = None,
    validate: bool = True,
) -> np.ndarray:
    """MWM under node-coverage constraints (Alg. 1 line 4).

    Returns a permutation covering every critical line of ``S_rem`` through an
    uncovered support entry, maximizing total ``D_rem`` weight among those.
    """
    D_rem = np.asarray(D_rem, dtype=np.float64)
    S = np.asarray(S_rem).astype(bool)
    n = D_rem.shape[0]
    crit_r, crit_c, k = critical_lines(S)
    if k == 0:
        raise ValueError("S_rem is empty; nothing to cover")
    base = np.maximum(D_rem, 0.0)
    M = float(base.sum()) + 1.0
    bonus = (crit_r[:, None].astype(np.float64) + crit_c[None, :]) * M
    W = base + np.where(S, bonus, 0.0)
    perm = max_weight_perfect_matching(W, use_scipy=use_scipy)
    if validate:
        rows = np.arange(n)
        on_support = S[rows, perm]
        if not np.all(on_support[crit_r]):
            raise AssertionError("critical row left uncovered by support edge")
        covered_cols = np.zeros(n, dtype=bool)
        covered_cols[perm[on_support]] = True
        if not np.all(covered_cols[crit_c]):
            raise AssertionError("critical column left uncovered by support edge")
    return perm


def perm_matrix(perm: np.ndarray) -> np.ndarray:
    """Dense 0/1 permutation matrix from ``perm[i] = j``."""
    n = len(perm)
    P = np.zeros((n, n), dtype=np.float64)
    P[np.arange(n), perm] = 1.0
    return P
