"""Host §IV lower bounds on the parallel-OCS makespan, in float64.

A copy of ``repro.core.lower_bounds``:

* Theorem 1 (any line i with k_i nonzeros, weight w_i):
    LB1_i = (w_i + δ·max(k_i, s)) / s
* Theorem 2 (line i with exactly k_i = s nonzeros x_1 ≥ … ≥ x_s):
    LB2_i = δ + min( x_1,
                     max(x_2, (w_i + δ)/s, x_s + δ),
                     min_{2 ≤ m ≤ s²} max(x_{m+1}, (w_i + m·δ)/s) )
  with x_j := 0 for j > s.
* Property 2: the max over all 2n lines is a lower bound for D.
"""

from __future__ import annotations

import numpy as np


def optimality_gap(makespan: float, lower_bound: float) -> float:
    """makespan / lower_bound; 1.0 for the degenerate 0/0 (empty demand)."""
    if lower_bound <= 0:
        return 1.0 if makespan <= 0 else float("inf")
    return makespan / lower_bound


def lb_theorem1(w: float, k: int, s: int, delta: float) -> float:
    return (w + delta * max(k, s)) / s


def lb_theorem2(x: np.ndarray, s: int, delta: float) -> float:
    """Theorem 2 for one line whose nonzeros are ``x`` (requires len(x)==s)."""
    x = np.sort(np.asarray(x, dtype=np.float64))[::-1]
    if len(x) != s:
        raise ValueError("Theorem 2 requires exactly s nonzero elements")
    w = float(x.sum())
    pad = np.zeros(s * s + 2)
    pad[: len(x)] = x

    def xj(j: int) -> float:  # 1-based, zero beyond s
        return float(pad[j - 1]) if j >= 1 else 0.0

    opts = [xj(1), max(xj(2), (w + delta) / s, xj(s) + delta)]
    opts += [max(xj(m + 1), (w + m * delta) / s) for m in range(2, s * s + 1)]
    return delta + min(opts)


def lower_bound(D: np.ndarray, s: int, delta: float) -> float:
    """Property 2: max over all rows/columns of all applicable bounds."""
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    best = 0.0
    for axis in (1, 0):  # rows then columns
        for i in range(n):
            line = D[i, :] if axis == 1 else D[:, i]
            nz = line[line > 0]
            k_i = len(nz)
            if k_i == 0:
                continue
            w_i = float(nz.sum())
            best = max(best, lb_theorem1(w_i, k_i, s, delta))
            if k_i == s:
                best = max(best, lb_theorem2(nz, s, delta))
    return best
