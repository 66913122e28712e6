"""Host DECOMPOSE (Alg. 1) + REFINE (Alg. 2), a copy of ``repro.core.decompose``.

``Decomposition`` holds weighted permutations covering a demand matrix;
``decompose`` covers D with exactly ``k = degree(D)`` of them, each round a
node-coverage-constrained MWM (``core/matching.py``), then REFINE
(``greedy``, ``lp`` or ``signed``) sets the weights. The batched device
DECOMPOSE is ``core/torchopt/decompose_torch.py``; this host one runs the
OCS controller tick's ``spectra`` solver.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs.trace import span as _span
from .matching import mwm_node_coverage


@dataclass
class Decomposition:
    """Weighted permutations covering a demand matrix."""

    perms: list[np.ndarray] = field(default_factory=list)  # each perm[i] = col
    alphas: list[float] = field(default_factory=list)

    @property
    def k(self) -> int:
        return len(self.perms)

    def total_weight(self) -> float:
        return float(sum(self.alphas))

    def coverage(self, n: int) -> np.ndarray:
        out = np.zeros((n, n), dtype=np.float64)
        rows = np.arange(n)
        for perm, a in zip(self.perms, self.alphas):
            out[rows, perm] += a
        return out

    def covers(self, D: np.ndarray, tol: float = 1e-9) -> bool:
        return bool(np.all(self.coverage(D.shape[0]) >= np.asarray(D) - tol))


def degree(D: np.ndarray) -> int:
    """Max number of nonzero elements in any row or column."""
    S = np.asarray(D) > 0
    if not S.any():
        return 0
    return int(max(S.sum(axis=1).max(), S.sum(axis=0).max()))


def refine_greedy(D: np.ndarray, alphas: list[float], perms: list[np.ndarray]) -> list[float]:
    """Alg. 2: greedily raise weights until the weighted sum covers D."""
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    rows = np.arange(n)
    R = D.copy()
    for perm, a in zip(perms, alphas):
        R[rows, perm] -= a
    np.maximum(R, 0.0, out=R)  # remaining uncovered demand
    out = list(alphas)
    for i, perm in enumerate(perms):
        d = float(R[rows, perm].max())
        if d > 0.0:
            out[i] += d
            R[rows, perm] = np.maximum(0.0, R[rows, perm] - d)
    return out


def refine_signed(D: np.ndarray, alphas: list[float], perms: list[np.ndarray]) -> list[float]:
    """Beyond-paper REFINE on signed residuals: weights may also shrink.

    Safe: after processing P_i, ``max`` residual over its entries is 0, and
    later steps never push any residual above 0.
    """
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    rows = np.arange(n)
    R = D.copy()
    for perm, a in zip(perms, alphas):
        R[rows, perm] -= a
    out = list(alphas)
    for i, perm in enumerate(perms):
        d = float(R[rows, perm].max())
        d = max(d, -out[i])  # weights must stay >= 0
        if d != 0.0:
            out[i] += d
            R[rows, perm] -= d
    return out


def refine_lp(D: np.ndarray, alphas: list[float], perms: list[np.ndarray]) -> list[float]:
    """Exact Eq. (5): min Σ α̂  s.t.  Σ α̂_i P_i ≥ D, α̂ ≥ 0."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    k = len(perms)
    nz = np.argwhere(D > 0)
    A = lil_matrix((len(nz), k))
    for c, (a, b) in enumerate(nz):
        for i, perm in enumerate(perms):
            if perm[a] == b:
                A[c, i] = -1.0  # -Σ α P ≤ -D
    res = linprog(
        c=np.ones(k),
        A_ub=A.tocsr(),
        b_ub=-D[nz[:, 0], nz[:, 1]],
        bounds=[(0, None)] * k,
        method="highs",
    )
    if not res.success:  # pragma: no cover - LP on feasible cover always solves
        return refine_greedy(D, alphas, perms)
    return [float(x) for x in res.x]


_REFINERS = {"greedy": refine_greedy, "lp": refine_lp, "signed": refine_signed}


def decompose(
    D: np.ndarray,
    *,
    alpha_mode: str = "covered_support",
    refine: str = "greedy",
    validate: bool = True,
) -> Decomposition:
    """Alg. 1: decompose D into exactly ``degree(D)`` weighted permutations."""
    D = np.asarray(D, dtype=np.float64)
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"D must be square, got {D.shape}")
    if (D < 0).any():
        raise ValueError("D must be nonnegative")
    n = D.shape[0]
    rows = np.arange(n)
    S_rem = D > 0
    D_rem = D.copy()
    dec = Decomposition()
    k0 = degree(D)
    while S_rem.any():
        with _span("matcher"):
            perm = mwm_node_coverage(D_rem, S_rem, validate=validate)
        newly = S_rem[rows, perm]
        if alpha_mode == "covered_support":
            vals = D_rem[rows, perm][newly]
            alpha = float(vals.min()) if vals.size else 0.0
        elif alpha_mode == "all_matched":
            alpha = max(float(D_rem[rows, perm].min()), 0.0)
        else:
            raise ValueError(f"unknown alpha_mode {alpha_mode!r}")
        dec.perms.append(perm)
        dec.alphas.append(alpha)
        D_rem[rows, perm] -= alpha
        np.maximum(D_rem, 0.0, out=D_rem)
        S_rem[rows, perm] = False
        if len(dec.perms) > k0:  # pragma: no cover - Property 1 guarantee
            raise AssertionError("decomposition exceeded degree(D) rounds")
    dec.alphas = _REFINERS[refine](D, dec.alphas, dec.perms)
    if validate and not dec.covers(D):  # pragma: no cover - REFINE certifies
        raise AssertionError("refined decomposition does not cover D")
    return dec
