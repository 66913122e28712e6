"""Frozen plain-NumPy SPECTRA: DECOMPOSE (Alg. 1 + greedy REFINE, Alg. 2),
SCHEDULE (LPT, Alg. 3), EQUALIZE (Alg. 4) and the §IV lower bound.

A frozen copy of the host ``spectra`` that the PyTorch port carries
(``core/{decompose,matching,schedule,equalize,lower_bounds,spectra}.py``),
trimmed to the paper-faithful path: the node-coverage matching by weight
augmentation, solved by scipy's Jonker-Volgenant ``linear_sum_assignment``
where scipy is present and by a plain NumPy Hungarian algorithm otherwise.
It imports nothing of the program, so a later change to the program cannot
move it. Float64 throughout.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment as _scipy_lsa
except ImportError:  # pragma: no cover - scipy is present where the benchmark runs
    _scipy_lsa = None


# --------------------------------------------------------------- matching
def hungarian_min_cost(cost: np.ndarray) -> np.ndarray:
    """O(n^3) Hungarian algorithm (potentials + shortest paths); returns
    ``perm`` minimising ``sum_i cost[i, perm[i]]``."""
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)  # p[j]: row matched to column j (1-based)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        way = np.zeros(n + 1, dtype=np.int64)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = ~used[1:] & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:] = np.where(better, j0, way[1:])
            masked = np.where(used[1:], np.inf, minv[1:])
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:] = np.where(used[1:], minv[1:], minv[1:] - delta)
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    perm = np.empty(n, dtype=np.int64)
    perm[p[1:] - 1] = np.arange(n)
    return perm


def max_weight_perfect_matching(weights: np.ndarray) -> np.ndarray:
    """Permutation ``perm`` maximising ``sum_i weights[i, perm[i]]``."""
    weights = np.asarray(weights, dtype=np.float64)
    if _scipy_lsa is None:  # pragma: no cover
        return hungarian_min_cost(-weights)
    rows, cols = _scipy_lsa(weights, maximize=True)
    perm = np.empty(weights.shape[0], dtype=np.int64)
    perm[rows] = cols
    return perm


def mwm_node_coverage(D_rem: np.ndarray, S_rem: np.ndarray) -> np.ndarray:
    """Alg. 1 line 4: a permutation through an uncovered support entry of
    every critical line of ``S_rem``, of maximum ``D_rem`` weight among those
    (a bonus ``M > sum(D_rem)`` per critical endpoint on support entries)."""
    S = np.asarray(S_rem, dtype=bool)
    row_deg, col_deg = S.sum(axis=1), S.sum(axis=0)
    k = int(max(row_deg.max(initial=0), col_deg.max(initial=0)))
    if k == 0:
        raise ValueError("S_rem is empty; nothing to cover")
    crit_r, crit_c = row_deg == k, col_deg == k
    base = np.maximum(D_rem, 0.0)
    M = float(base.sum()) + 1.0
    bonus = (crit_r[:, None].astype(np.float64) + crit_c[None, :]) * M
    return max_weight_perfect_matching(base + np.where(S, bonus, 0.0))


# -------------------------------------------------------------- decompose
@dataclass
class Decomposition:
    perms: list[np.ndarray] = field(default_factory=list)  # perm[i] = column of row i
    alphas: list[float] = field(default_factory=list)


def degree(D: np.ndarray) -> int:
    """Max number of nonzero entries in any row or column: the number of
    rounds DECOMPOSE takes (Property 1)."""
    S = np.asarray(D) > 0
    if not S.any():
        return 0
    return int(max(S.sum(axis=1).max(), S.sum(axis=0).max()))


def refine_greedy(D: np.ndarray, alphas: list[float], perms: list[np.ndarray]) -> list[float]:
    """Alg. 2: raise each weight, in order, by what is still uncovered on it."""
    D = np.asarray(D, dtype=np.float64)
    rows = np.arange(D.shape[0])
    R = D.copy()
    for perm, a in zip(perms, alphas):
        R[rows, perm] -= a
    np.maximum(R, 0.0, out=R)
    out = list(alphas)
    for i, perm in enumerate(perms):
        d = float(R[rows, perm].max())
        if d > 0.0:
            out[i] += d
            R[rows, perm] = np.maximum(0.0, R[rows, perm] - d)
    return out


def decompose(D: np.ndarray) -> Decomposition:
    """Alg. 1: exactly ``degree(D)`` weighted permutations covering D."""
    D = np.asarray(D, dtype=np.float64)
    rows = np.arange(D.shape[0])
    S_rem = D > 0
    D_rem = D.copy()
    dec = Decomposition()
    while S_rem.any():
        perm = mwm_node_coverage(D_rem, S_rem)
        newly = S_rem[rows, perm]
        vals = D_rem[rows, perm][newly]
        alpha = float(vals.min()) if vals.size else 0.0
        dec.perms.append(perm)
        dec.alphas.append(alpha)
        D_rem[rows, perm] -= alpha
        np.maximum(D_rem, 0.0, out=D_rem)
        S_rem[rows, perm] = False
    dec.alphas = refine_greedy(D, dec.alphas, dec.perms)
    return dec


# --------------------------------------------------------------- schedule
@dataclass
class SwitchSchedule:
    perms: list[np.ndarray] = field(default_factory=list)
    alphas: list[float] = field(default_factory=list)

    def load(self, delta: float) -> float:
        return float(sum(self.alphas) + delta * len(self.alphas))


@dataclass
class ParallelSchedule:
    switches: list[SwitchSchedule]
    delta: float

    def loads(self) -> np.ndarray:
        return np.array([sw.load(self.delta) for sw in self.switches])

    def makespan(self) -> float:
        return float(self.loads().max()) if self.switches else 0.0


def schedule_lpt(dec: Decomposition, s: int, delta: float) -> ParallelSchedule:
    """Alg. 3: non-increasing weight order, each onto the least-loaded switch
    (lowest index on ties)."""
    order = np.argsort(-np.asarray(dec.alphas), kind="stable")
    switches = [SwitchSchedule() for _ in range(s)]
    heap = [(0.0, h) for h in range(s)]
    heapq.heapify(heap)
    for i in order:
        load, h = heapq.heappop(heap)
        switches[h].perms.append(dec.perms[i])
        switches[h].alphas.append(float(dec.alphas[i]))
        heapq.heappush(heap, (load + delta + float(dec.alphas[i]), h))
    return ParallelSchedule(switches=switches, delta=delta)


def equalize(sched: ParallelSchedule) -> ParallelSchedule:
    """Alg. 4, in place: move a ``τ = (L_max − L_min − δ)/2`` slice of the
    longest permutation on the most loaded switch to the least loaded one,
    until the spread is at most δ or that permutation is too short."""
    s, delta = len(sched.switches), sched.delta
    if s <= 1:
        return sched
    loads = sched.loads()
    n_configs = sum(len(sw.perms) for sw in sched.switches)
    for _ in range(64 * (n_configs + s) + 64):
        h_max, h_min = int(np.argmax(loads)), int(np.argmin(loads))
        if loads[h_max] - loads[h_min] <= delta:
            break
        src, dst = sched.switches[h_max], sched.switches[h_min]
        if not src.alphas:
            break
        z = int(np.argmax(src.alphas))
        mu = (loads[h_max] + loads[h_min] + delta) / 2.0
        tau = loads[h_max] - mu
        if tau <= 0 or src.alphas[z] <= tau:
            break
        src.alphas[z] -= tau
        dst.perms.append(src.perms[z].copy())
        dst.alphas.append(tau)
        loads[h_max] -= tau
        loads[h_min] += delta + tau
    return sched


# ----------------------------------------------------------- lower bound
def _lb_theorem2(x: np.ndarray, s: int, delta: float) -> float:
    """Theorem 2 for one line with exactly s nonzeros ``x``."""
    x = np.sort(np.asarray(x, dtype=np.float64))[::-1]
    w = float(x.sum())
    pad = np.zeros(s * s + 2)
    pad[: len(x)] = x

    def xj(j: int) -> float:  # 1-based, zero beyond s
        return float(pad[j - 1]) if j >= 1 else 0.0

    opts = [xj(1), max(xj(2), (w + delta) / s, xj(s) + delta)]
    opts += [max(xj(m + 1), (w + m * delta) / s) for m in range(2, s * s + 1)]
    return delta + min(opts)


def lower_bound(D: np.ndarray, s: int, delta: float) -> float:
    """§IV, Property 2: the max over all 2n lines of Theorem 1, and of
    Theorem 2 on lines with exactly s nonzeros."""
    D = np.asarray(D, dtype=np.float64)
    best = 0.0
    for M in (D, D.T):
        for line in M:
            nz = line[line > 0]
            if len(nz) == 0:
                continue
            w = float(nz.sum())
            best = max(best, (w + delta * max(len(nz), s)) / s)
            if len(nz) == s:
                best = max(best, _lb_theorem2(nz, s, delta))
    return best


# -------------------------------------------------------------- end to end
@dataclass
class SpectraResult:
    schedule: ParallelSchedule
    decomposition: Decomposition
    makespan: float
    lower_bound: float


def spectra(D: np.ndarray, s: int, delta: float) -> SpectraResult:
    """DECOMPOSE → SCHEDULE → EQUALIZE, and the §IV bound."""
    D = np.asarray(D, dtype=np.float64)
    dec = decompose(D)
    sched = equalize(schedule_lpt(dec, s, delta))
    return SpectraResult(sched, dec, sched.makespan(), lower_bound(D, s, delta))
