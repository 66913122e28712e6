"""Comparison algorithms from the paper's evaluation (§V-A), a copy of
``repro.core.baselines`` (the same float64 operation order, so the same
schedules).

* BASELINE — the LESS-style [9] split-then-schedule approach: split D into s
  sub-matrices maximizing sparsity under line-sum balance, then decompose
  each sub-matrix independently with our DECOMPOSE (the paper does the same
  for an apples-to-apples comparison) and take the max per-switch makespan.

* ECLIPSE [6] — state-of-the-art single-switch decomposition with
  reconfiguration delays: repeatedly pick the (permutation, duration) pair
  maximizing covered-demand-per-unit-time ``Σ min(D_rem, α·P) / (α + δ)``
  over a geometric α-grid (one unconstrained MWM per candidate α).
  "SPECTRA (ECLIPSE)" = this decomposition + our SCHEDULE + EQUALIZE.
"""

from __future__ import annotations

import numpy as np

from .decompose import Decomposition, decompose, refine_greedy
from .matching import max_weight_perfect_matching
from .schedule import ParallelSchedule, SwitchSchedule


# ---------------------------------------------------------------------------
# BASELINE: LESS-style sparsity-maximizing split into s sub-matrices.
# ---------------------------------------------------------------------------

def less_split(D: np.ndarray, s: int) -> list[np.ndarray]:
    """Split D into s sub-matrices, keeping elements whole where possible.

    Elements are placed in descending weight; each goes whole to the switch
    with the most remaining line budget (budget = max line sum of D over s,
    the balance criterion), splitting across switches only on overflow.
    Keeping big elements whole minimizes the total number of nonzeros across
    the sub-matrices — LESS's sparsity objective.
    """
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    T = float(max(D.sum(axis=1).max(), D.sum(axis=0).max()))
    budget = T / s + 1e-12
    parts = [np.zeros_like(D) for _ in range(s)]
    row_load = np.zeros((s, n))
    col_load = np.zeros((s, n))
    order = np.argsort(-D, axis=None, kind="stable")
    for flat in order:
        a, b = divmod(int(flat), n)
        v = D[a, b]
        if v <= 0:
            break
        # Remaining budget per switch for this element's row and column.
        room = np.minimum(budget - row_load[:, a], budget - col_load[:, b])
        h = int(np.argmax(room))
        if room[h] >= v - 1e-12:
            placed = [(h, v)]
        else:
            # Overflow: split across switches in descending-room order.
            placed = []
            rem = v
            for h in np.argsort(-room):
                take = min(rem, max(room[h], 0.0))
                if take <= 0:
                    continue
                placed.append((int(h), float(take)))
                rem -= take
                if rem <= 1e-12:
                    break
            if rem > 1e-12:  # budgets exhausted by fp slack; dump remainder
                placed.append((int(np.argmax(room)), float(rem)))
        for h, val in placed:
            parts[h][a, b] += val
            row_load[h, a] += val
            col_load[h, b] += val
    return parts


def baseline_less(D: np.ndarray, s: int, delta: float) -> ParallelSchedule:
    """BASELINE: LESS split + per-switch DECOMPOSE; no cross-switch balance."""
    parts = less_split(D, s)
    switches = []
    for Dh in parts:
        if (Dh > 0).any():
            dec = decompose(Dh)
            switches.append(SwitchSchedule(perms=dec.perms, alphas=dec.alphas))
        else:
            switches.append(SwitchSchedule())
    return ParallelSchedule(switches=switches, delta=delta)


# ---------------------------------------------------------------------------
# ECLIPSE decomposition.
# ---------------------------------------------------------------------------

def _alpha_grid(D_rem: np.ndarray, base: float = 2.0, max_points: int = 16) -> np.ndarray:
    hi = float(D_rem.max())
    pos = D_rem[D_rem > 0]
    lo = float(pos.min())
    if hi <= 0:
        return np.array([])
    if lo >= hi:
        return np.array([hi])
    num = min(max_points, max(2, int(np.ceil(np.log(hi / lo) / np.log(base))) + 1))
    return np.geomspace(lo, hi, num=num)


def eclipse_decompose(
    D: np.ndarray,
    delta: float,
    *,
    coverage_tol: float = 1e-6,
    max_perms: int = 4096,
) -> Decomposition:
    """ECLIPSE-style greedy submodular cover with reconfiguration cost."""
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    rows = np.arange(n)
    D_rem = D.copy()
    total = float(D.sum())
    dec = Decomposition()
    stall = 0
    while D_rem.sum() > coverage_tol * max(total, 1e-30) and len(dec.perms) < max_perms:
        best_score, best_alpha, best_perm = -1.0, None, None
        grid = _alpha_grid(D_rem)
        if stall >= 2:  # guard: force full service of the heaviest matching
            grid = np.array([float(D_rem.max())])
        for alpha in grid:
            W = np.minimum(D_rem, alpha)
            perm = max_weight_perfect_matching(W)
            val = float(W[rows, perm].sum())
            score = val / (alpha + delta)
            if score > best_score:
                best_score, best_alpha, best_perm = score, float(alpha), perm
        if best_perm is None:  # pragma: no cover
            break
        served = np.minimum(D_rem[rows, best_perm], best_alpha)
        progressed = float(served.sum()) > 0
        stall = 0 if progressed else stall + 1
        dec.perms.append(best_perm)
        dec.alphas.append(best_alpha)
        D_rem[rows, best_perm] -= best_alpha
        np.maximum(D_rem, 0.0, out=D_rem)
    # Top up: guarantee full coverage (the makespan objective requires it).
    if (D_rem > 0).any():
        tail = decompose(D_rem)
        dec.perms.extend(tail.perms)
        dec.alphas.extend(tail.alphas)
    dec.alphas = refine_greedy(D, dec.alphas, dec.perms)
    return dec


# ---------------------------------------------------------------------------
# ROTOR: demand-oblivious round-robin permutation sequences (RotorNet-style).
# ---------------------------------------------------------------------------

def rotor_offsets(
    n: int, s: int, *, include_identity: bool = False
) -> list[list[int]]:
    """Round-robin assignment of cyclic-shift offsets to s switches.

    The full rotor cycle is the n−1 cyclic shifts ``src → (src+k) mod n``
    for k = 1..n−1 (every ordered pair of distinct ports is connected by
    exactly one shift); switch h serves offsets ``h, h+s, h+2s, …`` of
    that sequence. ``include_identity`` prepends k = 0 — only needed when
    the demand has intra-rack (diagonal) entries, which only the identity
    configuration can serve.
    """
    if n < 2:
        raise ValueError(f"need at least two ports, got n={n}")
    if s < 1:
        raise ValueError(f"need at least one switch, got s={s}")
    offs = ([0] if include_identity else []) + list(range(1, n))
    return [offs[h::s] for h in range(s)]


def rotor_schedule(
    n: int,
    s: int,
    delta: float,
    slot: float,
    *,
    cycles: int = 1,
    include_identity: bool = False,
) -> ParallelSchedule:
    """Fixed round-robin rotor schedule: no matching solves, equal slots.

    Each switch cycles through its ``rotor_offsets`` shifts ``cycles``
    times, serving every configuration for exactly ``slot`` time units
    (paying δ before each — a rotor reconfigures blindly, it has no
    demand knowledge to reuse circuits with). Per full cycle, every
    ordered port pair gets exactly ``slot`` units of direct service, so
    the per-switch load — and the makespan, since the assignment is
    perfectly balanced up to one slot — has the closed form

        makespan = max_h |offsets_h| · cycles · (slot + δ).
    """
    if slot < 0:
        raise ValueError(f"slot must be nonnegative, got {slot}")
    if cycles < 1:
        raise ValueError(f"need at least one cycle, got {cycles}")
    base = np.arange(n)
    switches = []
    for offs in rotor_offsets(n, s, include_identity=include_identity):
        sw = SwitchSchedule()
        for _ in range(cycles):
            for k in offs:
                sw.perms.append((base + k) % n)
                sw.alphas.append(float(slot))
        switches.append(sw)
    return ParallelSchedule(switches=switches, delta=delta)
