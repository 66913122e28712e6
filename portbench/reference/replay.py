"""The yardstick's reading of a returned schedule: its structure, its Eq. 3
coverage of the demand and its makespan, replayed from the permutations,
weights and switch assignment alone (nothing of the program's own figures).

A schedule here is a list, one entry per switch, of ``(perms, alphas)``:
``perms`` an (m, n) integer array, row r the configuration ``perm[i] = j``
held for ``alphas[r]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .spectra import Decomposition, degree, equalize, lower_bound, schedule_lpt, spectra


@dataclass
class Reading:
    """What the check reads from one returned schedule."""

    invalid: str       # "" when the schedule is well formed, else why not
    cover_gap: float   # max(D - coverage) / max line sum of D
    makespan: float    # Eq. 3 replay: max over switches of sum(alpha + delta)
    lower_bound: float  # §IV bound of D, from the reference
    k_ref: int         # degree(D): DECOMPOSE's matcher calls on D


def max_line_sum(D: np.ndarray) -> float:
    return float(max(D.sum(axis=1).max(), D.sum(axis=0).max(), 0.0))


def structure_fault(switches, n: int, s: int) -> str:
    """Why ``switches`` is no schedule of s switches over n ports, or ""."""
    if len(switches) != s:
        return f"{len(switches)} switches, expected {s}"
    ident = np.arange(n)
    for h, (perms, alphas) in enumerate(switches):
        if perms.ndim != 2 or perms.shape[1:] != (n,) or len(alphas) != perms.shape[0]:
            return f"switch {h}: perms {perms.shape}, alphas {len(alphas)}"
        if not np.all(np.isfinite(alphas)) or np.any(alphas < 0):
            return f"switch {h}: a weight is negative or not finite"
        if perms.shape[0] and not np.array_equal(np.sort(perms, axis=1), np.broadcast_to(ident, perms.shape)):
            return f"switch {h}: a configuration is not a permutation"
    return ""


def coverage(switches, n: int) -> np.ndarray:
    """Eq. 3's left side: the demand each port pair is served, in float64."""
    idx = [(np.arange(n) * n)[None, :] + perms for perms, _ in switches]
    w = [np.repeat(alphas, n) for _, alphas in switches]
    cov = np.bincount(np.concatenate([i.ravel() for i in idx]), np.concatenate(w), minlength=n * n)
    return cov.reshape(n, n)


def replay_makespan(switches, delta: float) -> float:
    return float(max((float(np.sum(a, dtype=np.float64)) + delta * len(a) for _, a in switches), default=0.0))


def read(D: np.ndarray, switches, s: int, delta: float, *, bound: bool = True) -> Reading:
    """Read one schedule against its demand matrix ``D`` (float64)."""
    n = D.shape[0]
    switches = [(np.asarray(p, dtype=np.int64).reshape(-1, n), np.asarray(a, dtype=np.float64))
                for p, a in switches]
    fault = structure_fault(switches, n, s)
    if fault:
        return Reading(fault, float("inf"), float("nan"), float("nan"), degree(D))
    gap = float((D - coverage(switches, n)).max()) / max(max_line_sum(D), 1e-300)
    return Reading(
        "", max(gap, 0.0), replay_makespan(switches, delta),
        lower_bound(D, s, delta) if bound else float("nan"), degree(D),
    )


@dataclass
class Makespans:
    """A sampled schedule's makespan beside the reference's two."""

    excess: float           # replayed makespan / the reference's spectra(D) makespan - 1
    schedule_excess: float  # replayed makespan / the reference's LPT + EQUALIZE of the same configurations - 1


def configurations(switches) -> Decomposition:
    """The schedule's configurations with the weight each gets over all
    switches (EQUALIZE's split pieces summed), in the order they first appear;
    weights of 0 are left out, as the program's LPT leaves them out."""
    weights: dict[bytes, float] = {}
    perms: dict[bytes, np.ndarray] = {}
    for ps, alphas in switches:
        for perm, a in zip(ps, alphas):
            key = perm.tobytes()
            perms.setdefault(key, perm)
            weights[key] = weights.get(key, 0.0) + float(a)
    keys = [k for k in perms if weights[k] > 0.0]
    return Decomposition([perms[k] for k in keys], [weights[k] for k in keys])


def makespans(D: np.ndarray, switches, s: int, delta: float) -> Makespans:
    """Hold a well-formed schedule's replayed makespan against the reference's
    whole pipeline on ``D``, and against the reference's LPT and EQUALIZE of
    the schedule's own configurations (which judges the switch assignment
    apart from the matcher)."""
    n = D.shape[0]
    switches = [(np.asarray(p, dtype=np.int64).reshape(-1, n), np.asarray(a, dtype=np.float64))
                for p, a in switches]
    mine = replay_makespan(switches, delta)
    whole = spectra(D, s, delta).makespan
    placed = equalize(schedule_lpt(configurations(switches), s, delta)).makespan()
    return Makespans(mine / whole - 1.0, mine / placed - 1.0)


def from_parallel_schedule(sched) -> list[tuple[np.ndarray, np.ndarray]]:
    """``(perms, alphas)`` per switch from any object with ``switches``, each
    holding ``perms`` and ``alphas`` lists (the program's and the reference's
    schedules alike)."""
    out = []
    for sw in sched.switches:
        n_cfg = len(sw.perms)
        perms = np.stack([np.asarray(p) for p in sw.perms]) if n_cfg else np.zeros((0, 0), np.int64)
        out.append((perms, np.asarray(list(sw.alphas), dtype=np.float64)))
    return out
