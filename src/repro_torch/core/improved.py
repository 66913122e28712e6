"""SPECTRA++ — beyond-paper improvements, a copy of ``repro.core.improved``.

The combined best-of variant is ``spectra_pp``; its knobs:

1. merge-aware EQUALIZE       (equalize.py, merge_aware=True)
2. post-LPT local search      (move/swap before any splitting)
3. signed-residual REFINE     (decompose.py, refine="signed")
4. wrap-around scheduler      (binary-search makespan T; McNaughton-style
                               wrap filling with a δ setup per segment)
"""

from __future__ import annotations

import time

import numpy as np

from .decompose import Decomposition, decompose, refine_signed
from .equalize import equalize
from .lower_bounds import lower_bound
from .schedule import ParallelSchedule, SwitchSchedule, schedule_lpt
from .spectra import SpectraResult


def local_search(sched: ParallelSchedule, max_rounds: int = 64) -> ParallelSchedule:
    """Move/swap whole permutations between switches to shrink the makespan.

    Greedy first-improvement: try moving any job off the most-loaded switch,
    then try swapping a long job on it with a shorter job elsewhere.
    """
    delta = sched.delta
    for _ in range(max_rounds):
        loads = sched.loads()
        h_max = int(np.argmax(loads))
        src = sched.switches[h_max]
        improved = False
        # Moves.
        for z in range(len(src.alphas)):
            cost = delta + src.alphas[z]
            for h, sw in enumerate(sched.switches):
                if h == h_max:
                    continue
                new_max_candidates = [loads[h] + cost, loads[h_max] - cost]
                others = [loads[g] for g in range(sched.s) if g not in (h, h_max)]
                if max(new_max_candidates + others) < loads[h_max] - 1e-15:
                    sw.perms.append(src.perms[z])
                    sw.alphas.append(src.alphas[z])
                    del src.perms[z], src.alphas[z]
                    improved = True
                    break
            if improved:
                break
        if improved:
            continue
        # Swaps.
        for z in range(len(src.alphas)):
            az = src.alphas[z]
            for h, sw in enumerate(sched.switches):
                if h == h_max:
                    continue
                for y in range(len(sw.alphas)):
                    ay = sw.alphas[y]
                    if ay >= az:
                        continue
                    d = az - ay
                    others = [loads[g] for g in range(sched.s) if g not in (h, h_max)]
                    if max([loads[h] + d, loads[h_max] - d] + others) < loads[h_max] - 1e-15:
                        src.perms[z], sw.perms[y] = sw.perms[y], src.perms[z]
                        src.alphas[z], sw.alphas[y] = ay, az
                        improved = True
                        break
                if improved:
                    break
            if improved:
                break
        if not improved:
            break
    return sched


def _wrap_fill(dec: Decomposition, s: int, delta: float, T: float) -> ParallelSchedule | None:
    """Try to fit all jobs within makespan T by wrap-around filling.

    Jobs are laid longest-first; each segment placed on a switch costs δ +
    its slice. A job is split when the current switch fills up; the
    continuation pays a fresh δ on the next switch. Returns None if > s
    switches would be needed.
    """
    order = np.argsort(-np.asarray(dec.alphas), kind="stable")
    switches = [SwitchSchedule()]
    cap = T
    for i in order:
        rem = float(dec.alphas[i])
        perm = dec.perms[i]
        while rem > 1e-15:
            room = cap - delta
            if room <= 1e-15:
                switches.append(SwitchSchedule())
                cap = T
                if len(switches) > s:
                    return None
                continue
            take = min(rem, room)
            switches[-1].perms.append(perm)
            switches[-1].alphas.append(take)
            cap -= delta + take
            rem -= take
            if rem > 1e-15:
                switches.append(SwitchSchedule())
                cap = T
                if len(switches) > s:
                    return None
    while len(switches) < s:
        switches.append(SwitchSchedule())
    return ParallelSchedule(switches=switches, delta=delta)


def schedule_wrap(dec: Decomposition, s: int, delta: float, iters: int = 40) -> ParallelSchedule:
    """Binary-search the minimum wrap-around makespan."""
    total = float(sum(dec.alphas)) + delta * dec.k
    lo = max(total / s, max(dec.alphas, default=0.0) * 0 + delta)
    hi = total + delta
    best = _wrap_fill(dec, s, delta, hi)
    assert best is not None
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        cand = _wrap_fill(dec, s, delta, mid)
        if cand is not None and cand.makespan() <= mid + 1e-12:
            best, hi = cand, mid
        else:
            lo = mid
    return best


def spectra_pp(
    D: np.ndarray,
    s: int,
    delta: float,
    *,
    validate: bool = True,
    compute_lb: bool = True,
) -> SpectraResult:
    """Best-of SPECTRA++.

    One DECOMPOSE (the expensive part), two weight refinements (greedy and
    signed — same permutations, different α), three schedulers each
    (paper-faithful LPT+EQUALIZE, LPT + local search + merge-aware EQUALIZE,
    wrap-around binary search); returns the best schedule. Including the
    paper-faithful candidate guarantees SPECTRA++ ≤ SPECTRA.
    """
    D = np.asarray(D, dtype=np.float64)
    t0 = time.perf_counter()
    dec = decompose(D)  # greedy-refined (paper-faithful weights)
    dec_signed = Decomposition(dec.perms, refine_signed(D, dec.alphas, dec.perms))
    cands = [equalize(schedule_lpt(dec, s, delta))]  # paper-faithful
    for d in (dec, dec_signed):
        sched = schedule_lpt(d, s, delta)
        sched = local_search(sched)
        sched = equalize(sched, merge_aware=True)
        cands.append(sched)
        cands.append(schedule_wrap(d, s, delta))
    best = min(cands, key=lambda sc: sc.makespan())
    dt = time.perf_counter() - t0
    if validate:
        best.validate(D)
    lb = lower_bound(D, s, delta) if compute_lb else float("nan")
    return SpectraResult(
        schedule=best,
        decomposition=dec,
        makespan=best.makespan(),
        lower_bound=lb,
        runtime_s=dt,
    )
