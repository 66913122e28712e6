"""The host online controller: stateful cross-period scheduling, a copy of
``repro.online.controller`` (numpy, the reference's float64 order).

``OnlineController.step`` schedules one controller period *statefully*:

1. **Warm-start decomposition** — re-REFINE the previous period's
   permutation set against the new demand (one greedy pass, zero matching
   solves). If the old set still covers the new support — the common case
   for periodic AI training traffic — the expensive per-round MWM of a
   fresh DECOMPOSE is skipped entirely. The support-pattern **matching
   cache** extends this beyond strict period adjacency: decompositions are
   memoized by support pattern, so a workload cycling through a few phases
   re-uses each phase's permutation set whenever that phase comes round
   again.
2. **Reuse-then-LPT** — each switch first claims a round equal to its
   installed permutation (served first, δ-free), the rest is plain LPT on
   the credited loads.
3. **Credit-aware EQUALIZE** — Alg. 4 with a −δ load offset on switches
   holding a carried configuration.
4. **Best-of selection** — the stateless schedule (computed here, or passed
   in from a batched stateless run) with the reuse credit applied post-hoc
   is always a candidate, so the chosen effective makespan is ≤ the
   stateless makespan **by construction**.
5. **State advance** — each switch's installed permutation becomes the last
   configuration it served.

This mirrors ``repro_torch.core.torchopt.online_torch`` (the batched device
step and its rolling loop over a trace) policy for policy; the device path
is the production hot path, this is the exact float64 reference and the
numpy-solver path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..core.decompose import Decomposition, decompose, refine_greedy
from ..core.equalize import equalize
from ..core.schedule import ParallelSchedule, SwitchSchedule
from .state import (
    SwitchState,
    advance_installed,
    apply_reuse_order,
    effective_loads,
    perm_key,
    reuse_marks,
)


@dataclass
class OnlinePeriodOutcome:
    """One stateful period: the chosen schedule plus reuse accounting."""

    schedule: ParallelSchedule     # reuse serve order (carried config first)
    reused_switches: np.ndarray    # (s,) bool — switches serving δ-free first
    makespan: float                # credit-aware (effective) makespan
    stateless_makespan: float      # the stateless reference for this period
    reuse_count: int               # switches with a carried configuration
    delta_paid: float              # δ · (configs − reuse_count)
    delta_avoided: float           # δ · reuse_count
    warm: bool                     # warm-start decomposition used
    num_configs: int
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def improvement(self) -> float:
        """stateless − online makespan (≥ 0 by construction)."""
        return self.stateless_makespan - self.makespan


def _line_sum(D: np.ndarray) -> float:
    return float(max(D.sum(axis=0).max(initial=0.0),
                     D.sum(axis=1).max(initial=0.0)))


def _warm_decomposition(
    D: np.ndarray,
    prev_perms: list[np.ndarray],
    ref_ratio: float | None,
    slack: float,
    tol: float = 1e-9,
) -> Decomposition | None:
    """Previous period's permutation set re-REFINEd onto ``D`` — or None
    when the old set no longer covers the new support OR fails the quality
    gate.

    Coverage alone does not bound quality: re-REFINE along a *stale*
    permutation set can badly over-provision when weights drift. Σα /
    max-line-sum is scale-free and ≥ 1 for any cover, so the warm set is
    accepted only when its ratio stays within ``slack`` of the last fresh
    decomposition's (``ref_ratio``) and its round count doesn't exceed
    ``degree(D)`` (a fresh decomposition's exact k).
    """
    if not prev_perms:
        return None
    alphas = refine_greedy(D, [0.0] * len(prev_perms), prev_perms)
    cov = np.zeros_like(D)
    rows = np.arange(D.shape[0])
    for perm, a in zip(prev_perms, alphas):
        cov[rows, perm] += a
    if (D - cov).max() > tol * max(float(D.max()), 1.0):
        return None
    keep = [(p, a) for p, a in zip(prev_perms, alphas) if a > 0]
    from ..core.decompose import degree

    if len(keep) > degree(D):
        return None
    if ref_ratio is not None:
        L = _line_sum(D)
        warm_ratio = sum(a for _, a in keep) / L if L > 0 else 0.0
        if warm_ratio > ref_ratio * (1.0 + slack):
            return None
    return Decomposition(
        perms=[p for p, _ in keep], alphas=[a for _, a in keep]
    )


def _reuse_then_lpt(
    dec: Decomposition, state: SwitchState, s: int, delta: float
) -> tuple[ParallelSchedule, np.ndarray]:
    """Reuse-aware Alg. 3 (see module doc). Switch lists come out in round
    order with the carried configuration first — the serve order the
    simulator replays."""
    keys = state.installed_keys()
    used: set[int] = set()
    assign: dict[int, int] = {}
    loads = np.zeros(s, dtype=np.float64)
    reused_round = [-1] * s
    for h in range(s):
        if keys[h] is None:
            continue
        for r, perm in enumerate(dec.perms):
            if r not in used and dec.alphas[r] > 0 and perm_key(perm) == keys[h]:
                used.add(r)
                assign[r] = h
                loads[h] += dec.alphas[r]
                reused_round[h] = r
                break
    remaining = [
        r for r in range(len(dec.perms)) if r not in used and dec.alphas[r] > 0
    ]
    for r in sorted(remaining, key=lambda r: (-dec.alphas[r], r)):
        h = int(np.argmin(loads))
        assign[r] = h
        loads[h] += delta + dec.alphas[r]
    switches = [SwitchSchedule() for _ in range(s)]
    marks = np.zeros(s, dtype=bool)
    for h in range(s):
        rounds = sorted(r for r, hh in assign.items() if hh == h)
        if reused_round[h] >= 0:
            rounds.remove(reused_round[h])
            rounds.insert(0, reused_round[h])
            marks[h] = True
        for r in rounds:
            switches[h].perms.append(np.asarray(dec.perms[r]))
            switches[h].alphas.append(float(dec.alphas[r]))
    return ParallelSchedule(switches=switches, delta=delta), marks


@dataclass
class OnlineController:
    """Stateful cross-period scheduler over ``s`` parallel switches.

    ``warm_start`` gates the previous-period decomposition reuse, and
    ``warm_slack`` its quality gate (warm Σα may exceed the last fresh
    decomposition's scale-free weight ratio by at most this fraction);
    ``cache_size`` bounds the support-pattern matching cache (0 disables).
    ``delta`` is the default reconfiguration delay — ``step`` takes a
    per-period override, which is how trace-aware δ schedules flow through.
    """

    s: int
    delta: float
    warm_start: bool = True
    warm_slack: float = 0.05
    merge_aware: bool = False
    do_equalize: bool = True
    cache_size: int = 8

    def __post_init__(self) -> None:
        if self.s < 1:
            raise ValueError(f"need at least one switch, got s={self.s}")
        if self.delta < 0:
            raise ValueError(f"delta must be nonnegative, got {self.delta}")
        self.state = SwitchState.initial(self.s)
        self.period = 0

    def reset(self) -> None:
        self.state = SwitchState.initial(self.s)
        self.period = 0

    # ------------------------------------------------------------------ step
    def step(
        self,
        D: np.ndarray,
        *,
        delta: float | None = None,
        stateless: ParallelSchedule | None = None,
        decomposition: Decomposition | None = None,
    ) -> OnlinePeriodOutcome:
        """Schedule one period against the carried state and advance it.

        ``stateless`` / ``decomposition`` let a caller that already ran the
        stateless solver (e.g. ``run_scenario``'s batched baseline) donate
        its schedule and decomposition; otherwise both are computed here
        (host DECOMPOSE → LPT → EQUALIZE).
        """
        D = np.asarray(D, dtype=np.float64)
        delta = self.delta if delta is None else float(delta)
        if delta < 0:
            raise ValueError(f"delta must be nonnegative, got {delta}")
        state = self.state
        carried_n = next(
            (len(p) for p in state.installed if p is not None), None
        )
        if carried_n is not None and carried_n != D.shape[0]:
            raise ValueError(
                f"demand matrix is {D.shape[0]}x{D.shape[0]} but the carried "
                f"switch state is for n={carried_n}; open a fresh controller "
                "(or reset()) to change fabric size"
            )

        # Decomposition: warm (previous period / support cache) or donated
        # or fresh.
        warm_dec = None
        if self.warm_start:
            warm_dec = _warm_decomposition(
                D, state.prev_perms, state.fresh_ratio, self.warm_slack
            )
            if warm_dec is None and self.cache_size:
                cached = state.support_cache.get(perm_key(D > 0))
                if cached is not None:
                    warm_dec = _warm_decomposition(
                        D, cached[0], cached[1], self.warm_slack
                    )
        dec = warm_dec
        if dec is None:
            dec = decomposition if decomposition is not None else decompose(D)

        def build(dec_, baseline):
            """Candidate B (reuse-then-LPT + credit-aware EQUALIZE) vs
            candidate A (the stateless baseline with the credit applied
            post-hoc — free, and when ``baseline`` is the true stateless
            schedule it pins online ≤ stateless by construction)."""
            cand, marks_b = _reuse_then_lpt(dec_, state, self.s, delta)
            if self.do_equalize:
                cand = equalize(
                    cand,
                    merge_aware=self.merge_aware,
                    load_offset=-delta * marks_b.astype(np.float64),
                )
            cand, marks_b = apply_reuse_order(cand, state)
            mk_b = float(effective_loads(cand, marks_b).max())
            if baseline is None:
                from ..core.schedule import schedule_lpt

                baseline = schedule_lpt(dec_, self.s, delta)
                if self.do_equalize:
                    baseline = equalize(
                        baseline, merge_aware=self.merge_aware
                    )
            base_mk = baseline.makespan()
            cand_a, marks_a = apply_reuse_order(baseline, state)
            mk_a = float(effective_loads(cand_a, marks_a).max())
            if mk_b <= mk_a:
                return cand, marks_b, mk_b, float(base_mk)
            return cand_a, marks_a, mk_a, float(base_mk)

        from ..core.lower_bounds import lower_bound

        lb = lower_bound(D, self.s, delta)
        chosen, marks, mk, stateless_mk = build(dec, stateless)
        # Outcome-level warm gate: without a donated true baseline the
        # "stateless" reference above came from the warm decomposition
        # itself, so a drifted warm set could silently degrade quality.
        # The last fresh period's makespan/LB gap is a scale-free outcome
        # reference: a warm period whose effective makespan exceeds
        # lb · fresh_gap · (1 + slack) is REDONE with a fresh decomposition.
        if (
            warm_dec is not None
            and stateless is None
            and lb > 0
            and state.fresh_gap is not None
            and mk > lb * state.fresh_gap * (1.0 + self.warm_slack)
        ):
            warm_dec = None
            dec = decomposition if decomposition is not None else decompose(D)
            chosen, marks, mk, stateless_mk = build(dec, None)

        reuse_count = int(marks.sum())
        num_configs = chosen.num_configs()
        outcome = OnlinePeriodOutcome(
            schedule=chosen,
            reused_switches=marks,
            makespan=mk,
            stateless_makespan=float(stateless_mk),
            reuse_count=reuse_count,
            delta_paid=delta * (num_configs - reuse_count),
            delta_avoided=delta * reuse_count,
            warm=warm_dec is not None,
            num_configs=num_configs,
            extras={"period": self.period, "delta": delta},
        )

        # Advance the carry. The warm-quality references ratchet only on
        # FRESH (or donated-baseline) periods, and only DOWNWARD (running
        # min): a warm set accepted at ref·(1+slack) must never raise the
        # bar for the next period (compounding drift), and the tightest
        # fresh quality ever observed is the honest reference — so an
        # accepted warm period is within ``warm_slack`` of fresh quality
        # whenever the current period is no easier than the easiest seen.
        fresh_ratio, fresh_gap = state.fresh_ratio, state.fresh_gap
        if warm_dec is None:
            L = _line_sum(D)
            if L > 0:
                ratio = dec.total_weight() / L
                fresh_ratio = (
                    ratio if fresh_ratio is None else min(fresh_ratio, ratio)
                )
            if lb > 0:
                gap = stateless_mk / lb
                fresh_gap = (
                    gap if fresh_gap is None else min(fresh_gap, gap)
                )
        cache = state.support_cache
        self.state = SwitchState(
            installed=advance_installed(chosen, state, marks),
            prev_perms=[np.asarray(p) for p in dec.perms],
            prices=state.prices,
            fresh_ratio=fresh_ratio,
            fresh_gap=fresh_gap,
            support_cache=cache,
        )
        if self.cache_size:
            cache[perm_key(D > 0)] = (self.state.prev_perms, fresh_ratio)
            while len(cache) > self.cache_size:
                cache.pop(next(iter(cache)))
        self.period += 1
        return outcome

    # ----------------------------------------------------------- whole trace
    def solve_trace(
        self,
        demands: np.ndarray,
        *,
        deltas: np.ndarray | None = None,
        stateless: list[ParallelSchedule] | None = None,
        decompositions: list[Decomposition] | None = None,
    ) -> list[OnlinePeriodOutcome]:
        """Run ``step`` over a (T, n, n) stack, carrying state throughout."""
        demands = np.asarray(demands, dtype=np.float64)
        T = demands.shape[0]
        if deltas is not None and len(deltas) != T:
            raise ValueError(f"need {T} per-period deltas, got {len(deltas)}")
        out = []
        for t in range(T):
            out.append(
                self.step(
                    demands[t],
                    delta=None if deltas is None else float(deltas[t]),
                    stateless=None if stateless is None else stateless[t],
                    decomposition=(
                        None if decompositions is None else decompositions[t]
                    ),
                )
            )
        return out
