"""String-addressable solver registry: ``solve(problem, solver="spectra_torch")``.

Built-in solvers (the reference's, with ``spectra_torch`` in place of
``spectra_jax``):

    spectra          paper-faithful DECOMPOSE → LPT → EQUALIZE (host numpy)
    spectra_no_eq    same, without the EQUALIZE step (Fig. 7 ablation)
    spectra_pp       beyond-paper best-of ensemble (SPECTRA++)
    spectra_eclipse  ECLIPSE decomposition + our SCHEDULE/EQUALIZE
    baseline_less    LESS-style split-then-schedule comparison baseline
    spectra_torch    fused batched DECOMPOSE+LPT+EQUALIZE on the device
    rotor            demand-oblivious round-robin rotor (no matching solves)
    rotor_vlb        rotor sized for 2-hop Valiant load balancing

A solver is any callable ``(Problem, SolveOptions) -> SolveReport``;
``Pipeline`` instances qualify. Register your own with ``register_solver``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np

from ..core.baselines import baseline_less as _baseline_less
from ..core.baselines import rotor_schedule
from ..core.improved import spectra_pp as _spectra_pp
from ..core.schedule import ParallelSchedule, SwitchSchedule
from .pipeline import Pipeline
from .problem import Problem, SolveOptions, SolveReport, finish_report
from .torch_backend import solve_spectra_torch

SolverFn = Callable[[Problem, SolveOptions], SolveReport]

_SOLVERS: dict[str, SolverFn] = {}


def register_solver(name: str, fn: SolverFn | None = None, *, overwrite: bool = False):
    """Register a solver under ``name``; usable as a decorator."""

    def _register(f: SolverFn) -> SolverFn:
        if name in _SOLVERS and not overwrite:
            raise ValueError(f"solver {name!r} already registered")
        _SOLVERS[name] = f
        return f

    return _register if fn is None else _register(fn)


def get_solver(name: str) -> SolverFn:
    if name not in _SOLVERS:
        raise KeyError(f"unknown solver {name!r}; available: {list_solvers()}")
    return _SOLVERS[name]


def list_solvers() -> list[str]:
    return sorted(_SOLVERS)


def solve(
    problem: Problem,
    *,
    solver: str = "spectra_torch",
    options: SolveOptions | None = None,
) -> SolveReport:
    """Run one registered solver on one problem."""
    report = get_solver(solver)(problem, options or SolveOptions())
    report.solver = solver
    return report


def _pipeline_solver(name: str, pipeline: Pipeline) -> None:
    register_solver(name, lambda problem, options, _p=pipeline: _p(problem, options))


register_solver("spectra_torch", solve_spectra_torch)
_pipeline_solver("spectra", Pipeline())
_pipeline_solver("spectra_no_eq", Pipeline(equalize="none"))
_pipeline_solver("spectra_eclipse", Pipeline(decompose="eclipse"))


@register_solver("spectra_pp")
def _solve_spectra_pp(problem: Problem, options: SolveOptions) -> SolveReport:
    # Validation/LB go through finish_report so SolveOptions (validate_tol,
    # compute_lb) behave exactly as on every other solver.
    res = _spectra_pp(
        problem.D, problem.s, problem.delta, validate=False, compute_lb=False
    )
    return finish_report(
        solver="spectra_pp",
        backend="numpy",
        schedule=res.schedule,
        problem=problem,
        options=options,
        runtime_s=res.runtime_s,
        decomposition=res.decomposition,
    )


@register_solver("baseline_less")
def _solve_baseline_less(problem: Problem, options: SolveOptions) -> SolveReport:
    D = np.asarray(problem.D, dtype=np.float64)
    t0 = time.perf_counter()
    sched = _baseline_less(D, problem.s, problem.delta)
    runtime = time.perf_counter() - t0
    return finish_report(
        solver="baseline_less",
        backend="numpy",
        schedule=sched,
        problem=problem,
        options=options,
        runtime_s=runtime,
    )


# ---------------------------------------------------------------------------
# Demand-oblivious rotor baselines (RotorNet/Opus lineage): fixed round-robin
# permutation sequences, no matching solves. The counterpoint SPECTRA is
# measured against at the flow level (the reference's ``repro.flowsim``).
# ---------------------------------------------------------------------------

def _rotor_common(problem: Problem) -> tuple[np.ndarray, float, float, bool]:
    D = np.asarray(problem.D, dtype=np.float64)
    peak = float(D.max(initial=0.0))
    diag_max = float(np.diag(D).max(initial=0.0)) if D.size else 0.0
    return D, peak, diag_max, diag_max > 0


@register_solver("rotor")
def _solve_rotor(problem: Problem, options: SolveOptions) -> SolveReport:
    """Pure rotor: uniform slots sized so *direct* service covers D.

    Demand-obliviousness is structural — the permutation sequence is the
    fixed round-robin cycle — but a covering schedule needs one scalar of
    demand knowledge: the slot length, sized to the worst matrix entry
    (``slot · cycles = max D``). That scalar is exactly why rotors price
    skewed traffic so badly: every port pair pays for the heaviest one.
    ``options.extra["rotor_cycles"]`` (default 1) trades slot granularity
    for extra δ rounds.
    """
    D, peak, _, has_diag = _rotor_common(problem)
    cycles = int(options.extra.get("rotor_cycles", 1))
    t0 = time.perf_counter()
    if peak <= 0:  # nothing to serve: no circuits, no reconfigurations
        sched = ParallelSchedule(
            switches=[SwitchSchedule() for _ in range(problem.s)],
            delta=problem.delta,
        )
        slot = 0.0
    else:
        slot = peak / cycles
        sched = rotor_schedule(
            problem.n, problem.s, problem.delta, slot,
            cycles=cycles, include_identity=has_diag,
        )
    runtime = time.perf_counter() - t0
    return finish_report(
        solver="rotor",
        backend="numpy",
        schedule=sched,
        problem=problem,
        options=options,
        runtime_s=runtime,
        extras={"rotor": {"slot": slot, "cycles": cycles}},
    )


@register_solver("rotor_vlb")
def _solve_rotor_vlb(problem: Problem, options: SolveOptions) -> SolveReport:
    """Rotor + 2-hop VLB: slots sized for *indirected* traffic, not peaks.

    Valiant load balancing uniformizes any admissible matrix: per rotor
    cycle, the fluid load on every port pair is at most
    ``S = (max row sum + max col sum) / (n − 1)`` — a function of line
    sums, not of the worst entry — so the slots are sized to ``S`` (over
    ``rotor_cycles``, default 2) plus ``rotor_safety_cycles`` (default 3)
    extra cycles for store-and-forward latency: hop-1 bytes parked at an
    intermediate can only leave on a *later* window. (The fluid bound is
    exact only in the limit; at paper scale the last straggler bytes can
    land a window after two safety cycles end, hence three.)

    The returned schedule does NOT cover D in the matrix sense (Eq. 3) —
    by design: direct slots are far smaller than skewed entries. Coverage
    validation is skipped (``validated=False``) and correctness is
    instead the flow-level conservation check of the reference's
    ``repro.flowsim.simulate_flows`` (not ported yet; it auto-enables VLB
    via ``extras["indirection"]``): every byte must be delivered. The
    warning text is the reference's, word for word.
    """
    D, peak, diag_max, has_diag = _rotor_common(problem)
    base_cycles = int(options.extra.get("rotor_cycles", 2))
    safety = int(options.extra.get("rotor_safety_cycles", 3))
    cycles = base_cycles + safety
    t0 = time.perf_counter()
    if peak <= 0:
        sched = ParallelSchedule(
            switches=[SwitchSchedule() for _ in range(problem.s)],
            delta=problem.delta,
        )
        slot = 0.0
    else:
        n = problem.n
        fluid = (
            float(D.sum(axis=1).max()) + float(D.sum(axis=0).max())
        ) / max(n - 1, 1)
        # Diagonal demand can't be indirected — only the identity shift
        # serves it, so direct slots must cover it over all cycles.
        slot = max(fluid / base_cycles, diag_max / cycles)
        sched = rotor_schedule(
            n, problem.s, problem.delta, slot,
            cycles=cycles, include_identity=has_diag,
        )
    runtime = time.perf_counter() - t0
    report = finish_report(
        solver="rotor_vlb",
        backend="numpy",
        schedule=sched,
        problem=problem,
        options=options if not options.validate
        else dataclasses.replace(options, validate=False),
        runtime_s=runtime,
        extras={
            "indirection": "vlb",
            "rotor": {"slot": slot, "cycles": cycles,
                      "base_cycles": base_cycles, "safety_cycles": safety},
            "warnings": [
                "schedule covers demand only under 2-hop VLB indirection; "
                "validate with repro.flowsim conservation, not Eq. 3"
            ],
        },
    )
    return report


def solve_all(
    problem: Problem,
    *,
    solvers: Iterable[str] | None = None,
    options: SolveOptions | None = None,
) -> dict[str, SolveReport]:
    """Run several solvers on the same problem (benchmark convenience)."""
    return {
        name: solve(problem, solver=name, options=options)
        for name in (solvers or list_solvers())
    }
