"""Registry adapters: stateful solving through the uniform solver API, the
counterpart of ``repro.online.solvers``.

``spectra_online`` (host) and ``spectra_online_torch`` (device, the
reference's ``spectra_online_jax``) are registered solvers whose
cross-period state travels through ``SolveOptions.extra``:

    state = None
    for D in trace:
        opts = SolveOptions(extra={"online": state})
        report = solve(Problem(D, s, delta), solver="spectra_online",
                       options=opts)
        state = report.extras["online_state"]

``report.makespan`` is the *effective* (credit-aware) makespan — what the
fabric actually takes to serve the period given the carried configurations —
and ``extras`` carries the reuse accounting (``reuse_count``,
``delta_avoided``, ``delta_paid``, ``stateless_makespan``, ``warm``).

Extra knobs (both solvers): ``warm_start`` (default True), ``merge_aware``,
``equalize``, ``cache_size`` (support-pattern cache capacity: host default
8; device default 0 — the device cache lives in the carried state's shape,
so it must be chosen at session start); device also honors ``device``
(None: CUDA, which raises without a GPU; ``"cpu"``: the plain PyTorch
path), ``extra_slots``, ``matcher`` (autotuned by n when unset),
``repair_rounds``, and ``warm_prices`` (carry the auction's dual prices
across periods).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from ..api.problem import Problem, SolveOptions, SolveReport
from ..api.registry import register_solver
from .controller import OnlineController, OnlinePeriodOutcome
from .state import SwitchState


def _report(
    *,
    solver: str,
    backend: str,
    schedule,
    problem: Problem,
    options: SolveOptions,
    runtime_s: float,
    makespan: float,
    num_configs: int,
    extras: dict[str, Any],
) -> SolveReport:
    """Online-flavored ``finish_report``: the effective makespan is NOT the
    schedule's nominal ``makespan()`` (the credit removes δs the nominal
    formula charges), so validation and reporting are decoupled here."""
    validated = False
    if options.validate:
        schedule.validate(problem.D, tol=options.tol(backend))
        validated = True
    if options.compute_lb:
        from ..core.lower_bounds import lower_bound

        lb = lower_bound(problem.D, problem.s, problem.delta)
    else:
        lb = float("nan")
    return SolveReport(
        solver=solver,
        backend=backend,
        schedule=schedule,
        makespan=float(makespan),
        lower_bound=lb,
        num_configs=int(num_configs),
        runtime_s=runtime_s,
        validated=validated,
        extras=extras,
    )


def _outcome_extras(out: OnlinePeriodOutcome) -> dict[str, Any]:
    return {
        "online": True,
        "reuse_count": out.reuse_count,
        "reused_switches": out.reused_switches,
        "delta_paid": out.delta_paid,
        "delta_avoided": out.delta_avoided,
        "stateless_makespan": out.stateless_makespan,
        "warm": out.warm,
    }


@register_solver("spectra_online")
def solve_spectra_online(problem: Problem, options: SolveOptions) -> SolveReport:
    """Host stateful solver: one controller period per call.

    ``options.extra["online"]`` is the carried ``SwitchState`` (None or
    absent → fresh controller). The §IV ``lower_bound`` stays the stateless
    bound — with enough reuse credit the effective makespan may legitimately
    dip below it (the bound charges δ for every configuration).
    """
    state = options.extra.get("online")
    if state is not None and not isinstance(state, SwitchState):
        raise TypeError(
            f"extra['online'] must be a SwitchState, got {type(state).__name__}"
        )
    ctl = OnlineController(
        s=problem.s,
        delta=problem.delta,
        warm_start=bool(options.extra.get("warm_start", True)),
        warm_slack=float(options.extra.get("warm_slack", 0.05)),
        merge_aware=bool(options.extra.get("merge_aware", False)),
        do_equalize=bool(options.extra.get("equalize", True)),
        cache_size=int(options.extra.get("cache_size", 8)),
    )
    if state is not None:
        ctl.state = state
    t0 = time.perf_counter()
    out = ctl.step(np.asarray(problem.D, dtype=np.float64))
    runtime_s = time.perf_counter() - t0
    extras = _outcome_extras(out)
    extras["online_state"] = ctl.state
    return _report(
        solver="spectra_online",
        backend="numpy",
        schedule=out.schedule,
        problem=problem,
        options=options,
        runtime_s=runtime_s,
        makespan=out.makespan,
        num_configs=out.num_configs,
        extras=extras,
    )


@register_solver("spectra_online_torch")
def solve_spectra_online_torch(
    problem: Problem, options: SolveOptions
) -> SolveReport:
    """Device stateful solver: one ``online_step`` per call, on
    ``options.extra["device"]`` (None: CUDA).

    ``options.extra["online"]`` is the carried ``OnlineDeviceState`` (None
    or absent → fresh, on that device). The schedule materializes lazily in
    reuse serve order; ``extras["online_state"]`` is the new device state to
    thread into the next call.
    """
    import torch

    from ..core.schedule_ir import DeviceSchedule, LazySchedule
    from ..core.torchopt.matching import default_matcher
    from ..core.torchopt.online_torch import (
        OnlineDeviceState,
        online_initial_state,
        online_step,
    )
    from ..kernels.backend import resolve_device
    from .state import online_ir_to_schedule

    state = options.extra.get("online")
    if state is None:
        # The cache capacity is part of the state's *shape*: fixed at
        # session start, carried (and honored) by every subsequent step.
        state = online_initial_state(
            problem.n, problem.s,
            cache_size=int(options.extra.get("cache_size", 0)),
            device=resolve_device(options.extra.get("device")),
        )
    elif not isinstance(state, OnlineDeviceState):
        raise TypeError(
            "extra['online'] must be an OnlineDeviceState, got "
            f"{type(state).__name__}"
        )
    elif tuple(state.installed.shape) != (1, problem.s, problem.n):
        raise ValueError(
            f"carried state is for (s, n)={tuple(state.installed.shape[1:])} but "
            f"the problem is (s, n)=({problem.s}, {problem.n}); start a "
            "fresh session to change fabric size"
        )
    matcher = str(
        options.extra.get("matcher") or default_matcher(problem.n)
    )
    dev = state.installed.device
    t0 = time.perf_counter()
    res, new_state = online_step(
        state,
        torch.as_tensor(np.asarray(problem.D, dtype=np.float32)[None], device=dev),
        problem.s,
        float(np.float32(problem.delta)),
        do_equalize=bool(options.extra.get("equalize", True)),
        merge_aware=bool(options.extra.get("merge_aware", False)),
        extra_slots=int(options.extra.get("extra_slots", 64)),
        matcher=matcher,
        repair_rounds=int(options.extra.get("repair_rounds", 0)),
        warm_start=bool(options.extra.get("warm_start", True)),
        warm_prices=bool(options.extra.get("warm_prices", False)),
        warm_slack=float(options.extra.get("warm_slack", 0.05)),
    )
    ds = DeviceSchedule(*(x[0].cpu().numpy() for x in res.schedule))
    runtime_s = time.perf_counter() - t0

    reused = res.reused[0].cpu().numpy()
    s = problem.s
    lazy = LazySchedule(
        lambda: online_ir_to_schedule(ds, s, reused)[0], float(ds.delta)
    )
    reuse_count = int(res.reuse_count[0])
    delta = float(problem.delta)
    num_configs = int((ds.switch >= 0).sum())
    extras: dict[str, Any] = {
        "online": True,
        "online_state": new_state,
        "reuse_count": reuse_count,
        "reused_slots": reused,
        "delta_paid": delta * (num_configs - reuse_count),
        "delta_avoided": delta * reuse_count,
        "stateless_makespan": float(res.stateless_makespan[0]),
        "warm": bool(res.warm[0]),
        "cache_hit": bool(res.cache_hit[0]),
        "k": int(res.k[0]),
        "converged": bool(res.converged[0]),
        "eq_exhausted": bool(res.eq_exhausted[0]),
        "matcher": matcher,
        "bidding_rounds": int(res.rounds[0]),
        "device": str(dev),
        "device_lb": float(res.lb[0]),
    }
    return _report(
        solver="spectra_online_torch",
        backend="torch",
        schedule=lazy,
        problem=problem,
        options=options,
        runtime_s=runtime_s,
        makespan=float(res.makespan[0]),
        num_configs=num_configs,
        extras=extras,
    )
