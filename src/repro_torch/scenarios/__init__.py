"""Scenario & trace API: one registry from workload to scheduled report
(the port's counterpart of ``repro.scenarios``).

    from repro_torch.scenarios import make_trace, run_scenario, list_scenarios

    trace = make_trace("gpt", periods=8)            # (8, 32, 32) demand stack
    report = run_scenario("moe", solver="spectra_torch", online=True)
    print(report.online_summary())

A ``Scenario`` is a declarative ``TrafficSpec`` (workload family, n, s, δ,
bytes→units policy, T periods, seed) registered under a string name —
mirroring the solver registry in ``repro_torch.api`` — that materializes a
``DemandTrace``: the time-varying traffic the paper's controller reschedules
every period. ``run_scenario`` pushes the whole trace through the batched
``solve_many`` (one fused device call per shape bucket on
``spectra_torch``, CUDA unless ``SolveOptions(extra={"device": "cpu"})``)
and returns per-period makespans, lower-bound gaps, CCT
seconds for byte traces, and aggregate stats.

Built-in scenarios live in ``library`` (imported here so registration is a
side effect of importing the package); add your own with
``register_family`` / ``register_scenario``.
"""

from .registry import (
    Scenario,
    get_family,
    get_scenario,
    list_families,
    list_scenarios,
    make_trace,
    register_family,
    register_scenario,
)
from .runner import (
    OnlinePeriod,
    OnlineReport,
    PeriodResult,
    ScenarioReport,
    run_scenario,
)
from .spec import DemandTrace, TrafficSpec

from . import library  # noqa: E402,F401  (registers the built-in scenarios)

__all__ = [
    "DemandTrace", "OnlinePeriod", "OnlineReport", "PeriodResult", "Scenario",
    "ScenarioReport", "TrafficSpec",
    "get_family", "get_scenario", "list_families", "list_scenarios",
    "make_trace", "register_family", "register_scenario", "run_scenario",
]
