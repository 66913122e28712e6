"""String-addressable scenario registry (mirrors ``api.registry``), a copy
of ``repro.scenarios.registry``.

Two levels:

* a **family** is a generator ``(spec, t, rng) -> (n, n) demand [, meta]``
  producing period ``t`` of a trace — registered with ``register_family``;
* a **scenario** is a named ``TrafficSpec`` binding a family to concrete
  sizes/knobs — registered with ``register_scenario`` and materialized with
  ``make_trace(name, **overrides)``.

Period ``t`` always draws from ``np.random.default_rng(spec.seed + t)``, so
a trace is deterministic under a fixed seed, periods are independent of
generation order, and — with ``seed=0`` — period ``t`` reproduces exactly
the matrix the figure benchmarks historically drew for ``seed=t``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from .spec import DemandTrace, TrafficSpec

# (spec, period, rng) -> (n, n) ndarray, or (ndarray, per-period-meta dict)
FamilyFn = Callable[..., Any]

_FAMILIES: dict[str, FamilyFn] = {}
_SCENARIOS: dict[str, "Scenario"] = {}


def register_family(name: str, fn: FamilyFn | None = None, *, overwrite: bool = False):
    """Register a traffic family generator under ``name``; usable as a decorator."""

    def _register(f: FamilyFn) -> FamilyFn:
        if name in _FAMILIES and not overwrite:
            raise ValueError(f"traffic family {name!r} already registered")
        _FAMILIES[name] = f
        return f

    return _register if fn is None else _register(fn)


def get_family(name: str) -> FamilyFn:
    if name not in _FAMILIES:
        raise KeyError(f"unknown traffic family {name!r}; available: {list_families()}")
    return _FAMILIES[name]


def list_families() -> list[str]:
    return sorted(_FAMILIES)


@dataclass(frozen=True)
class Scenario:
    """A named, declarative scenario: spec + description; materializes traces."""

    name: str
    spec: TrafficSpec
    description: str = ""

    def trace(self, **overrides: Any) -> DemandTrace:
        """Materialize the (T, n, n) demand trace, deterministically.

        Overrides go through ``TrafficSpec.replace`` — spec fields replace,
        anything else merges into the family params — so tiny variants are
        ``scenario.trace(n=8, periods=3)``.
        """
        spec = self.spec.replace(**overrides) if overrides else self.spec
        fn = get_family(spec.family)
        # δ is a spec field, not a family knob, so a delta_schedule would be
        # silently ignored by the generators — resolve it here instead
        # (cycled per period, recorded in period_meta, pinnable by passing
        # delta_schedule=None).
        delta_schedule = spec.params.get("delta_schedule")
        if delta_schedule is not None:
            if not len(delta_schedule):
                raise ValueError("delta_schedule must not be empty")
            if any(d < 0 for d in delta_schedule):
                raise ValueError(
                    f"delta_schedule entries must be nonnegative, got "
                    f"{tuple(delta_schedule)}"
                )
        demands = np.zeros((spec.periods, spec.n, spec.n), dtype=np.float64)
        metas: list[dict] = []
        for t in range(spec.periods):
            rng = np.random.default_rng(spec.seed + t)
            out = fn(spec, t, rng)
            D, meta = out if isinstance(out, tuple) else (out, {})
            D = np.asarray(D, dtype=np.float64)
            if D.shape != (spec.n, spec.n):
                raise ValueError(
                    f"family {spec.family!r} produced shape {D.shape} for period "
                    f"{t}, expected {(spec.n, spec.n)}"
                )
            demands[t] = D
            metas.append({"period": t, "seed": spec.seed + t, **meta})
            if delta_schedule is not None:
                metas[-1]["delta"] = float(
                    delta_schedule[t % len(delta_schedule)]
                )
        return DemandTrace(spec=spec, demands=demands, period_meta=metas)


def register_scenario(
    name: str,
    spec: TrafficSpec,
    *,
    description: str = "",
    overwrite: bool = False,
) -> Scenario:
    """Register ``spec`` as the named scenario and return it."""
    if name in _SCENARIOS and not overwrite:
        raise ValueError(f"scenario {name!r} already registered")
    sc = Scenario(name=name, spec=spec, description=description)
    _SCENARIOS[name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in _SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; available: {list_scenarios()}")
    return _SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


def make_trace(scenario: str | Scenario, **overrides: Any) -> DemandTrace:
    """Materialize a registered scenario (or Scenario object) into a trace."""
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    return sc.trace(**overrides)
