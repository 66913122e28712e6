"""TrafficSpec / DemandTrace — declarative scenario inputs, materialized
traces; a copy of ``repro.scenarios.spec``.

A ``TrafficSpec`` describes *time-varying* traffic the way the paper's
controller sees it: a workload family re-sampled every controller period,
``T`` periods long, over ``n`` ports feeding ``s`` parallel switches with
reconfiguration delay δ. A ``DemandTrace`` is the materialized result — a
dense ``(T, n, n)`` stack plus per-period metadata — which is exactly the
shape ``repro_torch.api.solve_many`` consumes in one batched call.

Units policy (``TrafficSpec.units``):

* ``"demand"`` — matrices are already in normalized demand-time units
  (one unit of demand takes one unit of time on one switch link) and
  ``delta`` is in those units. This is the paper's evaluation setting.
* ``"bytes"`` — matrices are raw byte counts (e.g. collective traffic) and
  ``delta`` is the physical reconfiguration delay in *seconds*.
  ``DemandTrace.normalized`` converts the whole trace with one global
  scale (peak entry across all periods), so δ-in-units is constant over
  the trace and the batched solver sees one uniform problem family —
  per-period CCT seconds are then ``makespan · unit_s``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterator, Mapping

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..fabric.ocs import OCSFabric

_UNITS = ("demand", "bytes")


@dataclass(frozen=True)
class TrafficSpec:
    """Declarative spec of one scenario: family, sizes, δ, units, T, seed.

    ``params["delta_schedule"]`` makes δ itself time-varying: the sequence
    is cycled per period by ``Scenario.trace`` (resolved values land in
    ``period_meta[t]["delta"]`` / ``DemandTrace.deltas``), overriding the
    scalar ``delta`` field; pass ``delta_schedule=None`` to pin the scalar
    back. Byte-denominated traces reject a varying δ (the fabric's physical
    reconfiguration delay is one number).
    """

    family: str                 # generator family in scenarios.registry
    n: int                      # ports (racks)
    s: int                      # parallel switches
    delta: float                # reconfig delay: demand units, or seconds for units="bytes"
    periods: int = 1            # T controller periods
    seed: int = 0               # base seed; period t draws from seed + t
    units: str = "demand"       # "demand" | "bytes"
    link_bandwidth_Bps: float | None = None  # bytes traces; None → OCSFabric default
    params: Mapping[str, Any] = field(default_factory=dict)  # family kwargs
    # Flow-level replay knobs (flowsim.FlowSimOptions kwargs:
    # buffer_limit, indirection, line_rate, tol) — the defaults
    # run_scenario(..., flowsim=True) builds its FlowSimOptions from
    # unless an explicit flowsim_options argument overrides them.
    flowsim_params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError(f"need at least two ports, got n={self.n}")
        if self.s < 1:
            raise ValueError(f"need at least one switch, got s={self.s}")
        if self.delta < 0:
            raise ValueError(f"delta must be nonnegative, got {self.delta}")
        if self.periods < 1:
            raise ValueError(f"need at least one period, got T={self.periods}")
        if self.units not in _UNITS:
            raise ValueError(f"units must be one of {_UNITS}, got {self.units!r}")
        object.__setattr__(self, "params", dict(self.params))
        object.__setattr__(self, "flowsim_params", dict(self.flowsim_params))

    def replace(self, **overrides: Any) -> "TrafficSpec":
        """New spec with overrides; unknown keys merge into ``params``.

        Top-level field names (``n``, ``periods``, ``seed``, …) replace the
        field; anything else is a family knob and merges into the existing
        ``params`` (``params=`` itself also *merges*, it does not wipe the
        dict — explicit scalar knobs take precedence over a registered
        ``<knob>_schedule``, see ``library._knob``). So
        ``spec.replace(n=8, periods=3, noise=0.01)`` is the tiny variant
        idiom used by the smoke tests.
        """
        names = {f.name for f in dataclasses.fields(self)}
        top = {k: v for k, v in overrides.items() if k in names and k != "params"}
        extra = {k: v for k, v in overrides.items() if k not in names}
        params = {**self.params, **extra, **dict(overrides.get("params", {}))}
        return dataclasses.replace(self, params=params, **top)


@dataclass
class DemandTrace:
    """A materialized scenario: (T, n, n) demand stack + per-period metadata."""

    spec: TrafficSpec
    demands: np.ndarray           # (T, n, n) float64, nonnegative
    period_meta: list[dict]       # one dict per period (knob values, seeds)

    def __post_init__(self) -> None:
        self.demands = np.asarray(self.demands, dtype=np.float64)
        if self.demands.ndim != 3 or self.demands.shape[1] != self.demands.shape[2]:
            raise ValueError(
                f"demands must be (T, n, n), got shape {self.demands.shape}"
            )
        if len(self.period_meta) != self.demands.shape[0]:
            raise ValueError("need exactly one metadata dict per period")

    @property
    def T(self) -> int:
        return int(self.demands.shape[0])

    @property
    def n(self) -> int:
        return int(self.demands.shape[1])

    @property
    def deltas(self) -> np.ndarray:
        """Per-period reconfiguration delay, shape (T,).

        Constant ``spec.delta`` unless the scenario registered a
        ``delta_schedule`` (cycled per period by ``Scenario.trace``, which
        records the resolved value in ``period_meta[t]["delta"]``).
        """
        return np.array(
            [m.get("delta", self.spec.delta) for m in self.period_meta],
            dtype=np.float64,
        )

    @property
    def varying_delta(self) -> bool:
        """True when a ``delta_schedule`` makes δ differ across periods."""
        d = self.deltas
        return bool(len(d)) and bool((d != d[0]).any())

    def __len__(self) -> int:
        return self.T

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.demands)

    def fabric(self) -> "OCSFabric":
        """The OCSFabric this byte trace is denominated against."""
        from ..fabric.ocs import OCSFabric

        kw = {}
        if self.spec.link_bandwidth_Bps is not None:
            kw["link_bandwidth_Bps"] = self.spec.link_bandwidth_Bps
        return OCSFabric(
            num_switches=self.spec.s, reconfig_delay_s=self.spec.delta, **kw
        )

    def normalized(self) -> tuple[np.ndarray, float, float | np.ndarray]:
        """Whole-trace bytes→units conversion: (units stack, unit_s, δ_units).

        Delegates the scale math to ``OCSFabric.normalize`` over the entire
        ``(T, n, n)`` stack — one global scale (the peak entry across *all*
        periods) so a single δ-in-units holds for the whole trace and
        ``solve_many`` can treat it as one uniform batch. All-zero traces
        inherit the fabric's contract: ``unit_s = 0.0``, ``δ_units = 0.0``
        (nothing to serve, no reconfigurations needed).

        A ``delta_schedule`` (trace-aware δ sweep) returns δ_units as the
        per-period (T,) vector instead of a scalar — nothing downstream may
        silently collapse it. Byte traces reject per-period δ with a clear
        error: the fabric's physical reconfiguration delay is one number,
        and pretending otherwise would silently mis-price every period.
        """
        if self.spec.units != "bytes":
            if self.varying_delta:
                return self.demands, float("nan"), self.deltas
            return self.demands, float("nan"), self.spec.delta
        if self.varying_delta:
            raise ValueError(
                "per-period delta_schedule is not supported for "
                "byte-denominated traces: δ is the fabric's physical "
                "reconfiguration delay (one value); drop the schedule or "
                "use units='demand'"
            )
        fabric = self.fabric()
        units, unit_s = fabric.normalize(self.demands)
        return units, unit_s, fabric.delta_units(unit_s)
