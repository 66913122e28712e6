"""Optical-circuit-switch fabric model (Fig. 1 topology), a copy of
``repro.fabric.ocs``.

``n`` racks, each ToR connected to every one of ``s`` parallel OCSes; a
central controller periodically schedules the rack-level demand matrix D
onto the switches. Demand is normalized so one unit of demand takes one unit
of time on one switch link.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..api.problem import SolveReport
from ..core.spectra import SpectraResult


@dataclass(frozen=True)
class OCSFabric:
    """A datacenter core of s parallel optical circuit switches."""

    num_switches: int  # s
    reconfig_delay_s: float  # δ, in seconds
    link_bandwidth_Bps: float = 400e9 / 8  # 400 Gb/s optical ports

    def normalize(self, demand_bytes: np.ndarray) -> tuple[np.ndarray, float]:
        """Demand in bytes → time units; returns (D, seconds-per-unit).

        All-zero demand has no peak to scale by: the contract is
        ``unit_s = 0.0`` with D returned as-is (all zeros), and every
        downstream consumer treats ``unit_s == 0.0`` as "nothing to serve".
        """
        demand_bytes = np.asarray(demand_bytes, dtype=np.float64)
        peak = float(demand_bytes.max(initial=0.0))
        if peak <= 0:
            return np.zeros_like(demand_bytes), 0.0
        unit_s = peak / self.link_bandwidth_Bps
        return demand_bytes / peak, unit_s

    def delta_units(self, unit_s: float) -> float:
        """δ expressed in normalized demand-time units."""
        if unit_s <= 0:
            return 0.0
        return self.reconfig_delay_s / unit_s

    def schedule_bytes(
        self,
        demand_bytes: np.ndarray,
        scheduler: str | Callable[..., SpectraResult] = "spectra",
        **kw,
    ) -> tuple[SolveReport | SpectraResult, float]:
        """Schedule a byte-demand matrix; returns (result, CCT seconds).

        ``scheduler`` is a registry solver name (preferred) or a legacy
        callable ``(D, s, delta, **kw) -> SpectraResult``-like. On the
        registry path, pass ``options=SolveOptions(...)``, or the legacy
        kwargs ``validate`` / ``compute_lb`` / ``validate_tol``, which are
        mapped onto SolveOptions (anything else lands in ``extra``); both
        at once raise ``TypeError``.

        All-zero demand gives an empty schedule at δ = 0 and a CCT of
        exactly 0.0 seconds.
        """
        D, unit_s = self.normalize(demand_bytes)
        delta = self.delta_units(unit_s) if unit_s > 0.0 else 0.0
        if callable(scheduler):
            res = scheduler(D, self.num_switches, delta, **kw)
        else:
            from ..api import Problem, SolveOptions, solve

            options = kw.pop("options", None)
            if options is None:
                options = SolveOptions(
                    validate=kw.pop("validate", True),
                    compute_lb=kw.pop("compute_lb", True),
                    validate_tol=kw.pop("validate_tol", None),
                    extra=kw,
                )
            elif kw:
                raise TypeError(
                    f"pass either options= or legacy kwargs, not both: {sorted(kw)}"
                )
            res = solve(Problem(D, self.num_switches, delta), solver=scheduler, options=options)
        return res, (res.makespan * unit_s if unit_s > 0.0 else 0.0)
