"""Online cross-period scheduling: carry switch state across a trace (the
port's counterpart of ``repro.online``).

The stateless solvers re-pay the reconfiguration delay δ for every
configuration every controller period. This subsystem makes the controller
*stateful*: each OCS's installed permutation is carried between periods, a
round matching it is served first with zero δ (reuse credit), the previous
period's permutation set warm-starts the next decomposition, and — on the
JAX backend — the whole trace rolls through one ``lax.scan`` dispatch.

    from repro_torch.scenarios import run_scenario
    rep = run_scenario("gpt", solver="spectra", online=True)
    print(rep.online_summary())          # reuse, δ avoided, makespan ratio

    from repro_torch.online import OnlineController
    ctl = OnlineController(s=4, delta=0.01)
    for D in demands:                    # stateful host loop
        out = ctl.step(D)

Registry names (usable through ``repro_torch.api.solve`` with the state
threaded via ``SolveOptions.extra["online"]``): ``spectra_online`` (host),
``spectra_online_torch`` (device). The device rolling solve is
``repro_torch.core.torchopt.online_torch.spectra_online_scan``.
"""

from .controller import OnlineController, OnlinePeriodOutcome
from .state import (
    SwitchState,
    advance_installed,
    apply_reuse_order,
    effective_loads,
    effective_makespan,
    online_ir_to_schedule,
    reuse_marks,
)

from . import solvers  # noqa: F401  (registers spectra_online[_torch])

__all__ = [
    "OnlineController",
    "OnlinePeriodOutcome",
    "SwitchState",
    "advance_installed",
    "apply_reuse_order",
    "effective_loads",
    "effective_makespan",
    "online_ir_to_schedule",
    "reuse_marks",
]
