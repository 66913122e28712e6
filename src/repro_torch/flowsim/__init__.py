"""Flow-level fabric simulation: FCT/CCT distributions over scheduled circuits
(the port's counterpart of ``repro.flowsim``, host numpy code).

    from repro_torch.flowsim import simulate_flows, FlowSimOptions

    rep = solve(Problem(D, s=4, delta=0.01), solver="spectra")
    fs = simulate_flows(rep, D)
    print(fs.fct_stats.p99, fs.cct, fs.conserved)

The measurement tier above ``fabric.simulator``: instead of checking
matrix coverage and a single finish time, the discrete-event engine in
``events`` replays per-(src, dst) *flows* through the scheduled circuit
windows — NIC virtual-output queues, finite indirect buffers, optional
2-hop Valiant load balancing — and reports the flow-completion-time
distribution (p50/p90/p99/mean/max), coordinated completion time,
per-switch utilization, δ overhead, and bytes conservation.

Circuit timing comes from ``fabric.timeline`` — the same source of
truth the matrix-level simulator asserts against — so the two tiers can
never disagree about when a circuit is up. Demand-oblivious baselines
(``rotor``, ``rotor_vlb`` in the solver registry) and SPECTRA schedules
all flow through the same ``FlowSimReport``; ``run_scenario(...,
flowsim=True)`` attaches one per controller period.
"""

from .buffers import FabricBuffers
from .events import simulate_flows
from .flows import Flow, FlowTable, flows_from_demand
from .indirection import vlb_injections
from .report import FlowSimOptions, FlowSimReport, FlowStats

__all__ = [
    "FabricBuffers", "Flow", "FlowSimOptions", "FlowSimReport", "FlowStats",
    "FlowTable", "flows_from_demand", "simulate_flows", "vlb_injections",
]
