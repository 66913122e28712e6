"""Scenario mode of the port's benchmark runner (the twin of
``python -m benchmarks.run --scenario``): named ``repro_torch.scenarios``
entries end to end through ``run_scenario``.

    python -m repro_torch.bench.scenarios --scenario gpt moe [--solver spectra_torch] [--periods T]
        [--fast] [--online] [--flowsim] [--obs] [--device cpu]

``all`` runs every registered scenario. ``--solver`` picks the registry
solver (default ``spectra``); ``--periods`` overrides the trace length;
``--fast`` shrinks each scenario to n = 8, T = 3. The gates, each counted
as a failure:

- ``--online`` also runs the stateful controller over each trace: no online
  period may come out worse than its stateless baseline;
- ``--flowsim`` replays each trace at the flow level for ``--solver`` and
  the ``rotor_vlb`` baseline: every period must deliver every byte;
- ``--obs`` traces the whole run and checks, on every scenario, the
  makespan-attribution identity (transmission + δ paid + idle ≡
  s·makespan), per-switch utilization in [0, 1] and the lower-bound gap;
  then writes the Chrome trace to
  ``build/repro_torch/TRACE_scenarios.json``, re-parses it and checks its
  span names.

Prints one ``name,us_per_call,derived`` line a (scenario, solver) and, with
``--obs``, its ``obs_*`` line and ``obs_trace``; exits 1 on any failure. A
device failure raises. Runs the device solvers on CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .common import OUT_DIR


def run_scenarios(names: list[str], solver: str, periods: int | None, fast: bool, *, online: bool = False,
                  flowsim: bool = False, obs: bool = False, device=None, out_dir: Path = OUT_DIR) -> int:
    """Run every (scenario, solver) pair and print its rows; returns the
    number of failures."""
    from ..api import SolveOptions
    from ..obs import get_tracer
    from ..scenarios import list_scenarios

    if names == ["all"]:
        names = list_scenarios()
    # Flowsim mode compares the solver with the oblivious rotor+VLB baseline.
    solvers = [solver]
    if flowsim and "rotor_vlb" not in solvers:
        solvers.append("rotor_vlb")
    overrides: dict = {"options": SolveOptions(extra={"device": device})}
    if fast:
        overrides.update(n=8, periods=3)
    if periods is not None:
        overrides["periods"] = periods
    tracer = get_tracer()
    if obs:
        tracer.reset()
        tracer.enable()
    print("name,us_per_call,derived")
    failures = 0
    try:
        for name in names:
            for sv in solvers:
                failures += run_one_scenario(name, sv, overrides, online=online, flowsim=flowsim, obs=obs)
        if obs:
            failures += check_trace(solver, Path(out_dir) / "TRACE_scenarios.json")
    finally:
        if obs:
            tracer.disable()
            tracer.reset()
    return failures


def check_obs(rep, name: str, solver: str) -> int:
    """The attribution gate of one report; prints its row; returns the
    number of failures: the identity on every period of both passes
    (``attribute_scenario`` raises), utilization in [0, 1], and the
    lower-bound gap at least its floor, all within the backend's tolerance."""
    from ..obs import attribute_scenario

    try:
        att = attribute_scenario(rep)
        att.check()
    except (AssertionError, ValueError) as exc:
        print(f"obs_{name}_{solver},nan,ERROR:{type(exc).__name__}:{exc}")
        return 1
    failures = 0
    agg = att.summary()
    for t, table in enumerate(att.tables + att.online_tables):
        a = table.attribution
        utils = table.utilization
        if len(utils) and (utils.min() < -att.tol or utils.max() > 1 + att.tol):
            print(f"obs_{name}_{solver},nan,ERROR:period {t} utilization outside [0,1]: "
                  f"[{utils.min():.6f}, {utils.max():.6f}]")
            failures += 1
        # A stateless makespan cannot beat the §IV bound; an online one can,
        # by at most the δ a switch's reuse avoided (the bound charges δ for
        # every configuration, reused or not).
        floor = -(a.delta_avoided / a.s + att.tol * max(1.0, a.makespan))
        gap = a.lb_gap
        if gap == gap and gap < floor:
            print(f"obs_{name}_{solver},nan,ERROR:period {t} makespan beats the lower bound: "
                  f"gap {gap:.6g} < floor {floor:.6g}")
            failures += 1
    derived = (f"residual={agg['max_identity_residual']:.3g};tx={agg['transmission_share']:.3f};"
               f"d={agg['delta_share']:.3f};idle={agg['idle_share']:.3f};util_min={agg['util_min']:.3f}")
    if att.online_tables:
        derived += (f";online_reuse={agg['online_reuse_count']}"
                    f";online_d_avoided={agg['online_delta_avoided']:.4f}")
    if not failures:
        print(f"obs_{name}_{solver},0,{derived}")
    return failures


def check_trace(solver: str, path: Path) -> int:
    """Export and re-parse the Chrome trace; gate on the expected span names."""
    from ..obs import get_tracer

    tracer = get_tracer()
    path = tracer.save(path)
    try:
        doc = json.loads(path.read_text())
        events = doc["traceEvents"]
        assert isinstance(events, list) and events, "no trace events"
        for e in events:
            assert e["ph"] in ("X", "i", "C"), f"bad phase {e['ph']!r}"
            assert e["ts"] >= 0, f"negative timestamp in {e['name']!r}"
            if e["ph"] == "X":
                assert e["dur"] >= 0, f"negative duration in {e['name']!r}"
    except (AssertionError, KeyError, ValueError) as exc:
        print(f"obs_trace,nan,ERROR:{type(exc).__name__}:{exc}")
        return 1
    names = {s.name for s in tracer.spans()}
    want = {"solve_many", "install"}
    if solver == "spectra":  # the host pipeline's stages must appear
        want |= {"decompose", "schedule", "equalize", "matcher"}
    missing = want - names
    if missing:
        print(f"obs_trace,nan,ERROR:missing spans {sorted(missing)}")
        return 1
    print(f"obs_trace,0,events={len(events)};spans={len(tracer.spans())};path={path}")
    return 0


def run_one_scenario(name: str, solver: str, overrides: dict, *, online: bool, flowsim: bool,
                     obs: bool = False) -> int:
    """Run one (scenario, solver) pair; print its row; return the number of
    failures."""
    from ..scenarios import run_scenario

    rep = run_scenario(name, solver=solver, online=online, flowsim=flowsim, **overrides)
    failures = check_obs(rep, name, solver) if obs else 0
    s = rep.summary()
    derived = (f"T={s['periods']};n={s['n']};mean_mk={s['mean_makespan']:.4f};"
               f"gap={s['geomean_gap']:.3f};buckets={s['buckets']}")
    if rep.spec.units == "bytes":
        derived += f";cct_s={s['total_cct_s']:.4g}"
    if flowsim:
        fs = rep.flowsim_summary()
        derived += (f";fct_p50={fs['fct_p50']:.4f};fct_p99={fs['fct_p99']:.4f};"
                    f"indirect={fs['indirect_frac']:.3f};conserved={fs['conserved']}")
        if not fs["conserved"]:  # every byte of every period's demand is delivered
            derived += f";VIOLATION_residual={fs['residual']:.3g}"
            failures += 1
    if online:
        o = rep.online_summary()
        derived += (f";online_mk={o['online_total_makespan']:.4f};"
                    f"stateless_mk={o['stateless_total_makespan']:.4f};"
                    f"reuse={o['total_reuse']};d_avoided={o['total_delta_avoided']:.4f}")
        # No online period may come out worse than its stateless baseline.
        bad = [p.period for p in rep.online_periods if p.makespan > p.stateless_makespan * (1 + 1e-6) + 1e-9]
        if bad:
            derived += f";VIOLATION_periods={bad}"
            failures += 1
    print(f"scenario_{name}_{solver},{1e6 * s['runtime_s'] / max(s['periods'], 1):.0f},{derived}")
    sys.stdout.flush()
    return failures


def main(argv=None, out_dir: Path = OUT_DIR) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", nargs="+", metavar="NAME", required=True,
                    help="repro_torch.scenarios names, or 'all'")
    ap.add_argument("--solver", default="spectra", help="registry solver (default: spectra)")
    ap.add_argument("--periods", type=int, default=None, help="override the trace length T")
    ap.add_argument("--fast", action="store_true", help="tiny variants (n = 8, T = 3)")
    ap.add_argument("--online", action="store_true",
                    help="run the stateful controller too; fail if an online period is worse than its stateless one")
    ap.add_argument("--flowsim", action="store_true",
                    help="flow-level replay of --solver and rotor_vlb; fail if a period loses bytes")
    ap.add_argument("--obs", action="store_true",
                    help="trace the run, check the attribution identity, utilization and LB gap, and the "
                         "re-parsed Chrome trace")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..kernels.backend import resolve_device

    dev = resolve_device(args.device)
    failures = run_scenarios(args.scenario, args.solver, args.periods, args.fast, online=args.online,
                             flowsim=args.flowsim, obs=args.obs, device=dev, out_dir=out_dir)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
