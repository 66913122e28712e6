"""Terminal dashboard: ``python -m repro_torch.obs.dashboard <scenario>``.

The port's counterpart of ``repro.obs.dashboard``. Runs one registered
scenario, time-expands every period, checks the attribution identity, and
renders the per-switch occupancy strips plus the LB-gap breakdown in the
terminal. ``--device`` follows the port's device rule for the device
solvers (``spectra_torch``): unset means CUDA, which raises without a GPU;
``--device cpu`` runs the plain PyTorch path. ``--html`` additionally
writes the Gantt report; ``--trace`` records the run through the span
tracer and writes Chrome trace-event JSON (open it at
https://ui.perfetto.dev).
"""

from __future__ import annotations

import argparse

from .html import save_html
from .timeline_table import attribute_scenario
from .trace import get_tracer


def _fmt(v: float) -> str:
    return f"{v:.4f}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dashboard",
        description="Per-switch timeline + makespan attribution for a scenario.",
    )
    ap.add_argument("scenario", help="registered scenario name (e.g. gpt, moe)")
    ap.add_argument("--solver", default="spectra", help="registry solver name")
    ap.add_argument("--n", type=int, default=None, help="override port count")
    ap.add_argument(
        "--periods", type=int, default=None, help="override trace length"
    )
    ap.add_argument(
        "--online", action="store_true",
        help="also run the stateful online pass (reuse credit timelines)",
    )
    ap.add_argument(
        "--width", type=int, default=72, help="timeline strip width (chars)"
    )
    ap.add_argument(
        "--max-periods", type=int, default=3,
        help="render at most this many period strips (attribution covers all)",
    )
    ap.add_argument(
        "--device", default=None,
        help="device of the device solvers (default: CUDA; 'cpu' runs the "
        "plain PyTorch path)",
    )
    ap.add_argument("--html", metavar="PATH", help="write the HTML Gantt report")
    ap.add_argument(
        "--trace", metavar="PATH",
        help="record a span trace and write Chrome trace-event JSON",
    )
    args = ap.parse_args(argv)

    tracer = get_tracer()
    if args.trace:
        tracer.enable()

    from ..api import SolveOptions
    from ..scenarios import run_scenario  # defer: registry import is heavy

    overrides = {}
    if args.n is not None:
        overrides["n"] = args.n
    if args.periods is not None:
        overrides["periods"] = args.periods
    report = run_scenario(
        args.scenario, solver=args.solver, online=args.online,
        options=SolveOptions(extra={"device": args.device}), **overrides
    )
    att = attribute_scenario(report)
    att.check()

    agg = att.summary()
    print(f"{att.scenario} · {att.solver} — {agg['periods']} periods")
    print(
        f"  switch-time shares: serve {agg['transmission_share']:.1%}  "
        f"δ {agg['delta_share']:.1%}  idle {agg['idle_share']:.1%}  "
        f"(util mean {agg['util_mean']:.1%}, min {agg['util_min']:.1%})"
    )
    print(
        f"  LB gap {_fmt(agg['total_lb_gap'])} = "
        f"imbalance {_fmt(agg['gap_from_transmission'])} "
        f"+ δ {_fmt(agg['gap_from_delta'])} "
        f"+ idle {_fmt(agg['gap_from_idle'])}"
    )
    for label, tables in (("period", att.tables), ("online", att.online_tables)):
        for t, table in enumerate(tables[: args.max_periods]):
            a = table.attribution
            print(
                f"\n{label} {t}: makespan {_fmt(a.makespan)}  "
                f"LB {_fmt(a.lower_bound)}  "
                f"δ paid {_fmt(a.delta_paid)}"
                + (f"  reuse {a.reuse_count}" if a.reuse_count else "")
            )
            print(table.render_ascii(args.width))
        hidden = len(tables) - args.max_periods
        if hidden > 0:
            print(f"\n({hidden} more {label} strips hidden; --max-periods)")
    if att.online_tables:
        online = {
            k.removeprefix("online_"): v
            for k, v in agg.items()
            if k.startswith("online_")
        }
        print(
            f"\nonline pass: reuse {online['reuse_count']}  "
            f"δ avoided {_fmt(online['delta_avoided'])}  "
            f"δ paid {_fmt(online['delta_paid'])}"
        )

    if args.html:
        path = save_html(att, args.html)
        print(f"\nwrote HTML report: {path}")
    if args.trace:
        path = tracer.save(args.trace)
        spans = len(tracer.spans())
        print(f"wrote Chrome trace ({spans} spans): {path}")
        print("  open at https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
