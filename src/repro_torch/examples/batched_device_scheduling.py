"""On-device SPECTRA: a stack of demand matrices in one batched call (the
twin of ``examples/batched_device_scheduling.py``).

Four controller periods of the standard benchmark, shrunk to 32 ports,
go through ``solve_many(..., solver="spectra_torch")``: one fused device
call for DECOMPOSE, SCHEDULE and EQUALIZE, with the host schedules built
lazily. Each is checked against the exact host ``spectra`` through the
same API, printing the device/host quality a matrix. The matcher and the
repair sweeps come from the command line::

    python -m repro_torch.examples.batched_device_scheduling               # auction
    python -m repro_torch.examples.batched_device_scheduling auction_fr    # forward-reverse
    python -m repro_torch.examples.batched_device_scheduling auction 2     # + 2 repair sweeps

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

S, DELTA = 4, 0.01


def main(argv=None) -> dict:
    """Returns the device/host quality ratios, the worst of them and the device reports."""
    from ..api import Problem, SolveOptions, solve, solve_many
    from ..core.torchopt.matching import list_matchers
    from ..kernels.backend import resolve_device
    from ..scenarios import make_trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matcher", nargs="?", default="auction", help=f"one of {list_matchers()}")
    ap.add_argument("repair_rounds", nargs="?", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.matcher not in list_matchers():
        raise SystemExit(f"unknown matcher {args.matcher!r}; available: {list_matchers()}")
    dev = resolve_device(args.device)

    mats = make_trace("benchmark", n=32, m=8, num_big=4, periods=4).demands
    print(f"batched solve_many on the port's device path (matcher={args.matcher!r}, "
          f"repair_rounds={args.repair_rounds}, {dev}): one fused batched call "
          "(decompose + schedule + equalize), lazy host schedules:\n")
    opts = SolveOptions(extra={"matcher": args.matcher, "repair_rounds": args.repair_rounds, "device": dev})
    t0 = time.perf_counter()
    reports = solve_many(mats, S, DELTA, solver="spectra_torch", options=opts)
    dt = time.perf_counter() - t0
    ratios = []
    for i, rep in enumerate(reports):
        ref = solve(Problem(mats[i], S, DELTA), solver="spectra")
        ratio = rep.makespan / ref.makespan
        ratios.append(ratio)
        print(f"matrix {i}: k={rep.extras['k']} device-LPT={rep.extras['device_lpt_makespan']:.4f} "
              f"equalized={rep.makespan:.4f} | exact-host={ref.makespan:.4f} LB={ref.lower_bound:.4f} "
              f"quality={ratio:.4f}x")
        if rep.extras["warnings"]:
            print(f"  !! {'; '.join(rep.extras['warnings'])}")
    worst = max(ratios)
    print(f"\nbatch of {len(reports)} solved in {dt * 1e3:.0f} ms total; worst device/host quality ratio "
          f"{worst:.4f}x (matcher={args.matcher!r}).")
    return {"ratios": ratios, "worst": worst, "reports": reports}


if __name__ == "__main__":
    main()
