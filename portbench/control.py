"""The readings a cell's limits are set from: the sound program's, the
control's and each planted fault's, at the cell's own size.

    python3 portbench/control.py --workload <cell> --data-seeds 1 2 ... 12 \\
        [--sides program control early_stop ...] [--fault-seeds 1 2 3] [--count 64]

A side solves ``count`` matrices of the cell's family and size, drawn from
each data seed in place of the pool's seed (so that the seeds draw
different data), in stacks of the cell's batch through the window's own
call, and reads them with the run's own check. ``program`` is the program
as it stands; ``control`` the reference in its place in bfloat16
(``reference/lowprec.py``); any other side a fault of ``faults.py``
planted in the program. ``program`` reads every data seed, the other sides
the fault seeds. Prints one line a side and seed, each compared number
beside the cell's limit, and one JSON line last. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402
from portbench.reference.lowprec import control_switches  # noqa: E402
from portbench.traffic.generators import closed_loop_matrix  # noqa: E402


def as_report(switches) -> SimpleNamespace:
    """A schedule given as ``(perms, alphas)`` per switch, dressed as a report."""
    sched = SimpleNamespace(switches=[SimpleNamespace(perms=list(p), alphas=list(a)) for p, a in switches])
    return SimpleNamespace(schedule=sched, extras={})


def read_side(cell: harness.Cell, side: str, data_seed: int, count: int) -> dict:
    """The check's numbers for ``count`` matrices of ``data_seed`` solved by ``side``."""
    cfg, B = cell.config, int(cell.traffic["batch"])
    s, delta = int(cfg["s"]), float(cfg["delta"])
    Ds = [closed_loop_matrix(cfg["family"], int(cfg["n"]), cfg["params"], data_seed, i) for i in range(count)]
    run = harness.Run(cell, data_seed, False)
    prog = harness.Program(None)
    with FAULTS[side]() if side in FAULTS else nullcontext():
        for j in range(0, count, B):
            stack = Ds[j: j + B]
            try:
                if side == "control":
                    reps = [as_report(control_switches(D, s, delta)) for D in stack]
                else:
                    reps = prog.solve(stack, s, delta)
            except Exception as exc:  # a raised call is a missing answer for each of its requests
                run.records += [harness.Record(D=D, error=repr(exc)) for D in stack]
                continue
            run.records += [harness.Record(D=D, report=r, switches=harness._switches_of(r)) for D, r in zip(stack, reps)]
    return {k: v["value"] for k, v in harness.check(run).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--data-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, nargs="+")
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    ap.add_argument("--count", type=int, default=64)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    limits = dict(cell.limits, invalid=0, missing=0)
    out: dict[str, dict[int, dict]] = {}
    for side in args.sides:
        if side not in FAULTS and side not in ("program", "control"):
            raise SystemExit(f"control: no side {side!r}")
        seeds = args.data_seeds if side == "program" else (args.fault_seeds or args.data_seeds[:3])
        out[side] = {}
        for seed in seeds:
            t = time.perf_counter()
            out[side][seed] = got = read_side(cell, side, seed, args.count)
            print(f"{cell.name} {side} seed {seed}: " + ", ".join(f"{k} {v!r} (limit {limits[k]!r})"
                                                                  for k, v in got.items())
                  + f"; {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({"workload": cell.name, "count": args.count, "limits": limits, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
