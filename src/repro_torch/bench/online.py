"""Online against stateless scheduling over whole traces (the twin of
``benchmarks/fig_online.py``).

For each trace (gpt, moe, benchmark) and length T ∈ {8, 32}, the stateless
per-period solve and the stateful online controller run over the same
trace, with the host backend (``spectra``: the host ``OnlineController``)
and the device backend (``spectra_torch``: the scan,
``run_scenario(..., online=True)``): total makespans, δ paid and avoided,
reuse. One CSV row a (scenario, T, backend); the derived column has the
online/stateless ratio of the total makespans.

Both backends always run; a device failure raises.

Usage::

    python -m repro_torch.bench.online [--fast] [--device cpu]

Writes ``build/repro_torch/fig_online.csv`` and prints one
``name,us_per_call,derived`` line a row. ``--fast`` runs n = 8 and
T ∈ {3, 6}. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ..scenarios import run_scenario
from .common import OUT_DIR, fast_options, write_csv

SCENARIOS = ("gpt", "moe", "benchmark")
PERIODS, FAST_PERIODS = (8, 32), (3, 6)
BACKENDS = ("spectra", "spectra_torch")


def online_row(name: str, T: int, solver: str, device=None, **overrides) -> tuple[dict, dict]:
    """(CSV row, printed row) of one online run."""
    t0 = time.perf_counter()
    rep = run_scenario(name, solver=solver, online=True, periods=T, options=fast_options(device), **overrides)
    dt = time.perf_counter() - t0
    s = rep.online_summary()
    ratio = (s["online_total_makespan"] / s["stateless_total_makespan"] if s["stateless_total_makespan"]
             else float("nan"))
    data = {
        "scenario": name,
        "T": T,
        "solver": solver,
        "online_backend": s["online_solver"],
        "stateless_total_makespan": s["stateless_total_makespan"],
        "online_total_makespan": s["online_total_makespan"],
        "ratio": ratio,
        "delta_paid": s["total_delta_paid"],
        "delta_avoided": s["total_delta_avoided"],
        "reuse": s["total_reuse"],
        "runtime_s": dt,
    }
    row = {
        "name": f"fig_online_{name}_T{T}_{solver}",
        "us_per_call": f"{1e6 * dt / max(T, 1):.0f}",
        "derived": f"ratio={ratio:.4f};reuse={s['total_reuse']};d_avoided={s['total_delta_avoided']:.3f}",
    }
    return data, row


def run(fast: bool = False, device=None, out_dir: Path = OUT_DIR) -> tuple[list[dict], list[dict]]:
    """(CSV rows, printed rows) over every scenario, T and backend; the CSV
    is written once all are in."""
    overrides = {"n": 8} if fast else {}
    data, rows = [], []
    for name in SCENARIOS:
        for T in FAST_PERIODS if fast else PERIODS:
            for solver in BACKENDS:
                d, r = online_row(name, T, solver, device, **overrides)
                data.append(d)
                rows.append(r)
    write_csv(Path(out_dir) / "fig_online.csv", data)
    return data, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="n = 8, T in {3, 6}")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..kernels.backend import resolve_device

    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    for r in run(fast=args.fast, device=dev)[1]:
        print(f"{r['name']},{r['us_per_call']},{r['derived']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
