"""§V-A runtime table of the port (the twin of ``benchmarks/runtime_table.py``):
SPECTRA's runtime a workload.

For each workload: the host ``spectra`` solve's mean and p95 over ``reps``
matrices, then the batched device column, one
``solve_many(..., solver="spectra_torch")`` over the B matrices of
``make_trace(scenario, periods=B, seed=1000)`` timed after a warm-up call
(which also builds the kernels on first use) and amortised a matrix, and
the device-vs-host quality (the geomean of the per-matrix makespan ratios
against host ``spectra`` on the same matrices).

A device failure raises: no row is written with a NaN in its place.

Usage::

    python -m repro_torch.bench.runtime [--fast] [--device cpu]

Writes ``build/repro_torch/runtime.csv`` and prints one
``name,us_per_call,derived`` line a workload. ``--fast`` runs 3 reps, B = 4
and no n = 512 row. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..api import Problem, solve, solve_many
from ..scenarios import make_trace
from .common import OUT_DIR, fast_options, scenario_matrices, write_csv

# (row name, scenario, s, large): the large rows run LARGE_REPS × LARGE_BATCH.
WORKLOADS = (
    ("gpt_s4", "gpt", 4, False),
    ("moe_s4", "moe", 4, False),
    ("benchmark_s4", "benchmark", 4, False),
    ("benchmark_large_s4", "benchmark_large", 4, True),
    ("permutations_large_s4", "permutations_large", 4, True),
)
DELTA = 0.01
REPS, BATCH, FAST_REPS, FAST_BATCH = 10, 16, 3, 4
LARGE_REPS = LARGE_BATCH = 2
DEVICE_SEED = 1000


def device_matrices(scenario: str, B: int) -> np.ndarray:
    """The (B, n, n) stack the device column solves."""
    return make_trace(scenario, periods=B, seed=DEVICE_SEED).demands


def batched_device(scenario: str, s: int, delta: float, B: int, device=None) -> tuple[float, float]:
    """(ms a matrix, geomean device/host makespan) of one batched device
    call over B matrices: the first call warms up, the second is timed."""
    opts = fast_options(device)
    Ds = device_matrices(scenario, B)
    reports = solve_many(Ds, s, delta, solver="spectra_torch", options=opts)
    ratios = [rep.makespan / solve(Problem(D, s, delta), solver="spectra", options=opts).makespan
              for D, rep in zip(Ds, reports)]
    quality = float(np.exp(np.mean(np.log(ratios))))
    t0 = time.perf_counter()
    solve_many(Ds, s, delta, solver="spectra_torch", options=opts)
    return 1e3 * (time.perf_counter() - t0) / B, quality


def runtime_row(wname: str, scenario: str, s: int, reps: int, batch: int, device=None) -> dict:
    """One CSV row: host mean / p95 ms, device ms a matrix and quality."""
    opts = fast_options(device)
    times = []
    for D in scenario_matrices(scenario, reps):
        t0 = time.perf_counter()
        solve(Problem(D, s, DELTA), solver="spectra", options=opts)
        times.append(time.perf_counter() - t0)
    dev_ms, quality = batched_device(scenario, s, DELTA, batch, device)
    return {
        "workload": wname,
        "mean_ms": 1e3 * float(np.mean(times)),
        "p95_ms": 1e3 * float(np.percentile(times, 95)),
        "batched_device_ms_per_instance": dev_ms,
        "device_quality_vs_host": quality,
        "batch_size": batch,
    }


def run(fast: bool = False, device=None, workloads=WORKLOADS,
        out_dir: Path = OUT_DIR) -> tuple[list[dict], list[dict]]:
    """(CSV rows, printed ``name,us_per_call,derived`` rows); the CSV,
    ``out_dir / "runtime.csv"``, is written once all are in."""
    reps, batch = (FAST_REPS, FAST_BATCH) if fast else (REPS, BATCH)
    rows, out = [], []
    for wname, scenario, s, large in workloads:
        if fast and scenario == "permutations_large":  # --fast keeps n ≤ 256
            continue
        row = runtime_row(wname, scenario, s, LARGE_REPS if large else reps, LARGE_BATCH if large else batch,
                          device)
        rows.append(row)
        out.append({
            "name": f"runtime_{wname}",
            "us_per_call": f"{1e3 * row['mean_ms']:.0f}",
            "derived": (f"p95_ms={row['p95_ms']:.1f} batched_device_ms/inst="
                        f"{row['batched_device_ms_per_instance']:.2f} (B={row['batch_size']}) "
                        f"quality_vs_host={row['device_quality_vs_host']:.3f}"),
        })
    write_csv(Path(out_dir) / "runtime.csv", rows)
    return rows, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="3 reps, B = 4, no n = 512 row")
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
