"""Matcher microbenchmark: ms a dispatch + quality per n × matcher (the twin
of ``benchmarks/bench_matching.py``).

The workload is the DECOMPOSE inner-loop regime, a sum of 16 permutations
with the node-coverage M-bonus folded into the weights, so the timings are
what DECOMPOSE pays a matching round. Quality is the optimality ratio
``scipy_optimal / matched_weight`` (1.0 = exact). A dispatch is timed on
the host's clock up to a device sync.

Usage::

    python -m repro_torch.bench.matching [--fast] [--check] [--reps N] [--device cpu]

Writes ``build/repro_torch/BENCH_matching_torch.json`` and prints one JSON
line. ``--fast`` caps n at 256; ``--check`` exits 1 when a matcher's quality
ratio exceeds 1.10 or ``auction_fused`` fails to beat ``auction`` by ≥ 1.5×
a dispatch at n ≥ 256. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .common import OUT_DIR, write_artifact

SIZES = (100, 256, 512, 1024)
FAST_SIZES = (100, 256)
QUALITY_GATE = 1.10
SPEEDUP_GATE = 1.5
OUT = OUT_DIR / "BENCH_matching_torch.json"


def bench_weights(n: int, k: int = 16, seed: int = 0) -> np.ndarray:
    """Sum-of-k-permutations demand + DECOMPOSE M-bonus weights."""
    rng = np.random.default_rng(seed)
    D = np.zeros((n, n))
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + 0.05
    S = D > 0
    rd, cd = S.sum(1), S.sum(0)
    kk = max(rd.max(), cd.max())
    M = np.maximum(D, 0).max(axis=1).sum() + 1.0
    bonus = M * ((rd == kk)[:, None].astype(float) + (cd == kk)[None, :])
    return (np.maximum(D, 0) + np.where(S, bonus, 0)).astype(np.float32)


def _matchers_for(n: int) -> list[str]:
    if n <= 256:
        return ["auction", "auction_fr", "auction_fused"]
    return ["auction", "auction_fused"]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(sizes, reps: int, device=None, only: tuple[str, ...] | None = None) -> list[dict]:
    """One row per (n, matcher): ms a dispatch (mean of ``reps`` at n ≤ 256,
    one above, after a first call), quality, convergence. ``only`` keeps
    those matchers of each n."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from ..core.torchopt.matching import get_matcher
    from ..kernels.backend import resolve_device

    dev = resolve_device(device)
    rows = []
    for n in sizes:
        W = bench_weights(n)
        ri, ci = linear_sum_assignment(W, maximize=True)
        opt = float(W[ri, ci].sum())
        r = max(1, reps if n <= 256 else 1)
        for name in _matchers_for(n):
            if only is not None and name not in only:
                continue
            fn = get_matcher(name)
            Wd = torch.from_numpy(W).to(dev)[None]
            t0 = time.perf_counter()
            res = fn(Wd)
            _sync(dev)
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(r):
                t0 = time.perf_counter()
                res = fn(Wd)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            perm = res.perm[0].cpu().numpy()
            got = float(W[np.arange(n), perm].sum())
            row = {
                "n": n,
                "matcher": name,
                "ms_per_dispatch": 1e3 * float(np.mean(times)),
                "first_call_s": first_s,
                "quality_ratio": opt / got,
                "converged": bool(res.converged[0]),
                "rounds": int(res.rounds[0]),
                "reps": r,
            }
            rows.append(row)
            print(f"n={n:5d} {name:14s} {row['ms_per_dispatch']:10.1f} ms  quality={row['quality_ratio']:.6f}"
                  f"  converged={row['converged']}  rounds={row['rounds']}", flush=True)
    return rows


# The pieces of an auction_fused dispatch that fused_split times: name -> function of core.torchopt.matching.
SPLIT = {"eps": "_eps_schedule", "kernel": "fused_auction", "polish": "polish_2swap"}


def fused_split(n: int, reps: int = 5) -> dict:
    """One ``auction_fused`` dispatch on ``bench_weights(n)`` split by CUDA
    events on the card's timeline (median of ``reps`` dispatches, ms):
    ``eps`` (the ε schedule: wmax read to the host, the schedule formed
    there and copied back), ``kernel`` (the ``fused_auction`` call),
    ``polish`` (the ``polish_2swap`` call) and ``rest``, the dispatch's
    other time up to the end of its last operation; ``total`` is their sum
    and ``wall`` the host's clock around the call and a sync. Each piece
    includes the host time the card waits for before it starts."""
    import torch

    from ..core.torchopt import matching

    W = torch.from_numpy(bench_weights(n)).cuda()[None]
    saved = {name: getattr(matching, attr) for name, attr in SPLIT.items()}
    marks: dict[str, tuple] = {}

    def timed(name):
        def call(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved[name](*args, **kw)
            end.record()
            marks[name] = start, end
            return out
        return call

    rows = []
    try:
        for name, attr in SPLIT.items():
            setattr(matching, attr, timed(name))
        matching.match_auction_fused(W)
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            matching.match_auction_fused(W)
            end.record()
            torch.cuda.synchronize()
            row = {name: a.elapsed_time(b) for name, (a, b) in marks.items()}
            row["total"] = start.elapsed_time(end)
            row["rest"] = row["total"] - sum(row[name] for name in SPLIT)
            row["wall"] = 1e3 * (time.perf_counter() - t0)
            rows.append(row)
    finally:
        for name, attr in SPLIT.items():
            setattr(matching, attr, saved[name])
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def check(rows: list[dict]) -> list[str]:
    """Gates: quality ≤ 1.10 everywhere; fused ≥ 1.5× auction at n ≥ 256."""
    failures = []
    by = {(r["n"], r["matcher"]): r for r in rows}
    for r in rows:
        if r["quality_ratio"] > QUALITY_GATE:
            failures.append(f"n={r['n']} {r['matcher']}: quality ratio {r['quality_ratio']:.4f} > {QUALITY_GATE}")
        if not r["converged"]:
            failures.append(f"n={r['n']} {r['matcher']}: did not converge")
    for n in sorted({r["n"] for r in rows}):
        if n < 256:
            continue
        base, fused = by.get((n, "auction")), by.get((n, "auction_fused"))
        if base is None or fused is None:
            continue
        speedup = base["ms_per_dispatch"] / fused["ms_per_dispatch"]
        if speedup < SPEEDUP_GATE:
            failures.append(f"n={n}: auction_fused only {speedup:.2f}x faster than auction (< {SPEEDUP_GATE}x)")
    return failures


def write(rows: list[dict], device: str, path: Path = OUT) -> Path:
    """The artifact, in the envelope of ``benchmarks/artifact.py``."""
    return write_artifact("matching_torch", {"rows": rows, "device": device}, workload="perm16+M-bonus", path=path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="cap n at 256")
    ap.add_argument("--check", action="store_true", help="exit 1 on quality/speedup gate failures")
    ap.add_argument("--reps", type=int, default=3, help="timed reps per point at n <= 256 (default 3)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..kernels.backend import resolve_device

    dev = resolve_device(args.device)
    rows = run(FAST_SIZES if args.fast else SIZES, args.reps, device=dev)
    out = write(rows, str(dev))
    print(f"wrote {out}")
    failures = check(rows) if args.check else []
    for f in failures:
        print(f"GATE FAIL: {f}", file=sys.stderr)
    print(json.dumps({"bench": "matching_torch", "device": str(dev), "rows": rows, "gate_failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
