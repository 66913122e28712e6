"""Serving-plane SLO benchmark of the port (the twin of
``benchmarks/bench_serve.py``): double buffering, cache, admission.

Three experiments against ``repro_torch.serve`` on ``spectra_torch``:

1. **speedup**: one request stream served by the synchronous and the
   async double-buffered loop, with the OCS install latency set to the
   measured device solve time of a batch (at least 10 ms); the ideal is
   (solve + install) / max(solve, install), the gate ≥ 1.2×.
2. **cache**: an open-loop Poisson profile through the async server with
   the two-tier schedule cache; gates the hit rate (phase-cycling tiny
   profile), sustained schedules/s and end-to-end p99.
3. **overload**: a 2× overload burst through the admission controller;
   gates that requests are shed, the queue stays bounded and every ticket
   is accounted for.

Usage::

    python -m repro_torch.bench.serve [--fast] [--check] [--device cpu]

Writes ``build/repro_torch/BENCH_serve_torch.json``. ``--fast`` runs the
tiny cache profile only; ``--check`` exits 1 on a gate failure. Runs on
CUDA unless ``--device cpu`` is given; no wall-clock gate means anything on
the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .common import fast_options, write_artifact

# The reference's gates (benchmarks/bench_serve.py).
SPEEDUP_GATE = 1.2       # async vs sync drain
CACHE_HIT_GATE = 0.70    # on the phase-cycling (tiny) profile
THROUGHPUT_FLOOR = 10.0  # schedules/s, warm, tiny profile
P99_CEILING = 2.0        # end-to-end seconds, warm, tiny profile
INSTALL_FLOOR_S = 0.01   # the install latency is at least this


def _perm_demand(n: int, rng: np.random.Generator, k: int = 4) -> np.ndarray:
    """Rotations of one random permutation: dense enough to be non-trivial."""
    sigma = rng.permutation(n)
    D = np.zeros((n, n))
    for j in range(k):
        D[np.arange(n), np.roll(sigma, j)] += rng.uniform(1.0, 4.0, size=n)
    return D


def bench_speedup(n: int = 16, B: int = 4, batches: int = 6, device=None) -> dict:
    """Sync vs async drain on one stream, install ≈ a batch's solve time."""
    from ..api import dispatch_many_torch
    from ..serve.server import ScheduleServer

    opts = fast_options(device)
    rng = np.random.default_rng(0)
    mats = [_perm_demand(n, rng) for _ in range(B * batches)]

    # A warm call at the serving shape (the first builds the kernels), then
    # the steady solve time of a batch calibrates the install latency.
    dispatch_many_torch(np.stack(mats[:B]), 4, 0.01, opts).collect()
    t0 = time.perf_counter()
    dispatch_many_torch(np.stack(mats[:B]), 4, 0.01, opts).collect()
    solve_s = time.perf_counter() - t0
    install = max(solve_s, INSTALL_FLOOR_S)

    def drain(mode: str) -> float:
        srv = ScheduleServer(4, 0.01, mode=mode, solver="spectra_torch", options=opts,
                             install_latency_s=install, max_batch=B)
        for i, D in enumerate(mats):
            srv.submit(f"t{i % 2}", D)
        t0 = time.perf_counter()
        srv.drain()
        dt = time.perf_counter() - t0
        assert len(srv.results) == len(mats)
        return dt

    sync_s = drain("sync")
    async_s = drain("async")
    return {
        "experiment": "speedup",
        "n": n,
        "batch": B,
        "batches": batches,
        "solve_ms": 1e3 * solve_s,
        "install_ms": 1e3 * install,
        "ideal_speedup": (solve_s + install) / max(solve_s, install),
        "sync_s": sync_s,
        "async_s": async_s,
        "speedup": sync_s / async_s,
    }


def bench_cache(profile: str, duration: float, rate: float, device=None) -> dict:
    """An open-loop profile through the cache-enabled async server, burst
    submitted. Two identical passes; the first warms up, the second is
    measured."""
    from ..serve.cache import ScheduleCache
    from ..serve.loadgen import make_workload, mixed_profile, submit_all, tiny_profile
    from ..serve.server import ScheduleServer

    tenants = tiny_profile(n=8, rate=rate) if profile == "tiny" else mixed_profile(rate=rate)
    wl = make_workload(tenants, duration=duration, seed=3)
    opts = fast_options(device)

    def run_pass():
        srv = ScheduleServer(4, 0.01, mode="async", solver="spectra_torch", options=opts,
                             cache=ScheduleCache(capacity=64), max_batch=4)
        submit_all(srv, wl)
        srv.drain()
        return srv

    run_pass()
    srv = run_pass()
    m = srv.metrics.export()
    assert m["schedules"] == len(wl)
    by_source = {"device": 0, "cache": 0}
    for r in srv.results.values():
        by_source["cache" if r.source.startswith("cache") else "device"] += 1
    return {
        "experiment": "cache",
        "profile": profile,
        "requests": len(wl),
        "duration_s": duration,
        "cache_hit_rate": m["cache_hit_rate"],
        "schedules_per_sec": m["schedules_per_sec"],
        "p50_e2e_s": m["stages"]["e2e"]["p50_s"],
        "p99_e2e_s": m["stages"]["e2e"]["p99_s"],
        "served_from": by_source,
        "metrics": m,
    }


def bench_overload(rate: float = 120.0, duration: float = 0.5, device=None) -> dict:
    """A 2× overload burst: shed verdicts must appear, the queue stays bounded."""
    from ..serve.admission import AdmissionController
    from ..serve.loadgen import make_workload, tiny_profile
    from ..serve.server import ScheduleServer

    max_queue = 8
    wl = make_workload(tiny_profile(n=8, rate=rate), duration=duration, seed=5)
    srv = ScheduleServer(4, 0.01, mode="async", solver="spectra_torch", options=fast_options(device),
                         admission=AdmissionController(rate=rate / 4, burst=10, max_queue=max_queue), max_batch=4)
    max_depth = 0
    for i, a in enumerate(wl):
        srv.submit(a.tenant, a.D, now=a.t)
        max_depth = max(max_depth, len(srv))
        if i % 12 == 11:  # the server drains ~3× slower than the burst offers
            srv.step()
    srv.drain()
    m = srv.metrics.export()
    return {
        "experiment": "overload",
        "requests": len(wl),
        "max_queue": max_queue,
        "max_depth": max_depth,
        "shed": m["shed"],
        "admitted": m["admitted"],
        "degraded": m["degraded"],
        "completed": len(srv.results),
        "accounted": len(srv.results) + len(srv.shed_tickets),
    }


def run(fast: bool, device=None) -> list[dict]:
    rows = []
    row = bench_speedup(device=device)
    print(f"speedup    async {row['speedup']:.2f}x vs sync, ideal {row['ideal_speedup']:.2f}x "
          f"(solve {row['solve_ms']:.1f}ms, install {row['install_ms']:.1f}ms)", flush=True)
    rows.append(row)

    profiles = [("tiny", 0.6, 60.0)]
    if not fast:
        profiles.append(("mixed", 0.8, 40.0))
    for profile, duration, rate in profiles:
        row = bench_cache(profile, duration, rate, device=device)
        print(f"cache      {profile:6s} hit={row['cache_hit_rate']:.2f} "
              f"{row['schedules_per_sec']:.0f} sched/s p99={row['p99_e2e_s'] * 1e3:.0f}ms "
              f"({row['requests']} reqs)", flush=True)
        rows.append(row)

    row = bench_overload(device=device)
    print(f"overload   shed={row['shed']}/{row['requests']} max_depth={row['max_depth']} "
          f"(bound {row['max_queue']}) accounted={row['accounted']}", flush=True)
    rows.append(row)
    return rows


def check(rows: list[dict]) -> list[str]:
    """The SLO gates; the same messages as the reference's."""
    failures = []
    for r in rows:
        if r["experiment"] == "speedup" and r["speedup"] < SPEEDUP_GATE:
            failures.append(f"double-buffering speedup {r['speedup']:.2f}x < {SPEEDUP_GATE}x "
                            f"(solve {r['solve_ms']:.1f}ms)")
        if r["experiment"] == "cache" and r["profile"] == "tiny":
            if r["cache_hit_rate"] < CACHE_HIT_GATE:
                failures.append(f"cache hit rate {r['cache_hit_rate']:.2f} < {CACHE_HIT_GATE} on phase-cycling profile")
            if r["schedules_per_sec"] < THROUGHPUT_FLOOR:
                failures.append(f"throughput {r['schedules_per_sec']:.1f} sched/s < {THROUGHPUT_FLOOR} floor")
            if r["p99_e2e_s"] > P99_CEILING:
                failures.append(f"e2e p99 {r['p99_e2e_s']:.2f}s > {P99_CEILING}s ceiling")
        if r["experiment"] == "overload":
            if r["shed"] == 0:
                failures.append("overload burst shed nothing")
            if r["max_depth"] > r["max_queue"]:
                failures.append(f"queue depth {r['max_depth']} exceeded bound {r['max_queue']}")
            if r["accounted"] != r["requests"]:
                failures.append(f"{r['accounted']} tickets accounted != {r['requests']} submitted")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="tiny profile only")
    ap.add_argument("--check", action="store_true", help="exit 1 on SLO gate failures")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..kernels.backend import resolve_device

    dev = resolve_device(args.device)
    rows = run(fast=args.fast, device=dev)
    out = write_artifact("serve_torch", {"rows": rows, "device": str(dev)}, workload="serve-control-plane")
    print(f"wrote {out}")
    if args.check:
        failures = check(rows)
        for f in failures:
            print(f"GATE FAIL: {f}", file=sys.stderr)
        return 1 if failures else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
