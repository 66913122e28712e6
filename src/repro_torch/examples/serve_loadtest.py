"""Serving control-plane load test (the twin of
``examples/serve_loadtest.py``): open-loop Poisson traffic against the
always-on ``ScheduleServer`` on ``spectra_torch``, with double-buffered
dispatch, the two-tier schedule cache, admission control, and the SLO
metrics an operator would alarm on; then the same profile at 3× the rate
through admission, where over-rate tenants degrade (no EQUALIZE) and a full
queue sheds::

    python -m repro_torch.examples.serve_loadtest [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Returns the open loop's metrics and the overload's counts."""
    from ..api import dispatch_many_torch
    from ..kernels.backend import resolve_device
    from ..serve.admission import AdmissionController
    from ..serve.cache import ScheduleCache
    from ..serve.loadgen import make_workload, run_open_loop, tiny_profile
    from ..serve.server import ScheduleServer
    from ..bench.common import fast_options

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    opts = fast_options(dev)

    def new_server(**kw):
        return ScheduleServer(s=4, delta=0.01, mode="async", solver="spectra_torch", options=opts,
                              cache=ScheduleCache(capacity=64), max_batch=4, **kw)

    # Two tenants: a phase-cycling MoE job (cache-friendly) and an ad-hoc
    # tenant with fresh structure every period (cache-hostile).
    workload = make_workload(tiny_profile(n=8, rate=50.0), duration=0.8, seed=0)
    print(f"workload: {len(workload)} arrivals over 0.8s ({len({a.tenant for a in workload})} tenants)")

    # One call at every batch shape the server can dispatch (the batch size
    # follows the open-loop arrivals), for both tiers, so the measured run
    # starts warm: on the card the first call also builds the kernels.
    degraded = fast_options(dev, equalize=False)
    proto = [a.D for a in workload[:4]]
    for B in range(1, 5):
        for o in (opts, degraded):
            dispatch_many_torch(np.stack(proto[:B]), 4, 0.01, o).collect()

    # Open-loop replay: submit by the arrival clock, pumping the server's
    # double-buffered loop in between.
    metrics = run_open_loop(new_server(), workload)
    print(f"\nserved {metrics['schedules']} schedules ({metrics['schedules_per_sec']:.0f}/s sustained)")
    print(f"cache: {metrics['cache_hit_exact']} exact + {metrics['cache_hit_support']} support hits, "
          f"{metrics['cache_miss']} misses → hit rate {metrics['cache_hit_rate']:.2f}")
    for stage in ("queue_wait", "device", "e2e"):
        h = metrics["stages"][stage]
        print(f"  {stage:>10}: p50 {h['p50_s'] * 1e3:7.2f}ms   p99 {h['p99_s'] * 1e3:7.2f}ms")

    overload = make_workload(tiny_profile(n=8, rate=150.0), duration=0.5, seed=1)
    srv = new_server(admission=AdmissionController(rate=30.0, burst=10.0, max_queue=8))
    for i, a in enumerate(overload):
        srv.submit(a.tenant, a.D, now=a.t)
        if i % 8 == 7:
            srv.step()
    srv.drain()
    m = srv.metrics
    print(f"\noverload ({len(overload)} arrivals at 3x): {m.admitted} admitted, {m.degraded} degraded, {m.shed} shed")
    tier = [r for r in srv.results.values() if r.degraded]
    if tier:
        print(f"  degraded tier served {len(tier)} requests (mean makespan "
              f"{np.mean([r.makespan for r in tier]):.3f}, EQUALIZE skipped)")
    return {"open_loop": metrics, "arrivals": len(workload), "overload": len(overload), "admitted": m.admitted,
            "degraded": m.degraded, "shed": m.shed, "served": len(srv.results), "degraded_served": len(tier)}


if __name__ == "__main__":
    main()
