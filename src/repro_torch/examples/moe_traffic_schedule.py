"""MoE expert-routing traffic → SPECTRA, two ways (the twin of
``examples/moe_traffic_schedule.py``).

1. *Measured*: three train steps of a reduced DeepSeek-style MoE read the
   router's per-expert token counts (``expert_load``, part of the step's
   metrics), which become the expert-to-expert demand matrix
   (``train.loop._demand_from_stats``) that ``spectra`` schedules. The
   reference asks for its chunked attention; the port has one attention
   path, so these steps run the ``flash_attention`` kernel.
2. *Paper-scale*: the synthetic 64×64 Qwen-like matrix of the scenario
   registry over δ, as in Fig. 6(b), then a whole trace of 8 controller
   periods.

    python -m repro_torch.examples.moe_traffic_schedule [--steps 3] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Returns the measured loads, the measured rows and the trace report."""
    from ..api import Problem, solve
    from ..configs.registry import get_arch
    from ..data.pipeline import make_stream
    from ..kernels.backend import resolve_device
    from ..models.registry import build_model
    from ..parallel.steps import make_train_step
    from ..scenarios import make_trace, run_scenario
    from ..train.loop import _demand_from_stats
    from ..train.optimizer import AdamW, cosine_schedule

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== measured routing from a live (reduced) MoE model ===")
    cfg = get_arch("deepseek-moe-16b").reduced()
    model = build_model(cfg, device=dev)
    opt = AdamW(schedule=cosine_schedule(1e-3, 10))
    stream = make_stream(cfg.vocab_size, 64, 8, device=dev)
    step = make_train_step(model, opt)
    params = model.init(0)
    opt_state = opt.init(params)
    for i in range(args.steps):
        params, opt_state, metrics = step(params, opt_state, stream.next_batch(i))
    load = metrics["expert_load"].cpu().numpy()
    print(f"expert token loads (E={len(load)}): {load.astype(int).tolist()}")
    D = _demand_from_stats(num_racks=8, metrics={"expert_load": load}, step=0)
    D = D / D.max()
    measured = []
    for s, delta in [(2, 0.01), (4, 0.01), (4, 0.05)]:
        p = Problem(D, s, delta)
        res = solve(p, solver="spectra")
        bl = solve(p, solver="baseline_less")
        measured.append((s, delta, res.makespan, bl.makespan))
        print(f"  s={s} δ={delta}: SPECTRA {res.makespan:.4f} (LB {res.lower_bound:.4f}, gap "
              f"{res.optimality_gap:.3f}x) BASELINE {bl.makespan:.4f} → {bl.makespan / res.makespan:.2f}x longer")

    print("\n=== paper-scale 64×64 Qwen-MoE-like matrix (Fig. 6b setting) ===")
    D = make_trace("moe", periods=1).demands[0]
    for s in (2, 4):
        for delta in (1e-3, 1e-2, 1e-1):
            p = Problem(D, s, delta)
            res = solve(p, solver="spectra")
            bl = solve(p, solver="baseline_less")
            print(f"  s={s} δ={delta:g}: SPECTRA {res.makespan:.4f} LB {res.lower_bound:.4f} BASELINE "
                  f"{bl.makespan:.4f} ({bl.makespan / res.makespan:.2f}x)")
    print("\nSPECTRA hugs the lower bound on dense MoE traffic, the paper's Fig. 6(b) observation.")

    print("\n=== a whole training run: 8 controller periods of router drift ===")
    rep = run_scenario("moe", solver="spectra")
    print(f"periods={rep.trace.T}  mean makespan={rep.makespans.mean():.4f}  geomean gap={rep.geomean_gap:.3f}x  "
          f"buckets={rep.num_shape_buckets}")
    return {"load": load, "measured": measured, "trace": rep}


if __name__ == "__main__":
    main()
