"""Batched serving demo (the twin of ``examples/serve_decode.py``): KV-cache
decode across architecture families on reduced configs, then the OCS
``SolverService`` draining one controller period's scheduling requests
through the solver API::

    python -m repro_torch.examples.serve_decode [--new-tokens 48] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

ARCHS = ("granite-3-8b", "mamba2-2.7b", "zamba2-1.2b")


def main(argv=None) -> dict:
    """Returns {arch: generated tokens} and the service's reports."""
    from ..configs.registry import get_arch
    from ..kernels.backend import resolve_device
    from ..models.registry import build_model
    from ..serve.engine import DecodeEngine, SolverService
    from ..traffic.workloads import moe_workload

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        model = build_model(cfg, device=dev)
        eng = DecodeEngine(model, max_len=96)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        eng.generate(prompts, 2)  # warm-up
        t0 = time.perf_counter()
        res = eng.generate(prompts, args.new_tokens)
        dt = time.perf_counter() - t0
        n = 4 * args.new_tokens
        print(f"{arch:>16} (reduced): {n} tokens in {dt:.2f}s → {n / dt:6.1f} tok/s | sample: "
              f"{res.tokens[0, 16:24].tolist()}")
        out[arch] = np.asarray(res.tokens)

    # While tokens stream out, the fabric controller serves scheduling
    # requests: one demand matrix a pod a period, drained in batches.
    svc = SolverService(s=4, delta=0.01, solver="spectra")
    tickets = [svc.submit(moe_workload(rng=np.random.default_rng(seed)) / 64) for seed in range(3)]
    reports = svc.flush()
    print("\nSolverService (one controller period, 3 pods):")
    for t in tickets:
        r = reports[t]
        print(f"  pod {t}: makespan {r.makespan:.4f}  gap {r.optimality_gap:.3f}x "
              f"({r.num_configs} circuits, {r.solver}/{r.backend})")
    return {"tokens": out, "reports": [reports[t] for t in tickets]}


if __name__ == "__main__":
    main()
