"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` and holds each one
   against its plain PyTorch version on the card (exact equality), then
   times kernel, plain version and, where one exists, a single PyTorch call
   computing the same function.
2. Drives the port's main path, ``repro_torch.api.solve_many(...,
   solver="spectra_torch")``, on four shape buckets (gpt n=32, moe n=64,
   benchmark n=100, permutations n=512), twice each, timing the second run
   with the kernels' launch counters set to 0 just before it. Every report
   must validate (Eq. 3 at 1e-4), converge, respect its §IV lower bound and
   finish EQUALIZE on the device; the gpt bucket must also agree with the
   port's plain CPU path to 1e-4.
3. Prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line. Any failed check exits non-zero.

Without a CUDA device, or without the repository beside it, it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per eager call of ``fn`` in ms (CUDA events over ``reps``
    calls): device time plus whatever host overhead the GPU waits on."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device time per call of ``fn`` in ms: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times, so host launch overhead is out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bonus_weights(D: torch.Tensor) -> torch.Tensor:
    """DECOMPOSE's first-round weights: demand plus the node-coverage M-bonus."""
    n = D.shape[-1]
    S = D > 0
    rd, cd = S.sum(2), S.sum(1)
    k = torch.maximum(rd.amax(1), cd.amax(1))
    M = (D.amax(2).sum(1) + 1.0) * (1.0 + n * 2.0**-19)
    bonus = M[:, None, None] * ((rd == k[:, None])[:, :, None].float() + (cd == k[:, None])[:, None, :].float())
    return (D + torch.where(S, bonus, 0.0)).contiguous()


def phase_bid(rng) -> dict:
    from repro_torch.kernels.auction_bid import masked_row_top2, masked_row_top2_ref

    dev = "cuda"
    max_err = 0.0
    for B, n in [(8, 32), (8, 64), (8, 100), (4, 128)]:
        for kind in ("random", "ties"):
            if kind == "random":
                W = torch.from_numpy(rng.random((B, n, n), dtype=np.float32)).to(dev)
                p = torch.from_numpy(rng.random((B, n), dtype=np.float32)).to(dev)
            else:
                W = torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(dev)
                p = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.float32)).to(dev)
            for name, Wx in (("W", W), ("W.T", W.transpose(1, 2).contiguous())):
                got = masked_row_top2(Wx, p)
                want = masked_row_top2_ref(Wx, p)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"auction_bid {kind} {name} B={B} n={n} differs from its plain version")
                max_err = max(max_err, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    print(f"auction_bid: kernel == plain version exactly at (B, n) in (8,32) (8,64) (8,100) (4,128), random and tie-rich, W and W.T")

    shapes = []
    for B, n in [(8, 32), (8, 64), (8, 100)]:
        W = torch.from_numpy(rng.random((B, n, n), dtype=np.float32)).to(dev)
        p = torch.from_numpy(rng.random((B, n), dtype=np.float32)).to(dev)
        ms = graph_ms(lambda: masked_row_top2(W, p), 100)
        plain_ms = graph_ms(lambda: masked_row_top2_ref(W, p), 100)
        lib_ms = graph_ms(lambda: torch.topk(W - p[:, None, :], 2, dim=-1), 100)
        call_ms = cuda_ms(lambda: masked_row_top2(W, p), 500)
        b_ms, b_by = bound(4.0 * (B * n * n + B * n + 3 * B * n), 2.0 * B * n * n)
        shapes.append(dict(shape=[B, n, n], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by, eager_call_ms=call_ms))
        print(f"auction_bid B={B} n={n}: device per launch: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"topk {lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}); eager call {call_ms * 1e3:.2f} us")
    return dict(max_abs_err=max_err, shapes=shapes)


def phase_fused(rng) -> dict:
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.traffic import permutations_workload

    dev = "cuda"
    max_err = 0.0
    timed = None
    for B, n in [(4, 100), (4, 256), (4, 512), (1, 1024)]:
        D = np.stack([permutations_workload(n=n, k=16, rng=rng) for _ in range(B)])
        W = bonus_weights(torch.from_numpy(D.astype(np.float32)).to(dev))
        eps = _eps_schedule(W, default_num_phases(n)).contiguous()
        p0 = torch.zeros((B, n), device=dev)
        mi = default_max_iters(n)
        got = fused_auction(W, p0, eps, max_iters=mi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fused_auction_ref(W, p0, eps, max_iters=mi)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name, g, w in zip(("r2c", "c2r", "prices", "rounds", "bids"), got, want):
            check(torch.equal(g, w), f"auction_fused {name} B={B} n={n} differs from its plain version")
        max_err = max(max_err, float((got[2] - want[2]).abs().max()))
        print(f"auction_fused B={B} n={n}: kernel == plain version exactly (rounds {got[3].tolist()})")
        if n == 512:
            ms = graph_ms(lambda: fused_auction(W, p0, eps, max_iters=mi), 3, replays=2)
            P = eps.shape[1]
            nbytes = 4.0 * (B * n * n + B * n + B * P + 3 * B * n + B) + 8.0 * B
            b_ms, b_by = bound(nbytes, 2.0 * n * float(got[4].sum()))
            timed = dict(shape=[B, n, n], ms=ms, plain_ms=plain_s * 1e3, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         rounds=got[3].tolist(), bids=got[4].tolist())
            print(f"auction_fused B={B} n={n}: kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms, bound {b_ms * 1e3:.3f} us ({b_by})")
    timed["max_abs_err"] = max_err
    return timed


def buckets(seed: int):
    from repro_torch.traffic import benchmark_workload, gpt3b_workload, moe_workload, permutations_workload

    def stack(make, B):
        return np.stack([make(np.random.default_rng(seed * 1000 + b)) for b in range(B)])

    return [
        ("gpt", "auction", stack(lambda r: gpt3b_workload(rng=r), 8)),
        ("moe", "auction_fr", stack(lambda r: moe_workload(rng=r), 8)),
        ("benchmark", "auction_fr", stack(lambda r: benchmark_workload(rng=r), 8)),
        ("permutations", "auction_fused", stack(lambda r: permutations_workload(n=512, k=16, rng=r), 4)),
    ]


def phase_main_path(seed: int) -> dict:
    from repro_torch.api import SolveOptions, solve_many
    from repro_torch.kernels.auction_bid import masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction

    launches = {"auction_bid": 0, "auction_fused": 0}
    for name, matcher, Ds in buckets(seed):
        solve_many(Ds, 4, 0.01, solver="spectra_torch")  # build + warm-up
        masked_row_top2.launches = 0
        fused_auction.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = solve_many(Ds, 4, 0.01, solver="spectra_torch")
        wall_ms = (time.perf_counter() - t0) * 1e3
        bid, fused = masked_row_top2.launches, fused_auction.launches
        launches["auction_bid"] += bid
        launches["auction_fused"] += fused
        for b, rep in enumerate(reports):
            check(rep.validated, f"{name}[{b}] not validated")
            check(rep.extras["matcher"] == matcher, f"{name}[{b}] used {rep.extras['matcher']}, expected {matcher}")
            check(rep.extras["converged"], f"{name}[{b}] matcher did not converge")
            check(not rep.extras["eq_exhausted"], f"{name}[{b}] EQUALIZE ran out of slots")
            check(np.isfinite(rep.makespan) and rep.makespan >= rep.lower_bound * (1 - 1e-6),
                  f"{name}[{b}] makespan {rep.makespan} below its lower bound {rep.lower_bound}")
        if matcher == "auction_fused":
            check(fused > 0 and bid == 0, f"{name}: expected auction_fused launches only, got bid={bid} fused={fused}")
        else:
            check(bid > 0 and fused == 0, f"{name}: expected auction_bid launches only, got bid={bid} fused={fused}")
        rounds = sum(r.extras["bidding_rounds"] for r in reports)
        ratio = float(np.mean([r.makespan / r.lower_bound for r in reports]))
        print(f"bucket {name} B={len(Ds)} n={Ds.shape[-1]} matcher={matcher}: wall {wall_ms:.1f} ms, "
              f"bidding rounds {rounds}, launches bid={bid} fused={fused}, mean makespan/LB {ratio:.4f}")
        if name == "gpt":
            cpu = solve_many(Ds, 4, 0.01, solver="spectra_torch", options=SolveOptions(extra={"device": "cpu"}))
            rel = [abs(g.makespan - c.makespan) / c.makespan for g, c in zip(reports, cpu)]
            check(max(rel) <= 1e-4, f"gpt: GPU makespans differ from the plain CPU path by {rel}")
            print(f"bucket gpt: GPU makespans agree with the plain CPU path (max relative difference {max(rel):.3g}, "
                  f"bidding rounds {rounds} on the GPU, {sum(r.extras['bidding_rounds'] for r in cpu)} on the CPU)")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.kernels import backend

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    backend.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s ({backend.library_path().name})")

    rng = np.random.default_rng(args.seed)
    bid = phase_bid(rng)
    fused = phase_fused(rng)
    launches = phase_main_path(args.seed)
    check(launches["auction_bid"] > 0 and launches["auction_fused"] > 0, f"main path launches {launches}")

    bid_main = bid["shapes"][1]  # (8, 64): the moe bucket, the most bid launches
    kernels = [
        dict(name="auction_bid", route="cuda", source="src/repro_torch/csrc/auction_bid.cu",
             replaces="src/repro/kernels/auction_bid/kernel.py:22", launches=launches["auction_bid"],
             max_abs_err=bid["max_abs_err"], ms=bid_main["ms"], plain_ms=bid_main["plain_ms"],
             bound_ms=bid_main["bound_ms"], bound_by=bid_main["bound_by"], library_ms=bid_main["library_ms"],
             shape=bid_main["shape"], shapes=bid["shapes"]),
        dict(name="auction_fused", route="cuda", source="src/repro_torch/csrc/auction_fused.cu",
             replaces="src/repro/kernels/auction_fused/kernel.py:55", launches=launches["auction_fused"],
             max_abs_err=fused["max_abs_err"], ms=fused["ms"], plain_ms=fused["plain_ms"],
             bound_ms=fused["bound_ms"], bound_by=fused["bound_by"], library_ms=None,
             shape=fused["shape"], rounds=fused["rounds"], bids=fused["bids"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
