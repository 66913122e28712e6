"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and holds each one against its plain PyTorch
   version on the card: the auction kernels exactly (``masked_row_top2``,
   the op, with 16- and 4-byte loads; ``auction_rounds``, a whole matcher
   call in one launch, on the solver workloads' weights and on tie-rich
   ones, forward and forward-reverse, with the round budget cut too;
   ``decompose_rounds``, DECOMPOSE's whole round loop in one launch, against
   the host loop of ``auction_rounds`` calls on moe's (16, 64, 64);
   ``auction_fused`` on the kernel the wrapper picks (16-CTA
   clusters for up to four lanes where W fits, else one block a lane), and
   the one-block and 8-CTA kernels at n = 512; ``polish_2swap``, the fused
   matcher's completion and 2-swap polish, on auction maps and on maps with
   rows left open, n = 129 to 1024), ``flash_attention``
   (bfloat16 on the tensor cores, float32 on the CUDA cores) and
   ``ssd_chunk`` (bfloat16 on the tensor cores, float32 on the CUDA cores)
   to stated tolerances (at the forward's and the training's shapes, flash
   also at qwen3-moe's GQA 32:4, qwen2-vl's 12:2 and whisper's non-causal
   encoder and cross-attention shapes),
   ``demand_accum`` against a float64
   sum and its plain version within 1e-5 / 2e-5 of each cell's mass (float
   atomics change the sum's order from run to run) on both of its paths,
   uniform, skewed and one-cell events, int64 indices, events out of range
   and a view one element in. It times kernel, plain version and, where one
   exists, a single PyTorch call computing the same function.
2. Drives the solver's path, ``repro_torch.api.solve_many(...,
   solver="spectra_torch")``, on four shape buckets (gpt n=32, moe n=64,
   benchmark n=100, permutations n=512): one warm-up run of the gpt bucket,
   then one timed run of each bucket with the kernels' launch counters set
   to 0 just before it. Every report must validate (Eq. 3 at 1e-4),
   converge, respect its §IV lower bound and finish EQUALIZE on the device;
   gpt, moe and benchmark must launch ``decompose_rounds`` and neither
   ``auction_rounds`` nor ``masked_row_top2`` (no host round loop),
   permutations only the
   cluster ``auction_fused`` kernel, each call with one ``polish_2swap``;
   the gpt bucket must also agree with the
   port's plain CPU path to 1e-4. One more run of the permutations bucket
   times every ``auction_fused`` call with CUDA events, splitting the
   bucket's wall into the kernel and the rest.
   Then the matcher registry and the default-matcher policy
   (``phase_matcher_api``) on the gpt and moe buckets, the counters set to 0
   before each call: ``"auction2"`` (``match_auction`` registered again)
   equal to ``"auction"`` bit for bit with the same ``decompose_rounds``
   launches; under ``set_default_matcher_policy(lambda n: "auction_fused")``
   with no matcher named, reports naming ``auction_fused``, its launches and
   no n ≤ 128 round kernel, makespans equal to the call naming it to 1e-4 (and
   whether bit-equal); ``run_scenario("gpt", solver="spectra_torch",
   online=True)`` launching it, its online/stateless equal to the named
   run's to 1e-4; a ``SolverService`` flush reporting it; after
   ``set_default_matcher_policy(None)``, ``decompose_rounds`` on gpt again.
   The policy and the registration are undone however the phase ends.
   Then the solver layer. ``match_auction`` / ``match_auction_fr`` above
   n = 128 (the round loop, one ``masked_row_top2`` launch a round) at
   (2, 160) and (2, 256), bit for bit against the CPU's plain path; then,
   with the counters set to 0 just before: Fig. 2 through every registered
   solver, each covering schedule replayed by ``fabric.simulator``; the
   paper's comparison (gpt n=32, moe n=64, benchmark n=100; s in {2, 4};
   seven δs) over ``spectra``, ``spectra_torch``, ``Pipeline(decompose=
   "torch_auction", equalize="torch")`` on the card (held to the same
   pipeline on the CPU to 1e-4), ``spectra_eclipse``, ``baseline_less``,
   ``spectra_pp`` and the bound, with the Fig. 6 / Fig. 9 ratios;
   ``torch_auction`` at n = 256 (default matcher: ``masked_row_top2``) and at
   n = 512 (``auction_fused``); and the permutations bucket under the span
   tracer with ``device_sync``, its span totals printed and its Chrome
   trace written to the temp dir. All three auction kernels and
   ``polish_2swap`` must launch.
3. Holds zamba2-1.2b at full width and 7 layers (one group and the
   remainder) in float32 against the port's plain CPU path, with the same
   weights (through ``interop.params_from_reference``).
4. Drives the LM's path at zamba2-1.2b's full width and depth in bfloat16:
   ``LM.apply`` on 2 prompts of 4096 tokens (the second of two runs timed,
   with the counters set to 0 just before it; it must launch ``ssd_chunk``
   38 times and ``flash_attention`` 6 times) with a torch.profiler
   breakdown of one more forward, then ``DecodeEngine.generate`` answering
   4 requests. Teacher forcing: the decode logits must replay the forward's,
   in float32 (the same weights) to 1e-3 of their norm, and in bf16 no
   further from the bf16 forward than that is from the float32 one.
5. Holds one float32 ``train_step`` of zamba2-1.2b at full width and 7
   layers (B = 1 × S = 256) on the GPU against the plain CPU path from the
   same weights: the loss to 1e-5 relative, every gradient tensor to 1e-3 of
   its own largest entry, the second step's loss to 1e-4 relative.
6. Drives the training path, ``repro_torch.launch.train.make_trainer``
   (``Trainer`` over ``make_train_step``), on zamba2-1.2b at full width and
   depth, bf16 parameters and float32 moments: B = 2 × S = 2048 tokens of
   ``make_stream(seed)``, 6 steps, the OCS tick every 2 steps on 4 switches
   and 8 racks, a checkpoint at step 4 and a failure injected at step 5.
   Every step must launch ``ssd_chunk`` 38 times and ``flash_attention`` 6
   times (counters set to 0 just before each step; the backward recomputes
   through the plain versions), every loss must be finite, the run must
   restart once, its 3 tick entries must equal the port's host ``spectra``
   on the same ring matrix, and steps 4–5 after the restore must agree with
   an uninterrupted run to 1e-3 (the GPU's embedding backward sums with
   atomics). One more step is split by CUDA events into forward, backward
   and optimizer, with a torch.profiler breakdown by kernel group.
7. The MoE family, qwen3-moe-30b-a3b (128 experts, top 8). The stable
   top-K on the card must order tie-rich probabilities as the CPU does. At
   full width and 2 layers in float32 (B = 2 × S = 512, one dispatch group
   a row) the GPU path against the plain CPU path: logits to 1e-3 of the
   largest, ``expert_load`` exactly equal;
   then decode teacher-forced against the forward at capacity_factor = E/K
   to 1e-3. At full width and depth in bf16 (30.2 B parameters drawn on the
   card tensor by tensor): ``LM.apply`` on B = 2 × S = 2048 (48 flash
   launches, ``expert_load`` summing to 1,572,864) with a profile by kernel
   group, and ``DecodeEngine`` answering 4 requests. Training at full width,
   depth cut to 4: ``make_trainer``, B = 2 × S = 2048, 4 steps, the OCS tick
   every 2: every step's loads sum to 131,072 and each tick's CCT equals the
   host ``spectra`` on the expert all-to-all built from that step's loads.
8. qwen2-vl-2b: float32 parity at 2 layers with a 16 × 16 patch grid and
   M-RoPE grid positions, text-only teacher forcing; the bf16 forward at
   full depth, B = 2 × S = 4096 (28 flash launches), and decode.
9. whisper-tiny at full depth, B = 4, 1500 frames, 448 tokens: float32
   parity, decode with ``enc_out`` teacher-forced against the forward to
   1e-3; the bf16 forward (12 flash launches) and decode.
10. The online controller and the scenario runner. ``auction_rounds`` with a
   non-zero ``prices0`` against its plain version, bit for bit (n = 32, 64,
   100; forward and forward-reverse; ``None`` equal to zeros). Then
   ``run_scenario(name, solver="spectra_torch", online=True,
   simulate=True, flowsim=True)`` on gpt, moe, benchmark, moe_phases,
   uniform, benchmark_large and permutations_large at their registered n,
   s, δ and period count (the support cache at its default of 8), and moe
   and permutations_large again with ``warm_prices=True``, each with the
   counters set to 0 just before it: every online period at most its
   stateless one and replayed to ``demand_met`` from the carried state,
   reuse and δ avoided on gpt and moe, ``decompose_rounds`` launched (the
   prices carried inside it) and ``auction_fused`` entered at the tail of its ε schedule
   on the warm runs, no ``masked_row_top2``. Every run passes
   ``attribution_summary()`` (the identity at 1e-4) and
   ``warning_counters()`` (no warnings); every period's flow replay
   delivers every flow in full and finishes when ``fabric.simulate`` does.
   The scan's host reads are counted a period
   (``torch.cuda.set_sync_debug_mode``), the flow replay's host time is
   timed a period. On the five scenarios with n <= 100 the card's scan is
   held to the plain CPU path (``warm``, ``cache_hit``, ``k``,
   ``reuse_count`` exact, makespans to 1e-4), and so are the FCT p50 / p99
   and the attribution shares (1e-4 relative), which a child process of
   this script computes while the card runs the other phases. Prints per
   scenario the online pass's wall, ms and host reads a period, bidding
   rounds, warm share, cache hits, reuse, δ avoided, the online/stateless
   totals, the FCT quantiles and attribution shares, and one
   ``{"online": ...}`` line.
11. The dashboard: ``repro_torch.obs.dashboard.main(["moe", "--solver",
   "spectra_torch", "--online", "--html", <tmp>/moe.html])`` exits 0 and
   writes a report naming every switch.
12. The serving plane (``phase_serving``): the double-buffered
   ``ScheduleServer`` on 4 batches of B = 8 moe_phases matrices at n = 64
   with the install latency set to a batch's mean solve time, sync against
   async in turns, four drains each (identical results, async at least
   1.3× faster over the totals); an open
   loop of ``mixed_profile(n_small=32, n_large=64)`` at half the rate async
   sustained, with a schedule cache and admission control (nothing shed);
   a ``SessionManager`` on ``spectra_online_torch`` with two tenants whose
   decisions equal the CPU child's. It must launch ``decompose_rounds`` and no
   ``masked_row_top2``. Prints the walls and their ratio, schedules/s, the
   cache hit rate, queue-wait / device / e2e p50 and p99, and one
   ``{"serving": ...}`` line.
13. The gpt-100m OCS twin (``repro_torch.launch.train_gpt_ocs``, the twin
   of ``examples/train_gpt_ocs.py``): flash_attention float32 at its (8, 12,
   256, 64) causal shape against ``mha_ref`` (atol 1e-4), timed beside the
   plain version, ``scaled_dot_product_attention`` in float32 and the bound;
   then 300 steps at full width (12 layers, d 768, float32) at B = 8 ×
   S = 256 with the OCS tick every 20 steps: the loss must decrease, every
   step must launch flash_attention 12 times and every tick must equal the
   host ``spectra`` on the ring. Prints ms a step, tokens/s, peak memory.
14. The sharded train step on the card: an in-process NCCL group of one rank,
   a 1 × 1 mesh, gpt-100m: equal to the unsharded step (loss 1e-6 relative,
   gradients 1e-5 of each tensor's largest entry, parameters 1e-5), with
   flash_attention launched through ``local_map``; the group is destroyed.
15. The legacy auction shim (``core/torchopt/auction.py``) on a CUDA W at
   n = 64 and 160: the permutation of ``match_auction`` and of the CPU.
16. ``repro_torch.bench.matching`` with its gates at n = 100, 256, 512 (and
   ``auction`` and ``auction_fused`` at 1024): quality ≤ 1.10 and
   ``auction_fused`` ≥ 1.5× ``auction`` a dispatch at n ≥ 256, enforced
   after the kernels line is printed. Prints one ``{"bench_matching": ...}``
   line, the speed-up at each n and an ``auction_fused`` dispatch at
   n = 256, 512 and 1024 split by CUDA events (the ε schedule's host read,
   the kernel, the polish, the rest).
17. The dry run, in a child process on the CPU started with the script:
   ``repro_torch.launch.dryrun`` on qwen3-moe-30b-a3b × train_4k and
   zamba2-1.2b × decode_32k on a fake 16 × 16 process group; it must exit 0
   and write a JSON file a cell. Prints the per-chip FLOPs, bytes and wire
   bytes, the collectives by kind, the three terms against the H100 SXM data
   sheet and the calibration's cross-check: counts, not timings; each
   cell's FLOPs, bytes, wire and resident bytes beside the counts from before
   the loss and the query heads were sharded. qwen3-moe's
   ``flash_attention`` FLOPs a chip must equal ``kernel_cost`` for 2 of its
   32 query heads (the model axis of 16 splits the query heads under GQA).
18. The entry points above the solver API, each as a user calls it, with the
   counters set to 0 just before each and read after it, and its seconds
   printed: ``bench.runtime`` (the §V-A table: host ``spectra`` mean / p95
   and ``spectra_torch`` ms a matrix at B = 16 on gpt, moe, benchmark, at
   B = 2 on benchmark_large n = 256 and permutations_large n = 512, with the
   device/host makespan; every row finite, ``decompose_rounds`` and
   ``auction_fused`` launched); ``bench.serve`` with its gates (async/sync ≥
   1.2 beside the ideal ratio and a batch's solve time, hit rate ≥ 0.70, ≥ 10
   schedules/s, e2e p99 ≤ 2 s, the overload shedding within its bound with
   every ticket accounted for); ``bench.online`` (gpt, moe, benchmark at
   T = 8 and 32, host controller and device scan); ``bench.scenarios
   --solver spectra_torch --online --flowsim --obs`` on gpt, moe, benchmark;
   then, after the dry run, ``bench.experiments`` on its two artifacts (the
   §Dry-run and §Roofline tables, the roofline CSV with the fabric's CCT from
   host ``spectra`` and from ``spectra_torch``); and the examples
   ``batched_device_scheduling``, ``serve_loadtest``, ``serve_decode`` and
   ``moe_traffic_schedule``. The serve gates and the scenario mode's exit
   status are enforced after the kernels line.
19. Prints one ``{"entry_points": ...}`` line, one ``{"matcher_api": ...}``
   line and one ``{"kernels": [...]}``
   line (launches split by path for the auction kernels and
   ``polish_2swap``, the online path with its flow replay, the dashboard,
   the serving phase, the shim, bench/matching, the matcher API phase and
   the entry points of 18 among them, and for ``flash_attention``, the
   gpt-100m run, the sharded step and the examples among them) and, last,
   the ``{"ok": true,
   "device": {...}}`` line.
   Any failed check exits non-zero.

Without a CUDA device, or without the repository beside it, it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

TRAIN_STEPS = 6
TRAIN_REMAT = False  # without it the run peaks at ~48 GB of the 80 (PERF.md §5)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(nbytes: float, ops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
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
    for B, n in [(8, 32), (8, 64), (8, 100), (4, 128), (4, 160), (4, 256), (4, 512), (8, 37), (4, 129), (2, 1)]:
        # The other widths draw from their own stream, so the earlier
        # shapes and phases keep their inputs.
        r = rng if n in (32, 64, 100, 128) else np.random.default_rng([17, n])
        for kind in ("random", "ties"):
            if kind == "random":
                W = torch.from_numpy(r.random((B, n, n), dtype=np.float32)).to(dev)
                p = torch.from_numpy(r.random((B, n), dtype=np.float32)).to(dev)
            else:
                W = torch.from_numpy(r.integers(0, 3, (B, n, n)).astype(np.float32)).to(dev)
                p = torch.from_numpy(r.integers(0, 2, (B, n)).astype(np.float32)).to(dev)
            for name, Wx in (("W", W), ("W.T", W.transpose(1, 2).contiguous())):
                got = masked_row_top2(Wx, p)
                want = masked_row_top2_ref(Wx, p)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"auction_bid {kind} {name} B={B} n={n} differs from its plain version")
                max_err = max(max_err, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    print(f"auction_bid: kernel == plain version exactly at (B, n) in (8,32) (8,64) (8,100) (4,128) (4,160) (4,256) "
          f"(4,512), and with 4-byte loads at (8,37) (4,129) (2,1), random and tie-rich, W and W.T")

    shapes = []
    for B, n in [(8, 32), (8, 64), (8, 100), (4, 512)]:
        r = rng if n <= 128 else np.random.default_rng([17, n])
        W = torch.from_numpy(r.random((B, n, n), dtype=np.float32)).to(dev)
        p = torch.from_numpy(r.random((B, n), dtype=np.float32)).to(dev)
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


def phase_rounds(rng) -> dict:
    """auction_rounds against auction_rounds_ref, bit for bit in row2col,
    col2row, prices, rounds and bids: (B, n) in (8, 32), (8, 64), (8, 100),
    (4, 128) on the bonus weights of the gpt, moe and benchmark workloads
    and on tie-rich integer weights, forward and forward-reverse, with the
    full round budget and with it cut to 5. Then one matcher call's times at
    the moe bucket's shape."""
    from repro_torch.core.torchopt.matching import (_eps_schedule, default_max_iters, default_num_phases,
                                                    match_auction_fr)
    from repro_torch.kernels.auction_bid import auction_rounds, auction_rounds_ref
    from repro_torch.traffic import benchmark_workload, gpt3b_workload, moe_workload

    dev = "cuda"
    makers = {"gpt": lambda n, r: gpt3b_workload(rng=r), "moe": lambda n, r: moe_workload(n=n, rng=r),
              "benchmark": lambda n, r: benchmark_workload(n=n, rng=r)}
    max_err, cases, timed = 0.0, 0, None
    for B, n in [(8, 32), (8, 64), (8, 100), (4, 128)]:
        for kind in ("gpt", "moe", "benchmark", "ties"):
            if kind == "gpt" and n != 32:
                continue  # the GPT-3B trace is 32 racks wide
            if kind == "ties":
                W = torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(dev)
            else:
                D = np.stack([makers[kind](n, np.random.default_rng(int(rng.integers(1 << 31)))) for _ in range(B)])
                W = bonus_weights(torch.from_numpy(D.astype(np.float32)).to(dev))
            eps = _eps_schedule(W, default_num_phases(n)).contiguous()
            for reverse in (False, True):
                for mi in (default_max_iters(n), 5):
                    got = auction_rounds(W, eps, mi, reverse=reverse)
                    torch.cuda.synchronize()
                    want = auction_rounds_ref(W, eps, mi, reverse=reverse)
                    for name, g, w in zip(("row2col", "col2row", "prices", "rounds", "bids"), got, want):
                        check(torch.equal(g, w), f"auction_rounds {name} {kind} B={B} n={n} reverse={reverse} "
                                                 f"max_iters={mi} differs from its plain version")
                    max_err = max(max_err, float((got[2] - want[2]).abs().max()))
                    cases += 1
            if (kind, n) == ("moe", 64):
                mi = default_max_iters(n)
                ms = cuda_ms(lambda: auction_rounds(W, eps, mi, reverse=True), 10)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, _, rounds, bids = auction_rounds_ref(W, eps, mi, reverse=True)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                res = match_auction_fr(W)
                torch.cuda.synchronize()
                call_ms = (time.perf_counter() - t0) * 1e3
                check(torch.equal(res.rounds, rounds), "match_auction_fr rounds differ from the plain version's")
                P = eps.shape[1]
                nbytes = 4.0 * (B * n * n + B * P + 3 * B * n + B) + 8.0 * B
                b_ms, b_by = bound(nbytes, 2.0 * n * float(bids.sum()))
                timed = dict(shape=[B, n, n], reverse=True, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by, matcher_call_ms=call_ms, rounds=rounds.tolist(), bids=bids.tolist())
                print(f"auction_rounds moe B={B} n={n} forward-reverse: kernel {ms:.3f} ms "
                      f"({ms * 1e3 / int(rounds.max()):.3f} us a round of the longest lane), plain {plain_ms:.1f} ms, "
                      f"match_auction_fr call {call_ms:.3f} ms, bound {b_ms * 1e3:.3f} us ({b_by}); "
                      f"rounds {rounds.tolist()}")
    print(f"auction_rounds: kernel == plain version exactly in {cases} cases: (B, n) in (8,32) (8,64) (8,100) (4,128), "
          f"gpt/moe/benchmark bonus weights and tie-rich, forward and forward-reverse, max_iters full and 5")
    timed["max_abs_err"] = max_err
    return timed


def phase_decompose(rng) -> dict:
    """decompose_rounds (DECOMPOSE's whole round loop in one launch) on moe's
    (16, 64, 64), forward-reverse as the moe bucket runs it, cold and with
    carried prices: bit for bit against its plain version
    (``decompose_rounds_ref`` on the same card tensors) and against the host
    loop of auction_rounds launches it replaces (perms, alphas, k, converged,
    rounds, prices). Then one DECOMPOSE's times: the kernel and the host loop
    by CUDA events, the plain version by the host clock, and the bound from
    the function's own traffic (D and T in; perms, alphas, k, converged,
    rounds and prices out) and a floor on its operations (one row's bid
    scan, 2n, a bidding round and one pass over the n x n weights a matcher
    call)."""
    from repro_torch.core.torchopt.matching import default_max_iters, default_num_phases, eps_table, match_auction_fr
    from repro_torch.kernels.auction_bid import decompose_round_loop, decompose_rounds, decompose_rounds_ref
    from repro_torch.traffic import moe_workload

    B, n = 16, 64
    Ds = [moe_workload(n=n, rng=np.random.default_rng(int(rng.integers(1 << 31)))) for _ in range(B)]
    D = torch.tensor(np.stack([d / max(d.sum(0).max(), d.sum(1).max()) for d in Ds]), dtype=torch.float32,
                     device="cuda")
    T, mi = eps_table(default_num_phases(n), "cuda"), default_max_iters(n)
    p0 = torch.rand((B, n), generator=torch.Generator().manual_seed(int(rng.integers(1 << 31)))).cuda()
    names = ("perms", "alphas", "k", "converged", "rounds", "prices")
    max_err, plain_ms = 0.0, None
    for carry, prices0 in ((False, None), (True, p0)):
        got = decompose_rounds(D, T, mi, reverse=True, carry=carry, prices0=prices0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = decompose_rounds_ref(D, T, mi, reverse=True, carry=carry, prices0=prices0)
        torch.cuda.synchronize()
        if not carry:
            plain_ms = (time.perf_counter() - t0) * 1e3
        loop = decompose_round_loop(D, match_auction_fr, carry, prices0)
        for name, g, w, h in zip(names, got, plain, loop):
            check(torch.equal(g, w), f"decompose_rounds {name} carry={carry} differs from its plain version")
            check(torch.equal(g, h), f"decompose_rounds {name} carry={carry} differs from the host loop")
            if g.is_floating_point():
                max_err = max(max_err, float((g - w).abs().max()))
    got = decompose_rounds(D, T, mi, reverse=True, carry=False)
    ms = cuda_ms(lambda: decompose_rounds(D, T, mi, reverse=True, carry=False), 5)
    loop_ms = cuda_ms(lambda: decompose_round_loop(D, match_auction_fr), 3)
    k, rounds = got[2], got[4]
    nbytes = 4.0 * (B * n * n + T.shape[0]) + 8.0 * B * n * n + 4.0 * 2 * B * n + (8 + 1 + 8) * B
    b_ms, b_by = bound(nbytes, 2.0 * n * float(rounds.sum()) + float(n * n) * float(k.sum()))
    print(f"decompose_rounds moe B={B} n={n} forward-reverse: kernel == plain version == host loop exactly, cold "
          f"and carried; kernel {ms:.2f} ms ({ms * 1e3 / int(k.max()):.1f} us a round of the longest lane), plain "
          f"version {plain_ms:.1f} ms, host loop of auction_rounds launches {loop_ms:.2f} ms, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}); k {k.tolist()}")
    return dict(shape=[B, n, n], reverse=True, ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_err, k=k.tolist(), rounds=rounds.tolist())


def phase_fused(rng) -> dict:
    """auction_fused against fused_auction_ref, bit for bit in r2c, c2r,
    prices, rounds and bids, on permutations + M-bonus weights at (B, n) in
    (4, 100), (4, 256), (4, 512) and (1, 1024), each on the kernel the wrapper
    picks (``pick_kernel``: 16-CTA clusters for up to four lanes where W fits
    them, else the one-block kernel), and at n = 512 the one-block kernel and
    the 8-CTA cluster too. The n = 512 call is timed on all three (CUDA
    events around eager calls), with µs a round of the longest lane: a round
    is a chain of dependent steps, so rounds × a round's latency, not the
    bytes or the flops, bounds the kernel."""
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.kernels.auction_fused.ops import pick_kernel
    from repro_torch.traffic import permutations_workload

    dev = "cuda"
    max_err = 0.0
    timed, served = None, {}
    for B, n in [(4, 100), (4, 256), (4, 512), (1, 1024)]:
        D = np.stack([permutations_workload(n=n, k=16, rng=rng) for _ in range(B)])
        W = bonus_weights(torch.from_numpy(D.astype(np.float32)).to(dev))
        eps = _eps_schedule(W, default_num_phases(n)).contiguous()
        p0 = torch.zeros((B, n), device=dev)
        mi = default_max_iters(n)
        kernel, cluster = pick_kernel(B, n)
        kernel = served[n] = f"cluster {cluster}" if kernel == "cluster" else kernel
        got = fused_auction(W, p0, eps, max_iters=mi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fused_auction_ref(W, p0, eps, max_iters=mi)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name, g, w in zip(("r2c", "c2r", "prices", "rounds", "bids"), got, want):
            check(torch.equal(g, w), f"auction_fused ({kernel} kernel) {name} B={B} n={n} differs from its plain version")
        max_err = max(max_err, float((got[2] - want[2]).abs().max()))
        print(f"auction_fused B={B} n={n}, {kernel} kernel: kernel == plain version exactly (rounds {got[3].tolist()})")
        if n == 512:
            others = {"block": dict(kernel="block"), "cluster 8": dict(kernel="cluster", cluster=8)}
            for label, opts in others.items():
                for name, g, w in zip(("r2c", "c2r", "prices", "rounds", "bids"),
                                      fused_auction(W, p0, eps, max_iters=mi, **opts), want):
                    check(torch.equal(g, w), f"auction_fused ({label} kernel) {name} B={B} n={n} differs from its "
                                             f"plain version")
                print(f"auction_fused B={B} n={n}, {label} kernel: kernel == plain version exactly")
            ms = cuda_ms(lambda: fused_auction(W, p0, eps, max_iters=mi), 5, warmup=1)
            other_ms = {label: cuda_ms(lambda: fused_auction(W, p0, eps, max_iters=mi, **opts), 5, warmup=1)
                        for label, opts in others.items()}
            longest = int(got[3].max())
            P = eps.shape[1]
            nbytes = 4.0 * (B * n * n + B * n + B * P + 3 * B * n + B) + 8.0 * B
            b_ms, b_by = bound(nbytes, 2.0 * n * float(got[4].sum()))
            timed = dict(shape=[B, n, n], kernel=kernel, ms=ms, us_per_round=ms * 1e3 / longest,
                         block_ms=other_ms["block"], block_us_per_round=other_ms["block"] * 1e3 / longest,
                         cluster8_ms=other_ms["cluster 8"], plain_ms=plain_s * 1e3, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by, rounds=got[3].tolist(), bids=got[4].tolist())
            print(f"auction_fused B={B} n={n}: {kernel} kernel {ms:.3f} ms ({ms * 1e3 / longest:.3f} us a round of "
                  f"the longest lane, {longest} rounds), "
                  + ", ".join(f"{label} kernel {t:.3f} ms ({t * 1e3 / longest:.3f} us a round)"
                              for label, t in other_ms.items())
                  + f", plain {plain_s * 1e3:.1f} ms, bound {b_ms * 1e3:.3f} us ({b_by})")
    timed["max_abs_err"] = max_err
    timed["kernel_by_n"] = served
    return timed


def phase_polish(rng) -> dict:
    """polish_2swap, the fused matcher's tail (greedy completion, then the
    best-pair 2-swap polish), against polish_2swap_ref, bit for bit in perm
    and converged: on the maps an auction_fused call leaves on permutations +
    M-bonus weights at (4, 512), the permutations bucket's shape, and on
    maps with a seventh of the rows unassigned over random, tie-rich and
    bench/matching weights at (2, n), n = 129, 256, 512 and 1024, with
    max_swaps 2n (the matcher's) and 3. The (4, 512) call is timed (CUDA
    events around eager calls) beside its plain version. Its bound counts W
    read once and, for the operations, three adds a pair in each pass over
    the n² pairs: at least one pass a lane and one more a swap, the swaps
    counted as half the rows the polish moved."""
    from repro_torch.bench.matching import bench_weights
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, polish_2swap, polish_2swap_ref
    from repro_torch.traffic import permutations_workload

    def holes(n):
        perm = rng.permutation(n)
        c2r = np.empty(n, dtype=np.int64)
        c2r[perm] = np.arange(n)
        drop = rng.choice(n, n // 7, replace=False)
        c2r[perm[drop]] = -1
        perm[drop] = -1
        return perm, c2r

    cases = []
    D = np.stack([permutations_workload(n=512, k=16, rng=rng) for _ in range(4)])
    W = bonus_weights(torch.from_numpy(D.astype(np.float32)).cuda())
    eps = _eps_schedule(W, default_num_phases(512)).contiguous()
    r2c, c2r, *_ = fused_auction(W, torch.zeros((4, 512), device="cuda"), eps, max_iters=default_max_iters(512))
    cases.append(("auction maps", W, r2c, c2r))
    for n in (129, 256, 512, 1024):
        for kind in ("random", "ties", "bench"):
            if kind == "random":
                Wn = rng.random((2, n, n), dtype=np.float32)
            elif kind == "ties":
                Wn = rng.integers(0, 3, (2, n, n)).astype(np.float32)
            else:
                Wn = np.stack([bench_weights(n, seed=s) for s in range(2)])
            r, c = zip(*(holes(n) for _ in range(2)))
            cases.append((kind, torch.from_numpy(Wn).cuda(), torch.from_numpy(np.stack(r)).cuda().int(),
                          torch.from_numpy(np.stack(c)).cuda().int()))
    swaps_seen = 0
    for kind, Wc, r, c in cases:
        n = Wc.shape[1]
        for max_swaps in (2 * n, 3):
            got = polish_2swap(Wc, r, c, max_swaps=max_swaps)
            want = polish_2swap_ref(Wc, r, c, max_swaps=max_swaps)
            for name, g, w in zip(("perm", "converged"), got, want):
                check(torch.equal(g, w), f"polish_2swap {kind} n={n} max_swaps={max_swaps}: {name} differs from "
                                         f"its plain version")
            swaps_seen += int((got[0] != torch.where(r >= 0, r.long(), got[0])).sum())
    print(f"polish_2swap: kernel == plain version exactly in {2 * len(cases)} cases (n = 129-1024, random, "
          f"tie-rich and bench weights with a seventh of the rows open, and auction maps at (4, 512); rows moved "
          f"off their auction column {swaps_seen})")
    B, n = 4, 512
    ms = cuda_ms(lambda: polish_2swap(W, r2c, c2r, max_swaps=2 * n), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = polish_2swap_ref(W, r2c, c2r, max_swaps=2 * n)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    moved = (want[0] != r2c.long()).sum(dim=1).tolist()
    passes = sum(min(2 * n, 1 + (m + 1) // 2) for m in moved)
    b_ms, b_by = bound(4.0 * B * n * n + 8.0 * B * n + 8.0 * B * n + B, 3.0 * n * n * passes)
    print(f"polish_2swap (4, 512) on auction maps: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms * 1e3:.3f} us "
          f"({b_by}), rows moved {moved}")
    return dict(shape=[B, n, n], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=0.0, cases=2 * len(cases))


def kernel_bound(name: str, peak: float, **shape) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, FLOPs, bytes) of one kernel call, from the
    package's ``kernel_cost``: the dry run counts the same FLOPs and bytes."""
    from repro_torch.analysis.roofline import kernel_cost

    flops, nbytes = kernel_cost(name, **shape)
    return (*bound(nbytes, flops, peak), flops, nbytes)


def phase_flash(rng) -> dict:
    """flash_attention against mha_ref: float32 (the CUDA-core kernel) to
    accumulation order (atol 1e-4), bfloat16 (the tensor-core kernel, P
    rounded to bf16 for the second product) to the output's rounding
    (|Δ| ≤ 1e-2 + 1e-2·|ref|, about two bf16 ulps of the output)."""
    from repro_torch.kernels.flash_attention import flash_attention, mha_ref

    tol = {torch.float32: dict(rtol=0.0, atol=1e-4), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
    cases = [  # B, Hq, Hkv, Sq, Sk, D, causal, window
        (2, 32, 32, 4096, 4096, 64, True, None),  # zamba2-1.2b prefill
        (2, 32, 32, 2048, 2048, 64, True, None),  # zamba2-1.2b training
        (1, 8, 2, 512, 512, 128, True, None),      # GQA 4:1
        (1, 4, 4, 1024, 1024, 64, True, 64),       # sliding window
        (1, 8, 2, 256, 1024, 64, True, None),      # Sq < Sk
        (1, 4, 2, 77, 77, 32, False, None),        # ragged tiles, no mask
        (1, 6, 2, 1000, 1300, 128, True, 200),     # ragged, GQA 3:1, window, Sq < Sk
        (2, 32, 4, 2048, 2048, 128, True, None),   # qwen3-moe-30b-a3b prefill, GQA 8:1
        (2, 12, 2, 4096, 4096, 128, True, None),   # qwen2-vl-2b, GQA 6:1
        (4, 6, 6, 1500, 1500, 64, False, None),    # whisper-tiny encoder: Sk a multiple of no key tile
        (4, 6, 6, 448, 1500, 64, False, None),     # whisper-tiny cross-attention, Sq ≠ Sk
        (4, 6, 6, 448, 448, 64, True, None),       # whisper-tiny decoder self-attention: 3.5 key tiles
        (8, 4, 4, 64, 64, 32, True, None),         # deepseek-moe-16b reduced, the moe_traffic_schedule example
    ]
    max_err, timed, moe_timed = 0.0, None, None
    for B, Hq, Hkv, Sq, Sk, D, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
                       for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = mha_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            bad = ((got.float() - want.float()).abs() > tol[dtype]["atol"] + tol[dtype]["rtol"] * want.float().abs())
            check(not bool(bad.any()), f"flash_attention {dtype} {(B, Hq, Hkv, Sq, Sk, D, causal, window)}: "
                                       f"max |Δ| {err} beyond {tol[dtype]}")
            max_err = max(max_err, err)
            print(f"flash_attention {str(dtype)[6:]} B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} causal={causal} "
                  f"window={window}: max |kernel − plain| {err:.3g}")
            if (B, Hq, Hkv, Sq, D, dtype) == (2, 32, 32, 4096, 64, torch.bfloat16):
                ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
                plain_ms = cuda_ms(lambda: mha_ref(q, k, v, causal=True), 3, warmup=1)
                lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
                b_ms, b_by, flops, _ = kernel_bound("flash_attention", BF16_FLOPS, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                                 causal=True, window=None, itemsize=2)
                timed = dict(shape=[B, Hq, Sq, D], dtype="bfloat16", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, flops=flops)
                print(f"flash_attention bf16 (2, 32, 4096, 64) causal: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                      f"TFLOP/s), plain {plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by})")
            if (Hq, Hkv, Sq, dtype) == (32, 4, 2048, torch.bfloat16):
                ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
                plain_ms = cuda_ms(lambda: mha_ref(q, k, v, causal=True), 3, warmup=1)
                lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
                b_ms, b_by, flops, _ = kernel_bound("flash_attention", BF16_FLOPS, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                                 causal=True, window=None, itemsize=2)
                moe_timed = dict(shape=[B, Hq, Hkv, Sq, D], dtype="bfloat16", ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, flops=flops)
                print(f"flash_attention bf16 (2, 32:4, 2048, 128) causal, qwen3-moe-30b-a3b's shape: kernel {ms:.3f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
                      f"(enable_gqa) {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    timed["shapes"] = [dict(timed), moe_timed]
    timed["max_abs_err"] = max_err
    return timed


def phase_ssd(rng) -> dict:
    """ssd_chunk against ssd_chunk_ref at rtol/atol 1e-4 in both types. The
    float32 kernel sums in float32 on the CUDA cores (only the order differs);
    the bfloat16 kernel multiplies on the tensor cores, with each float32
    operand it forms (the decayed scores, B scaled by the decay to the
    chunk's end) split into a bf16 high and low part, ≤ 2⁻¹⁷ relative."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    from repro_torch.kernels.ssd_scan.ops import _pick_chunk

    max_err, timed = 0.0, None
    for BH, S, N, P in [(128, 4096, 64, 64), (128, 2048, 64, 64), (128, 96, 64, 64), (4, 256, 128, 128)]:
        L = _pick_chunk(S)
        for dtype in (torch.float32, torch.bfloat16):
            xd = torch.from_numpy(rng.standard_normal((BH, S, P), dtype=np.float32)).to("cuda", dtype)
            loga = torch.from_numpy((-0.5 * rng.random((BH, S))).astype(np.float32)).cuda()
            B, C = (torch.from_numpy((rng.standard_normal((BH, S, N)) / np.sqrt(N)).astype(np.float32)).to("cuda", dtype)
                    for _ in range(2))
            got = ssd_chunk(xd, loga, B, C, L)
            torch.cuda.synchronize()
            want = ssd_chunk_ref(xd, loga, B, C, L)
            errs = []
            for name, g, w in zip(("y", "states", "gates"), got, want):
                ok = torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                errs.append(float((g - w).abs().max()))
                check(ok, f"ssd_chunk {name} {dtype} BH={BH} S={S}: max |Δ| {errs[-1]} beyond rtol/atol 1e-4")
            max_err = max(max_err, *errs)
            print(f"ssd_chunk {str(dtype)[6:]} BH={BH} S={S} L={L} N={N} P={P}: max |kernel − plain| "
                  f"y {errs[0]:.3g}, states {errs[1]:.3g}, gates {errs[2]:.3g}")
            if (S, dtype) == (4096, torch.bfloat16):
                ms = cuda_ms(lambda: ssd_chunk(xd, loga, B, C, L), 20)
                plain_ms = cuda_ms(lambda: ssd_chunk_ref(xd, loga, B, C, L), 5, warmup=1)
                b_ms, b_by, flops, nbytes = kernel_bound("ssd_chunk", BF16_FLOPS, BH=BH, S=S, L=L, N=N, P=P,
                                                         itemsize=2)
                timed = dict(shape=[BH, S, N, P], chunk=L, dtype="bfloat16", ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
                print(f"ssd_chunk bf16 BH={BH} S={S}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP)")
    timed["max_abs_err"] = max_err
    return timed


def phase_model_parity(seed: int) -> None:
    """zamba2-1.2b at full width, 7 layers, float32: the GPU path against the
    plain CPU path with the same weights; logits to 1e-3 of their largest."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models import build_model, concrete_inputs

    cfg = replace(get_arch("zamba2-1.2b"), num_layers=7, dtype="float32")
    cpu = build_model(cfg, device="cpu", seed=seed)
    tree = params_to_reference(cfg, cpu.state_dict())  # the reference's layout, numpy leaves
    gpu = build_model(cfg, device="cuda", seed=seed + 1)
    gpu.load_state_dict(params_from_reference(cfg, tree))
    cpu.load_state_dict(params_from_reference(cfg, tree))
    tokens = concrete_inputs(cfg, ShapeCfg("parity", 256, 1, "prefill"), seed=seed, device="cpu")["tokens"]
    flash_attention.launches = ssd_chunk.launches = 0
    with torch.inference_mode():
        got = gpu.apply({"tokens": tokens.cuda()})["logits"].cpu()
        want = cpu.apply({"tokens": tokens})["logits"]
    check((flash_attention.launches, ssd_chunk.launches) == (1, 7),
          f"7-layer parity: launches flash {flash_attention.launches}, ssd {ssd_chunk.launches}, expected 1 and 7")
    rel = float((got - want).abs().max() / want.abs().max())
    check(bool(torch.isfinite(got).all()) and rel <= 1e-3, f"7-layer parity: GPU logits differ from CPU by {rel}")
    print(f"zamba2-1.2b full width, 7 layers, float32, B=1 S=256: GPU logits equal the plain CPU path's "
          f"(max |Δ| / max |logit| = {rel:.3g})")
    del cpu, gpu, tree


def kernel_group(name: str) -> str:
    """The group of a CUDA kernel's (lowercase) name in the profiles' breakdowns."""
    if "ssd_chunk" in name:
        return "ssd_chunk"
    if "flash_attention" in name:
        return "flash_attention"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer (foreach)"
    if any(t in name for t in ("gather", "scatter", "index", "sort")):
        return "gather/scatter/index/sort"
    return "other (elementwise, copies, reductions)"


def device_time_by_kernel(model, batch) -> tuple[dict[str, float], list[tuple[str, float, int]]]:
    """Device ms of one forward from a torch.profiler trace: by kernel group,
    and the ten costliest kernels as (name, ms, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.apply(batch)
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        group = kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((e.key[:90], ms, e.count))
    return groups, sorted(kernels, key=lambda k: -k[1])[:10]


def decode_vs_forward(model, engine, prompts, extra: dict | None = None, enc_out=None):
    """Serve ``prompts`` (32 new tokens, greedy) and replay the forward on the
    tokens it produced (teacher forcing), with the model's other inputs
    ``extra`` (whisper's ``frames``, whose encoding is ``enc_out``). Returns
    (result, wall ms, ‖Δ‖/‖ref‖, the forward's logits, the kernel launches of
    the decode alone)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    flash_attention.launches = ssd_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(prompts, 32, keep_logits=True, enc_out=enc_out)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches}
    with torch.inference_mode():
        forced = model.apply({"tokens": torch.from_numpy(res.tokens[:, :-1]).cuda(), **(extra or {})})["logits"]
    S0 = prompts.shape[1]
    check(res.tokens.shape == (len(prompts), S0 + 32) and (res.tokens[:, :S0] == prompts).all()
          and ((res.tokens >= 0) & (res.tokens < model.cfg.vocab_size)).all(), f"{model.cfg.name} decode: bad tokens")
    check(bool(torch.isfinite(res.logits).all()), f"{model.cfg.name} decode logits not finite")
    return res, wall_ms, float((res.logits - forced).norm() / forced.norm()), forced, launches


def served(model, prompts, extra: dict | None = None, enc_out=None):
    """``DecodeEngine`` answering ``prompts`` after a short warm-up:
    ``decode_vs_forward``'s results, the wall in ms a decode step."""
    from repro_torch.serve import DecodeEngine

    engine = DecodeEngine(model, max_len=128)
    engine.generate(prompts[:, :4], 2, enc_out=enc_out)  # warm-up
    res, wall_ms, rel, forced, launches = decode_vs_forward(model, engine, prompts, extra, enc_out)
    return res, wall_ms / res.logits.shape[1], rel, forced, launches


def phase_zamba2(seed: int) -> dict:
    """The LM's path at full size: the forward, then the decode server."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.models import build_model, concrete_inputs
    from repro_torch.serve import DecodeEngine

    cfg = get_arch("zamba2-1.2b")
    model = build_model(cfg, seed=seed)
    print(f"zamba2-1.2b: {model.param_count() / 1e9:.3f} B parameters in {cfg.dtype}, {cfg.num_layers} Mamba-2 "
          f"layers, shared attention after every {cfg.attn_every}")
    B, S = 2, 4096
    batch = concrete_inputs(cfg, ShapeCfg("prefill_4k", S, B, "prefill"), seed=seed)
    out, wall_ms, peak_gb, launches = forward_timed("zamba2-1.2b", model, batch, {"flash_attention": 6, "ssd_chunk": 38})
    del out
    print(f"zamba2-1.2b forward B={B} S={S} bf16: wall {wall_ms:.1f} ms, {B * S / wall_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB, launches {launches}")
    print_profile("zamba2-1.2b", model, batch, wall_ms)

    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    res, ms_step, rel, forced, decode_launches = served(model, prompts)
    steps = res.logits.shape[1]
    agree = float((res.logits.argmax(-1) == forced.argmax(-1)).float().mean())
    print(f"zamba2-1.2b DecodeEngine bf16: 4 requests, prompt 64, 32 new tokens, greedy: {steps} decode steps in "
          f"{ms_step * steps:.1f} ms ({ms_step:.2f} ms per step), kernel launches while decoding "
          f"{decode_launches}; decode vs forward logits "
          f"‖Δ‖/‖ref‖ {rel:.4g}, argmax agreement {agree:.4f}")

    # The same weights in float32: the decode path must replay the forward
    # to float32 rounding (1e-3 of the norm); and bf16's own error, the bf16
    # forward against the float32 one on the same tokens, bounds the bf16
    # decode's distance from the bf16 forward.
    model32 = build_model(replace(cfg, dtype="float32"), seed=seed)
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        exact = model32.apply({"tokens": torch.from_numpy(res.tokens[:, :-1]).cuda()})["logits"]
    bf16_err = float((forced - exact).norm() / exact.norm())
    del forced, exact
    _, _, rel32, _, _ = decode_vs_forward(model32, DecodeEngine(model32, max_len=128), prompts)
    print(f"zamba2-1.2b float32, same weights: decode vs forward ‖Δ‖/‖ref‖ {rel32:.3g}; bf16 forward vs float32 "
          f"forward {bf16_err:.4g}")
    check(rel32 <= 1e-3, f"float32 decode logits differ from the forward's by {rel32} of their norm")
    check(rel <= bf16_err, f"bf16 decode logits differ from the bf16 forward's by {rel}, more than bf16's own "
                           f"error {bf16_err}")
    del model32
    return launches


def accum_events(kind: str, T: int, n: int, gen: torch.Generator):
    """(src, dst, w) of T events on the card for an (n, n) demand matrix,
    w ~ U[0, 1): "uniform" (int32 indices; "uniform int64" int64) over the
    cells, "skewed" (90% of the events on 1% of the cells, chosen at random;
    the rest uniform), "one cell" (every event on cell (n // 3, 2n // 3)),
    "out of range" (indices uniform in [-5, n + 5))."""
    dev = gen.device
    w = torch.rand((T,), generator=gen, device=dev)
    if kind == "one cell":
        return (torch.full((T,), n // 3, dtype=torch.int32, device=dev),
                torch.full((T,), 2 * n // 3, dtype=torch.int32, device=dev), w)
    if kind == "skewed":
        hot = torch.randperm(n * n, generator=gen, device=dev)[:max(1, n * n // 100)]
        cell = torch.randint(0, n * n, (T,), generator=gen, device=dev)
        pick = hot[torch.randint(0, hot.numel(), (T,), generator=gen, device=dev)]
        cell = torch.where(torch.rand((T,), generator=gen, device=dev) < 0.9, pick, cell).to(torch.int32)
        return cell // n, cell % n, w
    lo, hi = (-5, n + 5) if kind == "out of range" else (0, n)
    itype = torch.int64 if kind == "uniform int64" else torch.int32
    return (*(torch.randint(lo, hi, (T,), generator=gen, device=dev, dtype=itype) for _ in range(2)), w)


def phase_demand_accum(rng) -> dict:
    """demand_accum against a float64 sum and its plain version. Float
    atomics sum in an order that changes from run to run, so the kernel must
    lie within 1e-5 of each cell's mass Σ|w| (plus 1e-30) of the float64 sum
    of the same events, and within twice that of the plain version (each of
    the two lies within 1e-5 of the exact sum). The cases cover both paths
    the launcher picks (private copies in a CTA's shared memory at n ≤ 241,
    global atomics above), misaligned views, and contention (skewed events,
    one cell); the timed ones beside their bound."""
    from repro_torch.kernels.demand_accum import demand_accum, demand_accum_ref, in_range

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))
    timed = [("uniform", 1 << 23, 64), ("uniform", 1 << 23, 512), ("uniform", 1 << 23, 300),
             ("skewed", 1 << 23, 64), ("skewed", 1 << 23, 512), ("one cell", 1 << 16, 64)]
    checked = [("uniform", 1000, 64), ("uniform int64", 1 << 20, 241), ("uniform", 1 << 20, 242),
               ("uniform int64", 1 << 20, 1024), ("out of range", 1 << 20, 130), ("out of range", 1 << 20, 512),
               ("uniform", (1 << 20) + 3, 64)]
    max_err, shapes = 0.0, []
    for kind, T, n in timed + checked:
        src, dst, w = accum_events(kind, T, n, gen)
        if T % 4:  # views one element in: the 16-byte loads' scalar head and tail
            src, dst, w = src[1:], dst[1:], w[1:]
        got = demand_accum(src, dst, w, n=n)
        torch.cuda.synchronize()
        keep = in_range(src, dst, n)
        idx = (src[keep].long(), dst[keep].long())
        exact = torch.zeros((n, n), dtype=torch.float64, device="cuda").index_put_(idx, w[keep].double(),
                                                                                   accumulate=True)
        mass = torch.zeros((n, n), dtype=torch.float64, device="cuda").index_put_(idx, w[keep].double().abs(),
                                                                                  accumulate=True)
        plain = demand_accum_ref(src, dst, w, n)
        err_exact = float(((got.double() - exact).abs() / (mass + 1e-30)).max())
        err_plain = float(((plain.double() - exact).abs() / (mass + 1e-30)).max())
        name = f"{kind} T={src.shape[0]} n={n}"
        check(bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all()),
              f"demand_accum {name}: kernel off the float64 sum by {err_exact} of the cell mass")
        check(bool(((got.double() - plain.double()).abs() <= 2e-5 * mass + 1e-30).all()),
              f"demand_accum {name}: kernel differs from its plain version beyond 2e-5 of the cell mass")
        max_err = max(max_err, float((got - plain).abs().max()))
        print(f"demand_accum {name}: kernel within {err_exact:.3g} of the cell mass of the float64 sum "
              f"(plain version {err_plain:.3g}), max |kernel − plain| {float((got - plain).abs().max()):.3g}")
        if (kind, T, n) in timed:
            ms = cuda_ms(lambda: demand_accum(src, dst, w, n=n), 20)
            plain_ms = cuda_ms(lambda: demand_accum_ref(src, dst, w, n), 5, warmup=1)
            flat = (src[keep].long() * n + dst[keep].long()).contiguous()
            wk = w[keep].contiguous()
            lib_ms = cuda_ms(lambda: torch.bincount(flat, weights=wk, minlength=n * n), 20)
            b_ms, b_by = bound(12.0 * T + 4.0 * n * n, float(T))
            shapes.append(dict(case=kind, shape=[T, n], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by))
            print(f"demand_accum {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bincount "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of its bound")
    main = dict(shapes[0], max_abs_err=max_err, shapes=shapes)
    return main


def train_setup(seed: int, **kw):
    """The launcher's trainer for zamba2-1.2b at full width and depth, bf16:
    B = 2 × S = 2048 tokens of ``make_stream(seed)``, 6 steps at
    ``warmup_stable_decay(3e-4, 6)``, the OCS tick every 2 steps on 4 switches
    with δ = 20 µs over 8 racks (``examples/train_gpt_ocs.py``'s fabric)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_trainer

    return make_trainer(get_arch("zamba2-1.2b"), steps=TRAIN_STEPS, batch=2, seq=2048, lr=3e-4, seed=seed,
                        ocs_switches=4, ocs_delta_us=20.0, ocs_every=2, remat=TRAIN_REMAT, log_every=1, **kw)


def counted(step_fn, log: list):
    """``step_fn`` with the LM kernels' counters set to 0 just before each
    call and read just after it, into ``log``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    def run(*args):
        flash_attention.launches = ssd_chunk.launches = 0
        out = step_fn(*args)
        log.append({"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches})
        return out

    return run


def step_breakdown(tr, state) -> tuple[dict, dict, float]:
    """Two more steps of ``tr`` from ``state``: one split by CUDA events into
    the forward (``LM.loss``), the backward and the optimizer, then one under
    torch.profiler for the device time by kernel group (the profiler slows
    the host, so the split is taken without it). The step's parts are those
    of ``make_train_step``: ``loss_and_grads``, then ``AdamW.update``.
    Returns the split, the groups and the profiled step's own event span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, opt = tr.model, tr.optimizer
    batch = tr.stream.next_batch(0)

    def step(ev):
        leaves = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        with torch.enable_grad(), model.bound(leaves):
            ev[0].record()
            loss, _ = model.loss(batch)
            ev[1].record()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            ev[2].record()
        opt.update(dict(zip(leaves, grads)), state.opt_state, state.params)
        ev[3].record()
        torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    step(ev)
    phases = {"forward": ev[0].elapsed_time(ev[1]), "backward": ev[1].elapsed_time(ev[2]),
              "optimizer": ev[2].elapsed_time(ev[3])}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(ev)
    span = ev[0].elapsed_time(ev[3])
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        group = kernel_group(e.key.lower())
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    return phases, groups, span


def phase_train(seed: int) -> dict:
    """The training path at full size: ``Trainer`` over ``make_train_step``
    with a checkpoint at step 4 and a failure injected at step 5, then an
    uninterrupted run of the same 6 steps to compare with."""
    import tempfile

    from repro_torch.fabric import OCSFabric
    from repro_torch.train.fault_tolerance import fail_at
    from repro_torch.train.loop import _demand_from_stats

    B, S = 2, 2048
    per_step: list = []
    with tempfile.TemporaryDirectory(prefix="zamba2_ckpt_") as ckpt:
        tr = train_setup(seed, ckpt_dir=ckpt, ckpt_every=4, ckpt_keep=1, failure_injector=fail_at({5}))
        tr.train_step = counted(tr.train_step, per_step)
        n_params = tr.model.param_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = tr.run(seed)
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"zamba2-1.2b training: {n_params / 1e9:.3f} B parameters in bf16, float32 moments, remat {TRAIN_REMAT}; "
          f"B={B} S={S}, {TRAIN_STEPS} steps, checkpoint at 4, failure at 5: run {run_s:.1f} s, peak memory "
          f"{peak_gb:.2f} GB, restarts {state.restarts}")
    losses = [h["loss"] for h in state.history]
    for h, launches in zip(state.history, per_step[:len(state.history)]):
        print(f"  step {h['step']}: loss {h['loss']:.5f}, wall {h['time_s'] * 1e3:.1f} ms, launches {launches}")
    check(state.restarts == 1 and state.step == TRAIN_STEPS, f"restarts {state.restarts}, final step {state.step}")
    check([h["step"] for h in state.history] == [0, 1, 2, 3, 4, 4, 5], f"history {state.history}")
    check(all(np.isfinite(losses)), f"training losses not finite: {losses}")
    want = {"flash_attention": 6, "ssd_chunk": 38}
    check(len(per_step) == len(state.history) and all(c == want for c in per_step),
          f"launches per step {per_step}, expected {want} in each of {len(state.history)} steps")
    walls = [h["time_s"] * 1e3 for h in state.history[1:]]
    wall_ms = float(np.mean(walls))
    print(f"zamba2-1.2b train step after the first: wall {wall_ms:.1f} ms (min {min(walls):.1f}, max "
          f"{max(walls):.1f}), {B * S / wall_ms * 1e3:.0f} tokens/s")

    # The OCS tick: 3 entries, each the port's own host spectra on the ring.
    check(len(state.cct_log) == 3 and [r["step"] for r in state.cct_log] == [1, 3, 5], f"cct_log {state.cct_log}")
    ring = _demand_from_stats(8, {}, 0)
    res, cct = OCSFabric(num_switches=4, reconfig_delay_s=20e-6).schedule_bytes(ring * 1e9)
    for r in state.cct_log:
        check(abs(r["cct_s"] - cct) <= 1e-12 * cct and abs(r["makespan"] - res.makespan) <= 1e-12 * res.makespan
              and r["configs"] == res.schedule.num_configs(), f"tick {r} differs from host spectra ({cct} s)")
        print(f"  OCS tick after step {r['step']}: CCT {r['cct_s'] * 1e3:.4f} ms, makespan {r['makespan']:.6f}, "
              f"LB {r['lb']:.6f}, {r['configs']} circuits")
    del tr, state

    # The same 6 steps without the failure: steps 4 and 5 after the restore
    # must agree to 1e-3 (the GPU's embedding backward sums with atomics).
    tr = train_setup(seed)
    clean = tr.run(seed)
    clean_losses = [h["loss"] for h in clean.history]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[-2:], clean_losses[-2:])]
    print(f"uninterrupted run, losses {[round(x, 5) for x in clean_losses]}; steps 4-5 after the restore differ "
          f"by {[f'{r:.3g}' for r in rel]} (relative)")
    check(max(rel) <= 1e-3, f"restored losses {losses[-2:]} vs uninterrupted {clean_losses[-2:]}")

    phases, groups, span = step_breakdown(tr, clean)
    busy = sum(groups.values())
    print("zamba2-1.2b train step, device time by phase (CUDA events, one step): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in phases.items()) + f", together {sum(phases.values()):.1f} ms; "
          + "by kernel group (torch.profiler, one more step): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f", busy {busy:.1f} ms of that step's {span:.1f} ms event span (idle share {1 - busy / span:.3f}, the "
          + f"profiler's host work included; busy over the unprofiled step's span {1 - busy / sum(phases.values()):.3f})")
    del tr, clean
    return {k: sum(c[k] for c in per_step) for k in want}


def phase_train_parity(seed: int) -> None:
    """zamba2-1.2b at full width, 7 layers, float32, B = 1 × S = 256: one
    ``train_step`` on the GPU and on the plain CPU path from the same
    weights. The loss to 1e-5 relative, every gradient tensor to 1e-3 of its
    own largest entry, the second step's loss to 1e-4 relative."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_stream
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import loss_and_grads, make_train_step
    from repro_torch.train.optimizer import AdamW, warmup_stable_decay

    cfg = replace(get_arch("zamba2-1.2b"), num_layers=7, dtype="float32")
    sides = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, seed=seed)
        params = {k: v.to(dev) for k, v in sides["cuda"][0].items()} if sides else model.init(seed)
        opt = AdamW(schedule=warmup_stable_decay(3e-4, 6))
        stream = make_stream(cfg.vocab_size, 256, 1, seed=seed, device=dev)
        loss, _, grads = loss_and_grads(model, params, stream.next_batch(0))
        step = make_train_step(model, opt)
        p1, s1, m1 = step(params, opt.init(params), stream.next_batch(0))
        _, _, m2 = step(p1, s1, stream.next_batch(1))
        sides[dev] = (params, float(loss), {k: g.cpu() for k, g in grads.items()}, float(m1["loss"]), float(m2["loss"]))
        del model, p1, s1
    (_, l0g, gg, l1g, l2g), (_, l0c, gc, l1c, l2c) = sides["cuda"], sides["cpu"]
    worst = max(float((gg[k] - gc[k]).abs().max() / max(float(gc[k].abs().max()), 1e-30)) for k in gc)
    print(f"zamba2-1.2b full width, 7 layers, float32, B=1 S=256, train step GPU vs plain CPU path: loss "
          f"{l0g:.6f} vs {l0c:.6f}; worst gradient tensor {worst:.3g} of its largest entry; second step's loss "
          f"{l2g:.6f} vs {l2c:.6f}")
    check(abs(l0g - l0c) <= 1e-5 * abs(l0c) and abs(l1g - l1c) <= 1e-5 * abs(l1c), f"train parity: loss {l0g} vs {l0c}")
    check(worst <= 1e-3, f"train parity: a gradient differs by {worst} of its largest entry")
    check(abs(l2g - l2c) <= 1e-4 * abs(l2c), f"train parity: second step's loss {l2g} vs {l2c}")


def free_device_memory() -> None:
    """Give the memory of the phases before back to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def lm_parity(cfg, seed: int, batch: dict, flash_launches: int) -> tuple:
    """``cfg`` (float32) on the GPU against the plain CPU path with the same
    weights, carried through the reference's layout as ``phase_model_parity``
    does: logits to 1e-3 of their largest. Returns (GPU model, GPU output,
    CPU output, max |Δ| / max |logit|)."""
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model

    cpu = build_model(cfg, device="cpu", seed=seed)
    tree = params_to_reference(cfg, cpu.state_dict())
    gpu = build_model(cfg, device="cuda", seed=seed + 1)
    gpu.load_state_dict(params_from_reference(cfg, tree))
    cpu.load_state_dict(params_from_reference(cfg, tree))
    del tree
    flash_attention.launches = 0
    with torch.inference_mode():
        got = gpu.apply({k: v.cuda() for k, v in batch.items()})
        want = cpu.apply(batch)
    check(flash_attention.launches == flash_launches,
          f"{cfg.name} parity: {flash_attention.launches} flash launches, expected {flash_launches}")
    got = {k: v.cpu() for k, v in got.items()}
    rel = float((got["logits"] - want["logits"]).abs().max() / want["logits"].abs().max())
    check(bool(torch.isfinite(got["logits"]).all()) and rel <= 1e-3,
          f"{cfg.name} parity: GPU logits differ from the CPU path's by {rel} of the largest")
    return gpu, got, want, rel


def forward_timed(name: str, model, batch: dict, want: dict[str, int]) -> tuple[dict, float, float, dict]:
    """The second of two ``LM.apply`` runs, timed, with the counters set to 0
    just before it and read just after; it must launch ``flash_attention``
    and ``ssd_chunk`` as often as ``want`` says. Returns (output, wall ms,
    peak GB, the launches read)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    with torch.inference_mode():
        model.apply(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = ssd_chunk.launches = 0
        t0 = time.perf_counter()
        out = model.apply(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches}
    check(launches == want, f"{name} forward launches {launches}, expected {want}")
    B, S = batch["tokens"].shape
    check(tuple(out["logits"].shape) == (B, S, model.cfg.vocab_size) and bool(torch.isfinite(out["logits"]).all()),
          f"{name} forward logits {tuple(out['logits'].shape)} not finite or of the wrong shape")
    return out, wall_ms, torch.cuda.max_memory_allocated() / 1e9, launches


def print_profile(name: str, model, batch: dict, wall_ms: float) -> None:
    """One more forward under torch.profiler: device time by kernel group
    against the timed forward's wall, and the ten costliest kernels."""
    groups, top = device_time_by_kernel(model, batch)
    busy = sum(groups.values())
    print(f"{name} forward, device time by kernel group (torch.profiler, one more forward): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; busy {busy:.1f} ms of the {wall_ms:.1f} ms wall (idle share {1 - busy / wall_ms:.3f})")
    for kname, ms, count in top:
        print(f"  {ms:8.2f} ms  {count:5d} launches  {kname}")


def decode_step_profile(name: str, model) -> None:
    """One decode step of 4 requests (after two), timed on the host and split
    by kernel group under torch.profiler (one more step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    token = torch.zeros((4, 1), dtype=torch.int64, device=model.device)
    with torch.inference_mode():
        cache = model.init_cache(4, 128)
        for _ in range(2):
            _, cache = model.decode_step(cache, token)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.decode_step(cache, token)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.decode_step(cache, token)
            torch.cuda.synchronize()
    groups: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            group = kernel_group(e.key.lower())
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    busy = sum(groups.values())
    print(f"{name} one decode step (4 requests): wall {step_ms:.2f} ms; device time by kernel group (torch.profiler, "
          "one more step): " + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; busy {busy:.2f} ms over {launches} kernel launches (idle share {1 - busy / step_ms:.3f})")


MOE = "qwen3-moe-30b-a3b"


def phase_moe_parity(seed: int) -> None:
    """The stable top-K on the card against the CPU's on integer-valued
    probabilities (ties everywhere), then qwen3-moe-30b-a3b at full width, 2
    layers, float32, B = 2 × S = 512 (S ≥ 4·E: one dispatch group per row, the
    expert-major slot layout of the timed paths): the GPU path against the
    plain CPU path with the same weights (logits to 1e-3 of their largest,
    ``expert_load`` exactly equal), then teacher forcing at capacity_factor =
    E/K, as the reference's decode test sets it, so that no token is dropped
    at the forward's group size nor at decode's."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.models import build_model, concrete_inputs
    from repro_torch.models.blocks import top_k_stable
    from repro_torch.serve import DecodeEngine

    cfg = replace(get_arch(MOE), num_layers=2, dtype="float32")
    m = cfg.moe
    probs = torch.from_numpy(np.random.default_rng(seed).integers(0, 4, (4096, m.num_experts)).astype(np.float32))
    want_v, want_i = top_k_stable(probs, m.top_k)
    got_v, got_i = (t.cpu() for t in top_k_stable(probs.cuda(), m.top_k))
    print(f"top_k_stable on the card, (4096, {m.num_experts}) integer-valued probabilities, K={m.top_k}: indices "
          f"equal the CPU's: {torch.equal(got_i, want_i)}, values equal: {torch.equal(got_v, want_v)}")
    check(torch.equal(got_i, want_i) and torch.equal(got_v, want_v), "top_k_stable: the card orders ties otherwise")
    B, S = 2, 512
    check(S >= 4 * m.num_experts, f"{MOE} parity: S={S} would dispatch in one global group")
    tokens = concrete_inputs(cfg, ShapeCfg("parity", S, B, "prefill"), seed=seed, device="cpu")["tokens"]
    gpu, got, want, rel = lm_parity(cfg, seed, {"tokens": tokens}, 2)
    same = torch.equal(got["expert_load"], want["expert_load"])
    aux = abs(float(got["aux_loss"]) - float(want["aux_loss"]))
    print(f"{MOE} full width, 2 layers, float32, B={B} S={S} (a group per row): GPU logits equal the plain CPU path's "
          f"(max |Δ| / max "
          f"|logit| = {rel:.3g}); expert_load equal: {same} (sum {float(got['expert_load'].sum()):.0f}); aux loss "
          f"|Δ| {aux:.3g}")
    check(same, f"{MOE} parity: expert_load differs, GPU {got['expert_load'].tolist()} vs CPU "
                f"{want['expert_load'].tolist()}")
    check(aux <= 1e-5, f"{MOE} parity: aux loss differs by {aux}")
    full = replace(cfg, moe=replace(m, capacity_factor=m.num_experts / m.top_k))
    state = gpu.state_dict()
    del gpu
    model = build_model(full, seed=seed)
    model.load_state_dict(state)
    del state
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    rel = decode_vs_forward(model, DecodeEngine(model, max_len=128), prompts)[2]
    print(f"{MOE} 2 layers, float32, capacity_factor = E/K: decode vs forward logits ‖Δ‖/‖ref‖ {rel:.3g}")
    check(rel <= 1e-3, f"{MOE} teacher forcing: decode logits differ from the forward's by {rel} of their norm")
    del model
    free_device_memory()


def phase_moe_serve(seed: int) -> int:
    """qwen3-moe-30b-a3b at full width and depth, bf16 (30.2 B parameters,
    drawn on the card tensor by tensor): ``LM.apply`` on B = 2 × S = 2048 (48
    flash launches, ``expert_load`` summing to B·S·K·layers), a profile by
    kernel group, then ``DecodeEngine`` answering 4 requests."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.models import build_model, concrete_inputs

    cfg = get_arch(MOE)
    m = cfg.moe
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    torch.cuda.synchronize()
    n_params = model.param_count()
    expert_params = 3 * m.num_experts * cfg.d_model * m.d_ff_expert * cfg.num_layers
    print(f"{MOE}: {n_params / 1e9:.3f} B parameters in {cfg.dtype} ({n_params * 2 / 1e9:.1f} GB; experts "
          f"{expert_params / 1e9:.3f} B), {cfg.num_layers} layers, {m.num_experts} experts top-{m.top_k}; drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    B, S = 2, 2048
    batch = concrete_inputs(cfg, ShapeCfg("prefill_2k", S, B, "prefill"), seed=seed)
    out, wall_ms, peak_gb, launches = forward_timed(MOE, model, batch, {"flash_attention": cfg.num_layers,
                                                                        "ssd_chunk": 0})
    load = out["expert_load"]
    want = B * S * m.top_k * cfg.num_layers
    check(float(load.sum()) == want, f"{MOE} expert_load sums to {float(load.sum())}, expected {want}")
    print(f"{MOE} forward B={B} S={S} bf16: wall {wall_ms:.1f} ms, {B * S / wall_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB, {cfg.num_layers} flash launches; expert_load sums to {float(load.sum()):.0f} "
          f"(min {float(load.min()):.0f}, max {float(load.max()):.0f} over the {m.num_experts} experts, summed over "
          f"layers), aux loss {float(out['aux_loss']):.5f}")
    del out
    print_profile(MOE, model, batch, wall_ms)
    del batch
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    ms_step = served(model, prompts)[1]
    floor_ms = expert_params * 2 / HBM_BYTES_PER_S * 1e3
    print(f"{MOE} DecodeEngine bf16: 4 requests, prompt 64, 32 new tokens, greedy: {ms_step:.2f} ms a step; every "
          f"step reads all {m.num_experts} experts of every layer ({expert_params * 2 / 1e9:.1f} GB): at least "
          f"{floor_ms:.2f} ms a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    decode_step_profile(MOE, model)
    del model
    free_device_memory()
    return launches["flash_attention"]


def phase_moe_train(seed: int) -> int:
    """``make_trainer`` on qwen3-moe-30b-a3b at full width, depth cut to 4
    (full depth would hold ~362 GB of state), bf16 parameters and float32
    moments, B = 2 × S = 2048 of ``make_stream(seed)``, 4 steps, the OCS tick
    every 2 steps on 4 switches and 8 racks: every step's ``expert_load``
    sums to B·S·K·4 and each tick's CCT equals the port's host ``spectra`` on
    the expert-load matrix ``_demand_from_stats`` builds from that step's
    loads. Returns the flash launches of the 4 steps."""
    from repro_torch.configs import get_arch
    from repro_torch.fabric import OCSFabric
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import make_trainer
    from repro_torch.train.loop import _demand_from_stats

    cfg = replace(get_arch(MOE), num_layers=4)
    B, S, steps = 2, 2048, 4
    tr = make_trainer(cfg, steps=steps, batch=B, seq=S, lr=3e-4, seed=seed, ocs_switches=4, ocs_delta_us=20.0,
                      ocs_every=2, log_every=1)
    per_step = []
    step_fn = tr.train_step

    def counted_step(*args):
        flash_attention.launches = 0
        out = step_fn(*args)
        per_step.append((flash_attention.launches, out[2]["expert_load"].cpu()))
        return out

    tr.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.run(seed)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = tr.model.param_count()
    want = B * S * cfg.moe.top_k * cfg.num_layers
    print(f"{MOE} training, 4 layers: {n_params / 1e9:.3f} B parameters in bf16, float32 moments; B={B} S={S}, "
          f"{steps} steps: run {run_s:.1f} s, peak memory {peak_gb:.2f} GB")
    for h, (fl, load) in zip(state.history, per_step):
        print(f"  step {h['step']}: loss {h['loss']:.5f}, wall {h['time_s'] * 1e3:.1f} ms, flash launches {fl}, "
              f"expert_load sum {float(load.sum()):.0f} (min {float(load.min()):.0f}, max {float(load.max()):.0f})")
    check(state.step == steps and len(per_step) == steps, f"final step {state.step}, {len(per_step)} steps run")
    check(all(np.isfinite(h["loss"]) for h in state.history), f"training losses {state.history}")
    check(all(fl == cfg.num_layers for fl, _ in per_step), f"flash launches per step {[f for f, _ in per_step]}")
    check(all(float(load.sum()) == want for _, load in per_step),
          f"expert_load sums {[float(x.sum()) for _, x in per_step]}, expected {want} each")
    walls = [h["time_s"] * 1e3 for h in state.history[1:]]
    wall_ms = float(np.mean(walls))
    print(f"{MOE} train step after the first: wall {wall_ms:.1f} ms (min {min(walls):.1f}, max {max(walls):.1f}), "
          f"{B * S / wall_ms * 1e3:.0f} tokens/s")
    check([r["step"] for r in state.cct_log] == [1, 3], f"cct_log {state.cct_log}")
    ring = _demand_from_stats(8, {}, 0)
    fabric = OCSFabric(num_switches=4, reconfig_delay_s=20e-6)
    for r in state.cct_log:
        D = _demand_from_stats(8, {"expert_load": per_step[r["step"]][1]}, r["step"])
        check(D.shape == ring.shape and not np.allclose(D / D.max(), ring / ring.max()),
              "the tick's matrix is the ring, not the expert all-to-all")
        res, cct = fabric.schedule_bytes(D * 1e9)
        check(r["cct_s"] == cct and r["makespan"] == res.makespan and r["configs"] == res.schedule.num_configs(),
              f"tick {r} differs from host spectra on the expert-load matrix ({cct} s)")
        print(f"  OCS tick after step {r['step']}: expert all-to-all, rack loads {np.round(D.sum(0) / D.sum(), 4).tolist()}"
              f" of the total; CCT {r['cct_s'] * 1e3:.4f} ms (= host spectra), makespan {r['makespan']:.6f}, LB "
              f"{r['lb']:.6f}, {r['configs']} circuits")
    launches = sum(fl for fl, _ in per_step)
    del tr, state, per_step
    free_device_memory()
    return launches


def mrope_grid(B: int, S: int, side: int) -> torch.Tensor:
    """Qwen2-VL's (t, h, w) M-RoPE positions for one image of side × side
    merged patches at the start of each row, then text: patch (row, col)
    takes (0, row, col); text token i after the image takes side + i in all
    three streams."""
    p = torch.arange(S)
    n = side * side
    t = torch.where(p < n, 0, p - n + side)
    h = torch.where(p < n, p // side, t)
    w = torch.where(p < n, p % side, t)
    return torch.stack([t, h, w], -1)[None].expand(B, S, 3).contiguous()


def vlm_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """A 448 × 448 image, 14-pixel patches merged 2 × 2 (a 16 × 16 grid, 256
    embeddings), then text; positions from ``mrope_grid``."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.models import concrete_inputs

    batch = concrete_inputs(cfg, ShapeCfg("vlm", S, B, "prefill"), seed=seed, device=device)
    check(batch["patch_embeds"].shape[1] == 256, f"patch_embeds {tuple(batch['patch_embeds'].shape)}")
    batch["positions"] = mrope_grid(B, S, 16).to(device)
    return batch


def phase_vlm(seed: int) -> int:
    """qwen2-vl-2b: float32 parity with the CPU path at full width and 2 layers
    (B = 1 × S = 320: the image and 64 text tokens), teacher forcing on a
    text-only batch there; then full width and depth in bf16, B = 2 × S =
    4096 (28 flash launches), and ``DecodeEngine`` answering 4 requests."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine

    name = "qwen2-vl-2b"
    cfg = get_arch(name)
    small = replace(cfg, num_layers=2, dtype="float32")
    gpu, _, _, rel = lm_parity(small, seed, vlm_batch(small, 1, 320, seed, "cpu"), 2)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    rel_tf = decode_vs_forward(gpu, DecodeEngine(gpu, max_len=128), prompts)[2]
    print(f"{name} full width, 2 layers, float32, B=1 S=320 (16 × 16 patch grid + 64 text tokens): GPU logits equal "
          f"the plain CPU path's (max |Δ| / max |logit| = {rel:.3g}); text-only decode vs forward ‖Δ‖/‖ref‖ "
          f"{rel_tf:.3g}")
    check(rel_tf <= 1e-3, f"{name} teacher forcing: decode logits differ from the forward's by {rel_tf}")
    del gpu
    free_device_memory()

    model = build_model(cfg, seed=seed)
    B, S = 2, 4096
    batch = vlm_batch(cfg, B, S, seed, "cuda")
    out, wall_ms, peak_gb, launches = forward_timed(name, model, batch, {"flash_attention": cfg.num_layers,
                                                                         "ssd_chunk": 0})
    del out
    print(f"{name}: {model.param_count() / 1e9:.3f} B parameters in {cfg.dtype}; forward B={B} S={S} (256 patch "
          f"embeddings + text, M-RoPE grid positions): wall {wall_ms:.1f} ms, {B * S / wall_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB, {cfg.num_layers} flash launches")
    print_profile(name, model, batch, wall_ms)
    ms_step = served(model, prompts)[1]
    print(f"{name} DecodeEngine bf16: 4 requests, prompt 64, 32 new tokens, greedy: {ms_step:.2f} ms a step")
    del model, batch
    free_device_memory()
    return launches["flash_attention"]


def phase_whisper(seed: int) -> int:
    """whisper-tiny at full width and depth: B = 4, 1500 frames (30 s of audio
    after the stubbed conv front end), 448 decoder tokens. Float32 parity with
    the CPU path, decode with ``enc_out`` teacher-forced against the float32
    forward to 1e-3; then the bf16 forward (12 flash launches: 4 encoder, 4
    self, 4 cross) and ``DecodeEngine`` answering 4 requests."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine

    name = "whisper-tiny"
    cfg = get_arch(name)
    B, S, S_enc = 4, 448, 1500
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    frames = torch.from_numpy(rng.standard_normal((B, S_enc, cfg.d_model), dtype=np.float32) * np.float32(0.02))
    f32 = replace(cfg, dtype="float32")
    launches = cfg.encoder_layers + 2 * cfg.num_layers  # encoder self, decoder self and cross
    gpu, _, _, rel = lm_parity(f32, seed, {"tokens": tokens, "frames": frames}, launches)
    prompts = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    frames4 = frames[:4].cuda()
    with torch.inference_mode():
        enc_out = gpu.encode(frames4)
    rel_tf = decode_vs_forward(gpu, DecodeEngine(gpu, max_len=128), prompts, {"frames": frames4}, enc_out)[2]
    print(f"{name} full width and depth, float32, B={B}, {S_enc} frames, {S} tokens: GPU logits equal the plain CPU "
          f"path's (max |Δ| / max |logit| = {rel:.3g}); decode with enc_out vs forward ‖Δ‖/‖ref‖ {rel_tf:.3g}")
    check(rel_tf <= 1e-3, f"{name} teacher forcing: decode logits differ from the forward's by {rel_tf}")
    del gpu, enc_out
    free_device_memory()

    model = build_model(cfg, seed=seed)
    batch = {"tokens": tokens.cuda(), "frames": frames.cuda()}
    out, wall_ms, peak_gb, read = forward_timed(name, model, batch, {"flash_attention": launches, "ssd_chunk": 0})
    del out
    print(f"{name}: {model.param_count() / 1e6:.1f} M parameters in {cfg.dtype}; forward B={B}, {S_enc} frames, "
          f"{S} tokens: wall {wall_ms:.1f} ms, {B * S / wall_ms * 1e3:.0f} decoder tokens/s, peak memory "
          f"{peak_gb:.2f} GB, {launches} flash launches")
    with torch.inference_mode():
        enc_out = model.encode(frames4.to(torch.bfloat16))
    ms_step = served(model, prompts, {"frames": frames4.to(torch.bfloat16)}, enc_out)[1]
    print(f"{name} DecodeEngine bf16 with enc_out: 4 requests, prompt 64, 32 new tokens, greedy: {ms_step:.2f} ms a step")
    del model, batch, enc_out
    free_device_memory()
    return read["flash_attention"]


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


def fused_split(Ds) -> tuple[float, float, int]:
    """One more run of a bucket with CUDA events around every
    ``auction_fused`` call the matcher makes: (wall ms, the calls' ms, calls)."""
    import repro_torch.core.torchopt.matching as matching
    from repro_torch.api import solve_many

    real, events = matching.fused_auction, []

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    matching.fused_auction = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_many(Ds, 4, 0.01, solver="spectra_torch")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        matching.fused_auction = real
    return wall_ms, sum(s.elapsed_time(e) for s, e in events), len(events)


def phase_main_path(seed: int) -> dict:
    from repro_torch.api import SolveOptions, solve_many
    from repro_torch.kernels.auction_bid import auction_rounds, decompose_rounds, masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction, polish_2swap

    launches = {"auction_bid": 0, "auction_rounds": 0, "decompose_rounds": 0, "auction_fused": 0,
                "auction_fused_cluster": 0, "polish_2swap": 0}
    for i, (name, matcher, Ds) in enumerate(buckets(seed)):
        if i == 0:
            solve_many(Ds, 4, 0.01, solver="spectra_torch")  # warm-up (first use of every piece)
        zero_auction_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = solve_many(Ds, 4, 0.01, solver="spectra_torch")
        wall_ms = (time.perf_counter() - t0) * 1e3
        bid, rounds_l, fused = masked_row_top2.launches, auction_rounds.launches, fused_auction.launches
        dec_l = decompose_rounds.launches
        cluster = fused_auction.cluster_launches
        launches["auction_bid"] += bid
        launches["auction_rounds"] += rounds_l
        launches["decompose_rounds"] += dec_l
        launches["auction_fused"] += fused
        launches["auction_fused_cluster"] += cluster
        launches["polish_2swap"] += polish_2swap.launches
        for b, rep in enumerate(reports):
            check(rep.validated, f"{name}[{b}] not validated")
            check(rep.extras["matcher"] == matcher, f"{name}[{b}] used {rep.extras['matcher']}, expected {matcher}")
            check(rep.extras["converged"], f"{name}[{b}] matcher did not converge")
            check(not rep.extras["eq_exhausted"], f"{name}[{b}] EQUALIZE ran out of slots")
            check(np.isfinite(rep.makespan) and rep.makespan >= rep.lower_bound * (1 - 1e-6),
                  f"{name}[{b}] makespan {rep.makespan} below its lower bound {rep.lower_bound}")
        got = (bid, rounds_l, dec_l, fused)
        if matcher == "auction_fused":
            check(fused > 0 and cluster == fused and bid == 0 and rounds_l == 0 and dec_l == 0
                  and polish_2swap.launches == fused,
                  f"{name}: expected launches of the cluster auction_fused kernel only, each with one polish_2swap, "
                  f"got bid/rounds/decompose/fused {got}, of which cluster {cluster}, polish {polish_2swap.launches}")
        else:
            check(dec_l > 0 and rounds_l == 0 and bid == 0 and fused == 0,
                  f"{name}: expected decompose_rounds launches only, got bid/rounds/decompose/fused {got}")
        rounds = sum(r.extras["bidding_rounds"] for r in reports)
        ratio = float(np.mean([r.makespan / r.lower_bound for r in reports]))
        print(f"bucket {name} B={len(Ds)} n={Ds.shape[-1]} matcher={matcher}: wall {wall_ms:.1f} ms, "
              f"bidding rounds {rounds}, launches bid={bid} rounds={rounds_l} decompose={dec_l} fused={fused} "
              f"(cluster kernel {cluster}), mean makespan/LB {ratio:.4f}")
        if matcher == "auction_fused":
            split_wall, split_fused, calls = fused_split(Ds)
            print(f"bucket {name}, one more run split by CUDA events: wall {split_wall:.1f} ms, auction_fused "
                  f"{split_fused:.1f} ms over {calls} calls, the rest {split_wall - split_fused:.1f} ms")
        if name == "gpt":
            cpu = solve_many(Ds, 4, 0.01, solver="spectra_torch", options=SolveOptions(extra={"device": "cpu"}))
            rel = [abs(g.makespan - c.makespan) / c.makespan for g, c in zip(reports, cpu)]
            check(max(rel) <= 1e-4, f"gpt: GPU makespans differ from the plain CPU path by {rel}")
            exact = all(g.makespan == c.makespan for g, c in zip(reports, cpu))
            print(f"bucket gpt: GPU makespans agree with the plain CPU path (max relative difference {max(rel):.3g}, "
                  f"all equal: {exact}; bidding rounds {rounds} on the GPU, "
                  f"{sum(r.extras['bidding_rounds'] for r in cpu)} on the CPU)")
    return launches


def _bit_equal(a, b) -> bool:
    """Two lists of reports with the same decompositions and makespans, bit for bit."""
    return all(
        x.makespan == y.makespan and len(x.decomposition.perms) == len(y.decomposition.perms)
        and all(np.array_equal(p, q) for p, q in zip(x.decomposition.perms, y.decomposition.perms))
        and x.decomposition.alphas == y.decomposition.alphas
        for x, y in zip(a, b)
    )


def phase_matcher_api(seed: int) -> tuple[dict, dict]:
    """The matcher registry and the default-matcher policy on the card, on the
    gpt (n = 32) and moe (n = 64) buckets at B = 8. ``"auction2"``, registered
    as ``match_auction``, must equal ``"auction"`` bit for bit with the same
    ``decompose_rounds`` launches (the same function: the one-launch loop).
    Under ``set_default_matcher_policy(lambda n: "auction_fused")`` with no
    matcher named: ``solve_many`` reports ``auction_fused``, launches it and
    no n ≤ 128 round kernel, and agrees with
    the same call naming the matcher to 1e-4; ``run_scenario("gpt", ...,
    online=True)`` launches it and its online/stateless equals the run naming
    the matcher to 1e-4; a ``SolverService`` flush reports it. After
    ``set_default_matcher_policy(None)`` the gpt bucket launches
    ``decompose_rounds`` again. Returns the phase's launches (counters set to 0
    before each call and summed after it) and the printed numbers."""
    from repro_torch.api import SolveOptions, solve_many
    from repro_torch.core.torchopt import MATCHERS, match_auction, register_matcher, set_default_matcher_policy
    from repro_torch.scenarios import run_scenario
    from repro_torch.serve import SolverService

    total: dict = {}

    def drive(fn):
        zero_kernel_counters()
        out = fn()
        launches = kernel_counters()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out, launches

    def solve(Ds, matcher=None):
        extra = {} if matcher is None else {"matcher": matcher}
        return drive(lambda: solve_many(Ds, 4, 0.01, solver="spectra_torch", options=SolveOptions(extra=extra)))

    t0 = time.perf_counter()
    info: dict = {"registered": {}, "policy": {}}
    picked = {name: Ds for name, _, Ds in buckets(seed)[:2]}
    register_matcher("auction2", match_auction)
    try:
        for name, Ds in picked.items():
            (a, la), (b, lb) = solve(Ds, "auction"), solve(Ds, "auction2")
            same = _bit_equal(a, b)
            check(same and all(r.extras["matcher"] == "auction2" for r in b),
                  f"matcher_api {name}: auction2 differs from auction")
            check(la["decompose_rounds"] > 0 and la == lb,
                  f"matcher_api {name}: launches auction {la}, auction2 {lb}")
            info["registered"][name] = dict(bit_equal=same, decompose_rounds=lb["decompose_rounds"])
            print(f"matcher_api {name}: auction2 equals auction bit for bit: {same}; decompose_rounds launches "
                  f"{la['decompose_rounds']} and {lb['decompose_rounds']}")

        set_default_matcher_policy(lambda n: "auction_fused")
        for name, Ds in picked.items():
            got, lp = solve(Ds)
            named, _ = solve(Ds, "auction_fused")
            check(all(r.extras["matcher"] == "auction_fused" and r.validated and r.extras["converged"] for r in got),
                  f"matcher_api {name}: under the policy the reports read {[r.extras['matcher'] for r in got]}")
            check(lp["auction_fused"] > 0 and round_kernels(lp) == 0 and lp["auction_bid"] == 0,
                  f"matcher_api {name}: launches under the policy {lp}")
            rel = max(abs(g.makespan - w.makespan) / w.makespan for g, w in zip(got, named))
            check(rel <= 1e-4, f"matcher_api {name}: policy vs named auction_fused makespans differ by {rel}")
            same = _bit_equal(got, named)
            info["policy"][name] = dict(auction_fused=lp["auction_fused"], auction_rounds=lp["auction_rounds"],
                                        max_rel=rel, bit_equal=same)
            print(f"matcher_api {name}: under the policy auction_fused launches {lp['auction_fused']} (cluster "
                  f"{lp['auction_fused_cluster']}), auction_rounds {lp['auction_rounds']}; makespans against the "
                  f"matcher named: max relative difference {rel:.3g}, bit-equal: {same}")

        rep, ls = drive(lambda: run_scenario("gpt", solver="spectra_torch", online=True))
        check(ls["auction_fused"] > 0 and round_kernels(ls) == 0,
              f"matcher_api: run_scenario under the policy launched {ls}")
        ref, _ = drive(lambda: run_scenario("gpt", solver="spectra_torch", online=True,
                                            options=SolveOptions(extra={"matcher": "auction_fused"})))
        ratio = [r.online_summary()["online_total_makespan"] / r.online_summary()["stateless_total_makespan"]
                 for r in (rep, ref)]
        check(abs(ratio[0] - ratio[1]) <= 1e-4 * ratio[1],
              f"matcher_api: run_scenario online/stateless {ratio[0]} under the policy, {ratio[1]} named")
        info["scenario"] = dict(auction_fused=ls["auction_fused"], online_over_stateless=ratio[0],
                                named=ratio[1])
        print(f"matcher_api run_scenario gpt online: auction_fused launches {ls['auction_fused']}, auction_rounds "
              f"{ls['auction_rounds']}; online/stateless {ratio[0]:.6f} under the policy, {ratio[1]:.6f} named")

        svc = SolverService(4, 0.01, solver="spectra_torch")
        svc.submit_trace(picked["gpt"])
        reports, lv = drive(svc.flush)
        check(all(r.extras["matcher"] == "auction_fused" for r in reports.values()) and lv["auction_fused"] > 0,
              f"matcher_api: the SolverService flush reported {[r.extras['matcher'] for r in reports.values()]}, "
              f"launches {lv}")
        info["service_matcher"] = "auction_fused"

        set_default_matcher_policy(None)
        after, lr = solve(picked["gpt"])
        check(all(r.extras["matcher"] == "auction" for r in after) and lr["decompose_rounds"] > 0
              and lr["auction_fused"] == 0, f"matcher_api: after the reset the gpt bucket launched {lr}")
        info["reset_decompose_rounds"] = lr["decompose_rounds"]
    finally:
        set_default_matcher_policy(None)
        MATCHERS.pop("auction2", None)
    info["seconds"] = time.perf_counter() - t0
    print(f"matcher_api: service flush reports auction_fused; after the reset decompose_rounds launches "
          f"{lr['decompose_rounds']}; {info['seconds']:.1f} s")
    return total, info


# Fig. 2's worked example (.claude/skills/verify/SKILL.md: spectra gives 0.5300).
FIG2 = np.array([
    [0.60, 0.30, 0.00, 0.10],
    [0.00, 0.61, 0.39, 0.00],
    [0.00, 0.09, 0.61, 0.30],
    [0.40, 0.00, 0.00, 0.60],
])
PAPER_DELTAS = [1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1]  # the δ grid of benchmarks/common.py


def geomean(xs) -> float:
    """Geometric mean: the "average" ratio the paper's figures report."""
    return float(np.exp(np.mean(np.log(xs))))


def phase_matchers_above_128(rng) -> list[dict]:
    """``match_auction`` and ``match_auction_fr`` above n = 128, where a call
    is the round loop with one ``masked_row_top2`` launch a round: at
    (B, n) = (2, 160) on permutations + M-bonus weights and (2, 256) on
    uniform weights, on the card and on the CPU's plain path, bit for bit in
    perm, converged, prices and rounds. Prints the rounds, the launches and
    the wall a call (host clock, synchronised)."""
    from repro_torch.core.torchopt.matching import MatchResult, match_auction, match_auction_fr
    from repro_torch.kernels.auction_bid import masked_row_top2
    from repro_torch.traffic import permutations_workload

    rows = []
    for B, n, kind in ((2, 160, "bonus"), (2, 256, "uniform")):
        if kind == "bonus":
            D = np.stack([permutations_workload(n=n, k=16, rng=rng) for _ in range(B)])
            W = bonus_weights(torch.from_numpy(D.astype(np.float32)))
        else:
            W = torch.from_numpy(rng.random((B, n, n), dtype=np.float32))
        Wd = W.cuda()
        for match in (match_auction, match_auction_fr):
            before = masked_row_top2.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = match(Wd)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = masked_row_top2.launches - before
            t0 = time.perf_counter()
            want = match(W)
            cpu_s = time.perf_counter() - t0
            for field, g, w in zip(MatchResult._fields, got, want):
                check(torch.equal(g.cpu(), w), f"{match.__name__} B={B} n={n} {kind}: {field} on the card differs "
                                               f"from the CPU's plain path")
            rounds = got.rounds.tolist()
            check(bool(got.converged.all()) and launches >= max(rounds) > 0,
                  f"{match.__name__} B={B} n={n}: converged {got.converged.tolist()}, rounds {rounds}, "
                  f"masked_row_top2 launches {launches}")
            rows.append(dict(matcher=match.__name__, shape=[B, n, n], weights=kind, rounds=rounds,
                             launches=launches, wall_ms=wall_ms, cpu_s=cpu_s))
            print(f"{match.__name__} B={B} n={n} ({kind} weights): card == CPU plain path exactly (perm, converged, "
                  f"prices, rounds); rounds {rounds}, masked_row_top2 launches {launches}, wall {wall_ms:.1f} ms "
                  f"({wall_ms * 1e3 / max(launches, 1):.1f} us a launch); CPU {cpu_s:.1f} s")
    return rows


def phase_solver_layer(seed: int) -> dict:
    """The solver layer of the port on the card, through the API a user calls:

    1. Fig. 2 through every registered solver (``solve_all``; ``spectra_torch``
       on the card): every covering schedule replayed by
       ``fabric.simulator.simulate`` serves the demand (``rotor_vlb`` covers
       only under indirection and is skipped, as in the reference), and
       ``spectra`` gives 0.5300.
    2. The paper's comparison on gpt n=32, moe n=64 and benchmark n=100 (one
       seed), s ∈ {2, 4}, the seven δs of ``benchmarks/common.py``: columns
       ``spectra``, ``spectra_torch`` (card), ``Pipeline(decompose=
       "torch_auction", equalize="torch")`` (card), ``spectra_eclipse``,
       ``baseline_less``, ``spectra_pp`` and the §IV bound, and the
       geometric-mean ratios of Fig. 6 / Fig. 9. Every device-stage report
       must equal the same pipeline on the CPU's plain path to 1e-4 relative;
       the CPU side computes each matrix's decomposition once (it depends on
       D alone, through a registered stage) and reruns SCHEDULE and EQUALIZE
       per cell.
    3. ``torch_auction`` at n = 256 and 512 with its default
       ``matcher="auction"``: one ``auction_rounds`` launch a matcher call,
       no ``masked_row_top2``.
    4. ``torch_auction`` at n = 512 with ``matcher="auction_fused"``.
    5. The permutations bucket (n = 512, B = 4) through ``solve_many`` under
       the tracer with ``device_sync``: span totals by name, and the Chrome
       trace written to the temp dir.

    The kernels' launch counters are set to 0 just before and read just
    after; every auction kernel must have launched. Host solvers run on the
    card machine's CPU."""
    import tempfile

    from repro_torch.api import Pipeline, Problem, SolveOptions, list_solvers, register_stage, solve, solve_all
    from repro_torch.api import solve_many
    from repro_torch.api.pipeline import DECOMPOSERS
    from repro_torch.core.lower_bounds import lower_bound
    from repro_torch.fabric import simulate
    from repro_torch.kernels.auction_bid import auction_rounds, masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction
    from repro_torch.obs import get_tracer
    from repro_torch.traffic import benchmark_workload, gpt3b_workload, moe_workload, permutations_workload

    cpu = SolveOptions(extra={"device": "cpu"})
    device_pipe = Pipeline(decompose="torch_auction", equalize="torch")
    cpu_decs: dict[bytes, object] = {}

    def memo_decompose(problem, **kw):  # the CPU's torch_auction, once a matrix
        key = np.ascontiguousarray(problem.D).tobytes()
        if key not in cpu_decs:
            cpu_decs[key] = DECOMPOSERS["torch_auction"](problem, **kw)
        return cpu_decs[key]

    register_stage("decompose", "torch_auction_cpu_once", memo_decompose, overwrite=True)
    cpu_pipe = Pipeline(decompose="torch_auction_cpu_once", equalize="torch")

    zero_auction_counters()
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    reports = solve_all(Problem(FIG2, 2, 0.01))
    check(sorted(reports) == list_solvers(), f"solve_all gave {sorted(reports)}")
    for name, rep in reports.items():
        if name == "rotor_vlb":
            check(not rep.validated, "rotor_vlb validated against Eq. 3")
            continue
        sim = simulate(rep, FIG2, tol=SolveOptions().tol(rep.backend))
        check(rep.validated and sim.demand_met and abs(sim.finish_time - rep.makespan) <= 1e-6,
              f"Fig. 2 {name}: simulated finish {sim.finish_time} vs makespan {rep.makespan}, served {sim.demand_met}")
    check(abs(reports["spectra"].makespan - 0.53) <= 5e-5, f"Fig. 2 spectra makespan {reports['spectra'].makespan}")
    print("Fig. 2 (s=2, δ=0.01) through every solver, simulated: " + ", ".join(
        f"{name} {rep.makespan:.4f} ({rep.num_configs} configs, {rep.backend})" for name, rep in reports.items())
        + f"; LB {reports['spectra'].lower_bound:.4f} ({(time.perf_counter() - t0) * 1e3:.0f} ms)")

    columns = ("spectra", "spectra_torch", "torch_pipeline", "spectra_eclipse", "baseline_less", "spectra_pp")
    mats = {"gpt": gpt3b_workload(rng=np.random.default_rng(seed)),
            "moe": moe_workload(rng=np.random.default_rng(seed)),
            "benchmark": benchmark_workload(rng=np.random.default_rng(seed))}
    no_lb = SolveOptions(compute_lb=False)
    ratios, walls = {}, {c: 0.0 for c in (*columns, "cpu_check")}
    worst = 0.0
    for wname, D in mats.items():
        rows = []
        for s in (2, 4):
            for delta in PAPER_DELTAS:
                problem = Problem(D, s, delta)
                row = {"lb": lower_bound(D, s, delta)}
                for col in columns:
                    t0 = time.perf_counter()
                    rep = device_pipe(problem, no_lb) if col == "torch_pipeline" else solve(problem, solver=col,
                                                                                          options=no_lb)
                    if col in ("spectra_torch", "torch_pipeline"):
                        torch.cuda.synchronize()
                        check(rep.backend == "torch", f"{col} ran on {rep.backend}")
                    walls[col] += time.perf_counter() - t0
                    check(rep.validated, f"{wname} s={s} δ={delta} {col} not validated")
                    row[col] = rep.makespan
                t0 = time.perf_counter()
                want = cpu_pipe(problem, SolveOptions(compute_lb=False, extra={"device": "cpu"})).makespan
                walls["cpu_check"] += time.perf_counter() - t0
                rel = abs(row["torch_pipeline"] - want) / want
                worst = max(worst, rel)
                check(rel <= 1e-4, f"{wname} s={s} δ={delta}: torch_auction → torch on the card {row['torch_pipeline']}"
                                   f" vs the CPU's {want}")
                rows.append(row)
        ratios[wname] = {
            "baseline/spectra": geomean([r["baseline_less"] / r["spectra"] for r in rows]),
            "eclipse/spectra": geomean([r["spectra_eclipse"] / r["spectra"] for r in rows]),
            "spectra/lb": geomean([r["spectra"] / r["lb"] for r in rows]),
            "spectra_torch/spectra": geomean([r["spectra_torch"] / r["spectra"] for r in rows]),
            "torch_pipeline/spectra": geomean([r["torch_pipeline"] / r["spectra"] for r in rows]),
            "spectra_pp/spectra": geomean([r["spectra_pp"] / r["spectra"] for r in rows]),
        }
        print(f"paper comparison {wname} n={D.shape[0]} (s in (2, 4), {len(PAPER_DELTAS)} deltas, seed {seed}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ratios[wname].items()))
    cells = len(mats) * 2 * len(PAPER_DELTAS)
    print(f"paper comparison: {cells} cells; walls summed over them (host clock; host solvers on this machine's CPU): "
          + ", ".join(f"{c} {walls[c]:.2f} s" for c in columns)
          + f"; CPU check of the device stages {walls['cpu_check']:.2f} s (decompositions once a matrix); "
          f"device pipeline vs CPU max relative difference {worst:.3g}")

    D256 = permutations_workload(n=256, k=4, rng=np.random.default_rng(seed))
    before = masked_row_top2.launches, auction_rounds.launches, fused_auction.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep256 = device_pipe(Problem(D256, 4, 0.01))
    torch.cuda.synchronize()
    wall256 = (time.perf_counter() - t0) * 1e3
    got = (masked_row_top2.launches - before[0], auction_rounds.launches - before[1],
           fused_auction.launches - before[2])
    sim = simulate(rep256, D256, tol=1e-4)
    check(got[0] > 0 and got[1:] == (0, 0) and rep256.validated and sim.demand_met,
          f"torch_auction n=256: launches bid/rounds/fused {got}, validated {rep256.validated}, served {sim.demand_met}")
    host256 = solve(Problem(D256, 4, 0.01), solver="spectra")
    print(f"torch_auction (matcher auction) -> torch, permutations n=256 k=4: wall {wall256:.1f} ms, masked_row_top2 "
          f"launches {got[0]}, k={rep256.decomposition.k}, makespan {rep256.makespan:.6f} (host spectra "
          f"{host256.makespan:.6f}, LB {rep256.lower_bound:.6f}), simulated")

    D512 = permutations_workload(n=512, k=16, rng=np.random.default_rng(seed))
    before = masked_row_top2.launches, fused_auction.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep512 = Pipeline(decompose="torch_auction", decompose_kwargs={"matcher": "auction_fused"},
                      equalize="torch")(Problem(D512, 4, 0.01))
    torch.cuda.synchronize()
    wall512 = (time.perf_counter() - t0) * 1e3
    fused512 = fused_auction.launches - before[1]
    sim = simulate(rep512, D512, tol=1e-4)
    check(fused512 > 0 and masked_row_top2.launches == before[0] and rep512.validated and sim.demand_met,
          f"torch_auction n=512 auction_fused: fused launches {fused512}, served {sim.demand_met}")
    print(f"torch_auction (matcher auction_fused) -> torch, permutations n=512 k=16: wall {wall512:.1f} ms, "
          f"auction_fused launches {fused512}, k={rep512.decomposition.k}, makespan {rep512.makespan:.6f} "
          f"(LB {rep512.lower_bound:.6f}), simulated")

    Ds = buckets(seed)[-1][2]
    tracer = get_tracer()
    tracer.reset()
    tracer.enable(device_sync=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traced = solve_many(Ds, 4, 0.01)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3
    finally:
        tracer.disable()
    check(all(r.validated for r in traced), "traced bucket: a report did not validate")
    totals: dict[str, float] = {}
    for ev in tracer.spans():
        totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration * 1e3
    check(set(totals) == {"solve_many", "bucket", "torch.dispatch", "torch.collect", "e2e.decompose", "e2e.lpt",
                          "e2e.equalize", "e2e.bound"}, f"spans {sorted(totals)}")
    trace_path = tracer.save(Path(tempfile.gettempdir()) / "repro_torch_solver_trace.json")
    tracer.reset()
    print(f"traced permutations bucket n=512 B={len(Ds)} (device_sync): wall {traced_wall:.1f} ms; span totals "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in totals.items()) + f"; Chrome trace {trace_path}")

    launches = auction_counters()
    check(all(launches[k] > 0 for k in ("auction_bid", "auction_rounds", "decompose_rounds", "auction_fused",
                                        "polish_2swap")), f"solver layer launches {launches}")
    print(f"solver layer: {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return dict(launches=launches, ratios=ratios, walls_s=walls, worst_rel=worst, wall256_ms=wall256,
                wall512_ms=wall512, traced_wall_ms=traced_wall, span_ms=totals)


ONLINE_SCENARIOS = ("gpt", "moe", "benchmark", "moe_phases", "uniform", "benchmark_large", "permutations_large")
ONLINE_CPU = ("gpt", "moe", "benchmark", "moe_phases", "uniform")  # n <= 100: held against the plain CPU path
ONLINE_FIELDS = ("warm", "cache_hit", "k", "reuse_count", "makespan", "stateless_makespan")
SESSIONS = (("gpt", 32), ("moe_phases", 64))  # the serving phase's session tenants: (scenario, n)
SESSION_PERIODS = 6
SESSION_FIELDS = ("warm", "cache_hit", "k", "reuse_count")
# The flow replay's FCT quantiles and the attribution shares of both passes,
# held card against CPU on the n <= 100 scenarios.
FLOW_KEYS = ("fct_p50", "fct_p99", "transmission_share", "delta_share", "idle_share",
             "online_transmission_share", "online_delta_share", "online_idle_share")


def flow_numbers(rep) -> dict:
    """FCT p50 / p99 of a ``flowsim=True`` run and its attribution shares."""
    fs, att = rep.flowsim_summary(), rep.attribution_summary()
    return {k: float(fs[k] if k.startswith("fct") else att[k]) for k in FLOW_KEYS}


def run_sessions(options):
    """A ``SessionManager`` on ``spectra_online_torch`` serving two tenants
    (``SESSIONS``, ``SESSION_PERIODS`` periods each, submitted up front and
    drained fairly). Returns the manager and its ``(tenant, report)`` list."""
    from repro_torch.scenarios import make_trace
    from repro_torch.serve import SessionManager

    mgr = SessionManager(4, 0.01, solver="spectra_online_torch", options=options)
    for name, n in SESSIONS:
        for D in make_trace(name, n=n, periods=SESSION_PERIODS).normalized()[0]:
            mgr.submit(name, D)
    return mgr, mgr.drain()


def cpu_scenario(name: str) -> dict:
    """One ``ONLINE_CPU`` scenario on the plain CPU path: ``run_scenario(name,
    solver="spectra_torch", online=True, flowsim=True)``, its scan's
    decisions and makespans, FCT quantiles and attribution shares; or, for
    ``name="sessions"``, the sessions' decisions."""
    import repro_torch.core.torchopt.online_torch as online_torch
    from repro_torch.api import SolveOptions
    from repro_torch.scenarios import run_scenario

    torch.set_num_threads(1)
    cpu = SolveOptions(extra={"device": "cpu"})
    out, scanned = {}, {}
    t0 = time.perf_counter()
    if name == "sessions":
        _, served = run_sessions(cpu)
        for tenant, _ in SESSIONS:
            for f in SESSION_FIELDS:
                out[f"session.{tenant}.{f}"] = np.array([r.extras[f] for t, r in served if t == tenant])
        out["session.seconds"] = np.float64(time.perf_counter() - t0)
        return out
    real_scan = online_torch.spectra_online_scan

    def capture(*args, **kw):
        res, fin = real_scan(*args, **kw)
        scanned["res"] = res
        return res, fin

    online_torch.spectra_online_scan = capture
    try:
        rep = run_scenario(name, solver="spectra_torch", online=True, flowsim=True, options=cpu)
    finally:
        online_torch.spectra_online_scan = real_scan
    for f in ONLINE_FIELDS:
        out[f"{name}.{f}"] = getattr(scanned["res"], f)[0].numpy()
    for k, v in flow_numbers(rep).items():
        out[f"{name}.{k}"] = np.float64(v)
    out[f"{name}.seconds"] = np.float64(time.perf_counter() - t0)
    return out


def cpu_online(out_path: str) -> None:
    """``--cpu-online OUT``: ``cpu_scenario`` of each ``ONLINE_CPU`` scenario
    and of the sessions, in three worker processes (the two slow scenarios,
    moe and benchmark, one each), saved to OUT (.npz). ``main`` runs this in
    a child process while the card works."""
    import multiprocessing as mp

    jobs = sorted(ONLINE_CPU + ("sessions",), key=lambda j: j not in ("moe", "benchmark"))
    out = {}
    with mp.get_context("spawn").Pool(3) as pool:
        for part in pool.imap_unordered(cpu_scenario, jobs):
            out.update(part)
    np.savez(out_path, **out)


def phase_online(rng, cpu_child, cpu_path: str) -> dict:
    """The online controller and the scenario runner on the card.

    1. ``auction_rounds`` with a non-zero ``prices0`` (the final prices of a
       previous call on the same instance family: the M-bonus scale) against
       ``auction_rounds_ref``, bit for bit, forward and forward-reverse, at
       n = 32, 64 and 100; ``prices0=None`` equal to a zeros ``prices0``.
    2. ``run_scenario(name, solver="spectra_torch", online=True,
       simulate=True, flowsim=True)`` on the seven scenarios at their
       registered n, s, δ and period count, the support cache at its default
       of 8, counting the scan's host reads; then moe and permutations_large
       again with ``warm_prices=True``. Counters set to 0 just before each
       run and read just after. Every online period must be at most its
       stateless period and replay to ``demand_met`` from the carried state;
       gpt and moe must reuse configurations and avoid δ; the warm runs must
       launch ``decompose_rounds`` (moe: the prices carried inside it) and
       enter ``auction_fused``'s ε schedule at its tail. Every run must pass
       ``attribution_summary()`` (the identity at 1e-4 on every period of
       both passes) with no solver warnings, and every period's flow replay
       must deliver every flow in full (per flow and in aggregate, to 1e-4)
       and finish when ``fabric.simulate`` does (1e-4); ``summary()`` must
       carry ``warnings`` and the flow keys. The flow replay's host time is
       timed a period.
    3. CUDA events around the period's sequential loops at n = 512: the warm
       REFINE over k rounds and over all n, and the LPT loop.
    4. The card's scan on the n <= 100 scenarios against the plain CPU path's
       (``cpu_online``, run in ``cpu_child`` meanwhile): ``warm``,
       ``cache_hit``, ``k`` and ``reuse_count`` exact, the makespans to 1e-4;
       the FCT p50 / p99 and the attribution shares to 1e-4 relative (with
       an absolute floor of 1e-6 for shares below 1e-2: an idle share is
       float32 noise around 0).
    """
    import repro_torch.core.torchopt.online_torch as online_torch
    import repro_torch.flowsim as flowsim
    from repro_torch.api import SolveOptions
    from repro_torch.core.torchopt.matching import (_eps_schedule, default_max_iters, default_num_phases,
                                                    match_auction_fused)
    from repro_torch.fabric import simulate
    from repro_torch.kernels.auction_bid import auction_rounds, auction_rounds_ref, decompose_rounds
    from repro_torch.scenarios import get_scenario, run_scenario
    from repro_torch.traffic import benchmark_workload, gpt3b_workload, moe_workload

    dev = "cuda"
    makers = {32: lambda r: gpt3b_workload(rng=r), 64: lambda r: moe_workload(rng=r),
              100: lambda r: benchmark_workload(rng=r)}
    cases, max_err = 0, 0.0
    for n, make in makers.items():
        B = 4
        D = np.stack([make(np.random.default_rng(int(rng.integers(1 << 31)))) for _ in range(B)])
        W = bonus_weights(torch.from_numpy(D.astype(np.float32)).to(dev))
        W2 = (W * (1.0 + 0.01 * torch.from_numpy(rng.standard_normal((B, n, n)).astype(np.float32)).to(dev))).contiguous()
        eps = _eps_schedule(W, default_num_phases(n)).contiguous()
        mi = default_max_iters(n)
        for reverse in (False, True):
            p0 = auction_rounds(W2, eps, mi, reverse=reverse)[2]  # a previous call's prices
            check(bool((p0 != 0).any()), f"auction_rounds n={n}: zero warm prices")
            got = auction_rounds(W, eps, mi, reverse=reverse, prices0=p0)
            torch.cuda.synchronize()
            want = auction_rounds_ref(W, eps, mi, reverse=reverse, prices0=p0)
            for name, g, w in zip(("row2col", "col2row", "prices", "rounds", "bids"), got, want):
                check(torch.equal(g, w), f"auction_rounds prices0 {name} n={n} reverse={reverse} differs from its "
                                         f"plain version")
            cold = auction_rounds(W, eps, mi, reverse=reverse)
            zeros = auction_rounds(W, eps, mi, reverse=reverse, prices0=torch.zeros_like(p0))
            for name, c, z in zip(("row2col", "col2row", "prices", "rounds", "bids"), cold, zeros):
                check(torch.equal(c, z), f"auction_rounds n={n} reverse={reverse}: prices0=None differs from zeros "
                                         f"in {name}")
            max_err = max(max_err, float((got[2] - want[2]).abs().max()))
            cases += 1
    print(f"auction_rounds with prices0: kernel == plain version exactly in {cases} cases (B=4, n in 32/64/100, "
          f"forward and forward-reverse, prices0 = a previous call's final prices, up to "
          f"{float(p0.abs().max()):.4g}); prices0=None == zeros")

    scanned = {}
    real_scan = online_torch.spectra_online_scan

    def capture(*args, **kw):  # the card's raw scan results, for the CPU comparison
        res, fin = real_scan(*args, **kw)
        scanned["res"] = res
        return res, fin

    real_flows, flow_s = flowsim.simulate_flows, []

    def timed_flows(*args, **kw):  # the flow replay's host time, a period
        t0 = time.perf_counter()
        out = real_flows(*args, **kw)
        flow_s.append(time.perf_counter() - t0)
        return out

    online_torch.spectra_online_scan = capture
    flowsim.simulate_flows = timed_flows
    launches = {"auction_bid": 0, "auction_rounds": 0, "decompose_rounds": 0, "auction_fused": 0,
                "auction_fused_cluster": 0, "polish_2swap": 0, "auction_rounds_warm": 0,
                "decompose_rounds_warm": 0, "auction_fused_warm_entries": 0}
    rows = {}
    try:
        for name, warm_prices in [(n, False) for n in ONLINE_SCENARIOS] + [("moe", True), ("permutations_large", True)]:
            spec = get_scenario(name).spec
            opts = SolveOptions(extra={"count_host_reads": True, "warm_prices": warm_prices})
            zero_auction_counters()
            auction_rounds.warm_launches = decompose_rounds.warm_launches = match_auction_fused.warm_entries = 0
            torch.cuda.synchronize()
            flow_s.clear()
            t0 = time.perf_counter()
            rep = run_scenario(name, solver="spectra_torch", online=True, simulate=True, flowsim=True, options=opts)
            wall = time.perf_counter() - t0
            got = {**auction_counters(), "auction_rounds_warm": auction_rounds.warm_launches,
                   "decompose_rounds_warm": decompose_rounds.warm_launches,
                   "auction_fused_warm_entries": match_auction_fused.warm_entries}
            for k, v in got.items():
                launches[k] += v
            per = rep.online_periods
            check(rep.trace.n == spec.n and rep.trace.T == spec.periods and rep.spec.s == spec.s,
                  f"{name}: ran at n={rep.trace.n}, T={rep.trace.T}, s={rep.spec.s}, not the registered size")
            check(rep.online_solver == "scan", f"{name}: online pass ran on {rep.online_solver}")
            for p in per:
                check(p.makespan <= p.stateless_makespan * (1 + 1e-6) + 1e-9,
                      f"{name} period {p.period}: online {p.makespan} above stateless {p.stateless_makespan}")
                check(p.demand_met, f"{name} period {p.period}: the online schedule does not serve the demand")
            check(all(r.validated for r in rep.reports) and all(q.demand_met for q in rep.periods),
                  f"{name}: a stateless period did not validate or serve its demand")
            if name in ("gpt", "moe") and not warm_prices:
                check(rep.total_reuse > 0 and rep.total_delta_avoided > 0,
                      f"{name}: reuse {rep.total_reuse}, δ avoided {rep.total_delta_avoided}")
            if warm_prices:
                if name == "moe":  # n = 64: the prices carry from call to call inside decompose_rounds
                    check(got["decompose_rounds_warm"] > 0, f"{name} warm prices: launches {got}")
                else:
                    check(got["auction_fused_warm_entries"] > 0 and got["auction_fused"] > 0,
                          f"{name} warm prices: launches {got}")
            reads = [p.host_reads for p in per]
            check(all(r is not None for r in reads), f"{name}: host reads not counted")
            tag = name + (" warm_prices" if warm_prices else "")
            units = rep.trace.normalized()[0]
            check(len(rep.flowsim_reports) == spec.periods and len(flow_s) == spec.periods,
                  f"{tag}: {len(rep.flowsim_reports)} flow replays for {spec.periods} periods")
            for q, fs, r in zip(rep.periods, rep.flowsim_reports, rep.reports):
                check(fs.conserved and fs.completed == fs.num_flows and fs.port_ok,
                      f"{tag} period {q.period}: flow replay conserved={fs.conserved}, {fs.completed} of "
                      f"{fs.num_flows} flows complete")
                per_flow = float(np.max(np.abs(fs.delivered - fs.flow_size) / np.maximum(fs.flow_size, 1.0)))
                total = abs(fs.delivered_total - fs.demand_total) / max(fs.demand_total, 1.0)
                check(per_flow <= 1e-4 and total <= 1e-4,
                      f"{tag} period {q.period}: bytes not conserved (per flow {per_flow:.3g}, total {total:.3g})")
                finish = simulate(r, units[q.period], tol=1e-4).finish_time
                check(abs(fs.finish_time - finish) <= 1e-4 * max(finish, 1.0),
                      f"{tag} period {q.period}: flow replay finishes at {fs.finish_time}, simulate at {finish}")
            attribution = rep.attribution_summary()  # raises unless the identity holds at 1e-4
            check(attribution["max_identity_residual"] <= 1e-4
                  and attribution["online_max_identity_residual"] <= 1e-4, f"{tag}: attribution {attribution}")
            warnings = rep.warning_counters()
            check(warnings.total == 0, f"{tag}: solver warnings {warnings.export()}")
            head = rep.summary()
            check(head["warnings"] == 0 and head["conserved"] and np.isfinite(head["fct_p50"])
                  and np.isfinite(head["fct_p99"]), f"{tag}: summary {head}")
            flows = flow_numbers(rep)
            summary = rep.online_summary()
            row = dict(
                n=spec.n, s=spec.s, periods=spec.periods, delta=spec.delta, warm_prices=warm_prices,
                online_wall_s=rep.online_runtime_s, ms_per_period=rep.online_runtime_s * 1e3 / len(per),
                stateless_wall_s=rep.runtime_s, run_wall_s=wall,
                host_reads=reads, host_reads_per_period=float(np.mean(reads)), host_reads_total=int(sum(reads)),
                bidding_rounds=int(sum(p.bidding_rounds for p in per)),
                warm_share=float(np.mean([p.warm for p in per])), cache_hits=int(sum(p.cache_hit for p in per)),
                k=[p.k for p in per], reuse=rep.total_reuse, delta_avoided=rep.total_delta_avoided,
                online_total=summary["online_total_makespan"], stateless_total=summary["stateless_total_makespan"],
                launches=got, flowsim_ms_per_period=[s * 1e3 for s in flow_s],
                flowsim_s=float(sum(flow_s)), flows=int(rep.flowsim_summary()["flows"]), **flows,
            )
            rows[tag] = row
            print(f"online {name}{' warm_prices' if warm_prices else ''} n={spec.n} s={spec.s} T={spec.periods}: "
                  f"online pass {rep.online_runtime_s * 1e3:.1f} ms ({row['ms_per_period']:.1f} ms a period), "
                  f"host reads a period {row['host_reads_per_period']:.1f} ({reads}; {sum(reads)} over the trace), "
                  f"bidding rounds "
                  f"{row['bidding_rounds']}, warm share {row['warm_share']:.3f}, cache hits {row['cache_hits']}, "
                  f"k {row['k']}, reuse {rep.total_reuse}, δ avoided {rep.total_delta_avoided:.4g}, online/stateless "
                  f"total {row['online_total']:.6f}/{row['stateless_total']:.6f} = "
                  f"{row['online_total'] / row['stateless_total']:.4f}; stateless pass {rep.runtime_s * 1e3:.1f} ms; "
                  f"launches {got}")
            print(f"flowsim {tag}: {row['flows']} flows over {spec.periods} periods, FCT p50 {flows['fct_p50']:.6g} "
                  f"p99 {flows['fct_p99']:.6g}; attribution serve/δ/idle "
                  f"{flows['transmission_share']:.6f}/{flows['delta_share']:.6f}/{flows['idle_share']:.3g}, online "
                  f"{flows['online_transmission_share']:.6f}/{flows['online_delta_share']:.6f}/"
                  f"{flows['online_idle_share']:.3g}; flow replay "
                  f"{', '.join(f'{s * 1e3:.1f}' for s in flow_s)} ms a period; warnings 0")
            if name in ONLINE_CPU and not warm_prices:
                rows[name]["card"] = {f: getattr(scanned["res"], f)[0].cpu().numpy() for f in ONLINE_FIELDS}
    finally:
        online_torch.spectra_online_scan = real_scan
        flowsim.simulate_flows = real_flows

    # The period's sequential loops at n = 512 (permutations_large, period 0):
    # the warm REFINE over the previous set's k rounds (what the port runs)
    # and over all n (the reference's fixed trip count), and the LPT loop.
    from repro_torch.core.torchopt.decompose_torch import decompose, lpt_place
    from repro_torch.scenarios import make_trace

    D = torch.from_numpy(make_trace("permutations_large").demands[:1].astype(np.float32)).to(dev)
    dec = decompose(D, matcher="auction_fused")
    k, n = int(dec.k[0]), D.shape[-1]
    loops = {f"warm_refine_{steps}_ms": cuda_ms(lambda: online_torch._warm_refine(D, dec.perms, dec.k, steps), 3)
             for steps in (k, n)}
    valid = torch.arange(n, device=dev)[None, :] < dec.k[:, None]
    loops["lpt_ms"] = cuda_ms(lambda: lpt_place(dec.alphas, valid, torch.zeros((1, 4), device=dev),
                                                torch.full((1,), 0.01, device=dev),
                                                torch.full((1, n), -1, dtype=torch.int64, device=dev), k), 3)
    print(f"online loops at n={n}, k={k}: warm REFINE over k rounds {loops[f'warm_refine_{k}_ms']:.2f} ms, over "
          f"all n {loops[f'warm_refine_{n}_ms']:.2f} ms; LPT over k rounds {loops['lpt_ms']:.2f} ms")

    t0 = time.perf_counter()
    try:
        cpu_child.wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("the CPU online scans did not finish in 600 s")
    check(cpu_child.returncode == 0, f"the CPU online scans exited with {cpu_child.returncode}")
    cpu = np.load(cpu_path)
    for name in ONLINE_CPU:
        card = rows[name].pop("card")
        for f in ("warm", "cache_hit", "k", "reuse_count"):
            check(np.array_equal(card[f], cpu[f"{name}.{f}"]),
                  f"online {name}: {f} on the card {card[f].tolist()} vs the CPU {cpu[f'{name}.{f}'].tolist()}")
        rel = max(float(np.max(np.abs(card[f] - cpu[f"{name}.{f}"]) / cpu[f"{name}.{f}"]))
                  for f in ("makespan", "stateless_makespan"))
        check(rel <= 1e-4, f"online {name}: makespans differ from the CPU's by {rel:.3g} relative")
        rows[name]["cpu_rel"] = rel
        rows[name]["cpu_s"] = float(cpu[f"{name}.seconds"])
        flow_rel = 0.0
        for k in FLOW_KEYS:
            want = float(cpu[f"{name}.{k}"])
            diff = abs(rows[name][k] - want)
            check(diff <= 1e-4 * max(abs(want), 1e-2), f"online {name}: {k} on the card {rows[name][k]!r} vs the "
                                                      f"CPU {want!r}")
            flow_rel = max(flow_rel, diff / max(abs(want), 1e-2))
        rows[name]["cpu_flow_rel"] = flow_rel
        print(f"online {name}: card == plain CPU path in warm, cache_hit, k, reuse_count; makespans max relative "
              f"difference {rel:.3g}; FCT p50/p99 and attribution shares max relative difference {flow_rel:.3g} "
              f"(CPU run {float(cpu[f'{name}.seconds']):.1f} s)")
    check(launches["decompose_rounds"] > 0 and launches["auction_fused"] > 0 and launches["auction_bid"] == 0,
          f"online path launches {launches}")
    print(f"online: waited {time.perf_counter() - t0:.1f} s for the CPU scans; launches {launches}")
    return dict(launches=launches, rows=rows, loops=loops, warm_check_cases=cases, warm_check_max_abs_err=max_err)


def phase_dashboard(tmp_dir: str) -> dict:
    """``python -m repro_torch.obs.dashboard moe --solver spectra_torch
    --online --html <tmp>/moe.html`` on the card, through its ``main``: it
    must exit 0 and write a report that names every switch."""
    import contextlib
    import io

    from repro_torch.obs.dashboard import main as dashboard

    path = Path(tmp_dir) / "moe.html"
    zero_auction_counters()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = dashboard(["moe", "--solver", "spectra_torch", "--online", "--html", str(path)])
    wall = time.perf_counter() - t0
    launches = auction_counters()
    check(rc == 0, f"the dashboard exited with {rc}")
    check(path.exists(), "the dashboard wrote no HTML report")
    text = path.read_text()
    check(all(f"ocs{h}" in text for h in range(4)), "the HTML report does not name every switch")
    check(launches["decompose_rounds"] > 0 and launches["auction_bid"] == 0, f"dashboard launches {launches}")
    lines = out.getvalue().splitlines()
    print(f"dashboard moe --solver spectra_torch --online: exit 0 in {wall:.1f} s, {path.name} "
          f"{len(text)} bytes naming ocs0..ocs3; launches {launches}; {lines[0]} | {lines[1].strip()} | "
          f"{lines[2].strip()}")
    return launches


def phase_serving(seed: int, cpu_path: str) -> dict:
    """The serving plane on the card (``repro_torch.serve``), with the kernels'
    counters set to 0 just before it and read after it: it must launch
    ``decompose_rounds`` and no ``masked_row_top2``.

    1. Double buffering: 4 batches of B = 8 ``moe_phases`` matrices at
       n = 64, s = 4, δ = 0.01 through ``ScheduleServer(solver=
       "spectra_torch")``. One warm batch, then a batch's solve time S
       (``dispatch_many_torch(...).collect()``, the mean over the 4
       batches); ``install_latency_s = max(S, 0.01)``. Drained in turns in
       ``sync``, ``async``, ``async`` and ``sync``, twice: the same tickets
       and makespans (1e-6) every time, and async at least 1.3× faster
       than sync over the four drains of each (total sync wall over total
       async wall); every drain's wall is printed.
    2. Open loop: ``run_open_loop`` over 3 s of ``mixed_profile(n_small=32,
       n_large=64, rate=R)`` with R half the schedules/s that async
       sustained, a ``ScheduleCache(capacity=64)`` and an
       ``AdmissionController``: nothing shed or degraded, every arrival
       served, every device report validated (Eq. 3 at 1e-4; cache hits are
       checked by the cache itself).
    3. Sessions: ``run_sessions`` on the card; every period validates, the
       moe_phases tenant has warm periods, and each tenant's ``warm``,
       ``cache_hit``, ``k`` and ``reuse_count`` equal the CPU child's.
    """
    from repro_torch.api import SolveOptions, dispatch_many_torch
    from repro_torch.scenarios import make_trace
    from repro_torch.serve import (AdmissionController, ScheduleCache, ScheduleServer, make_workload,
                                   mixed_profile, run_open_loop)

    zero_auction_counters()
    opts = SolveOptions()
    B, batches = 8, 4
    mats = make_trace("moe_phases", periods=B * batches, seed=seed).normalized()[0]
    check(mats.shape == (B * batches, 64, 64), f"serving matrices {mats.shape}")
    dispatch_many_torch(mats[:B], 4, 0.01, opts).collect()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(batches):  # the batches differ: S is their mean solve time
        dispatch_many_torch(mats[i * B:(i + 1) * B], 4, 0.01, opts).collect()
    solve_s = (time.perf_counter() - t0) / batches
    install = max(solve_s, 0.01)
    walls, outs, order = {"sync": [], "async": []}, [], ("sync", "async", "async", "sync") * 2
    for mode in order:  # in turns, so drift between the drains cancels; twice, so one slow drain cannot decide
        srv = ScheduleServer(4, 0.01, mode=mode, options=opts, install_latency_s=install, max_batch=B)
        check(srv.mode == mode, f"the server runs {srv.mode}, not {mode}")
        for i, D in enumerate(mats):
            srv.submit(f"t{i % 2}", D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.drain()
        walls[mode].append(time.perf_counter() - t0)
        check(len(srv.results) == len(mats) and all(r.source == "device" and r.report.validated
                                                   for r in srv.results.values()),
              f"{mode}: {len(srv.results)} results of {len(mats)}, or a report not validated")
        check(srv.metrics.batches == batches, f"{mode}: {srv.metrics.batches} batches")
        outs.append(sorted((r.ticket, r.makespan) for r in srv.results.values()))
    rel = max(abs(a[1] - b[1]) / b[1] for out in outs[1:] for a, b in zip(out, outs[0]))
    check(all([a[0] for a in out] == [b[0] for b in outs[0]] for out in outs[1:]) and rel <= 1e-6,
          f"async and sync results differ (makespans by {rel:.3g} relative)")
    ratio = sum(walls["sync"]) / sum(walls["async"])
    sustained = len(walls["async"]) * len(mats) / sum(walls["async"])
    seen = {"sync": iter(walls["sync"]), "async": iter(walls["async"])}
    print(f"serving double buffer: B={B} x {batches} moe_phases n=64, solve S {solve_s * 1e3:.1f} ms a batch (mean), install "
          f"{install * 1e3:.1f} ms; in turns {', '.join(order)}: "
          f"{', '.join(f'{next(seen[mode]) * 1e3:.1f}' for mode in order)} ms, total sync/async {ratio:.3f} "
          f"(gate 1.3); {sustained:.1f} schedules/s; results identical (makespans max relative difference {rel:.3g})")
    check(ratio >= 1.3, f"async only {ratio:.3f}x faster than sync")

    rate = 0.5 * sustained
    wl = make_workload(mixed_profile(n_small=32, n_large=64, rate=rate), duration=3.0, seed=seed, s=4, delta=0.01)
    cache = ScheduleCache(capacity=64)
    srv = ScheduleServer(4, 0.01, mode="async", options=opts, install_latency_s=install, max_batch=B, cache=cache,
                         admission=AdmissionController())
    t0 = time.perf_counter()
    m = run_open_loop(srv, wl)
    loop_s = time.perf_counter() - t0
    served = list(srv.results.values())
    check(m["shed"] == 0 and m["degraded"] == 0 and m["schedules"] == len(wl) == len(served),
          f"open loop: {len(wl)} arrivals, {m['schedules']} served, {m['shed']} shed, {m['degraded']} degraded")
    check(all(r.report.validated for r in served if r.source == "device"), "open loop: a device report not validated")
    st = m["stages"]
    open_loop = dict(rate=rate, arrivals=len(wl), wall_s=loop_s, schedules_per_s=len(wl) / loop_s,
                     device_served=sum(r.source == "device" for r in served), cache_hit_rate=m["cache_hit_rate"],
                     batches=m["batches"], **{f"{k}_{q}_ms": st[k][f"{q}_s"] * 1e3
                                              for k in ("queue_wait", "device", "e2e") for q in ("p50", "p99")})
    print(f"serving open loop: {len(wl)} arrivals at {rate:.2f}/s over 3 s (mixed_profile n=32/64), served all in "
          f"{loop_s:.2f} s ({open_loop['schedules_per_s']:.2f} schedules/s), {m['batches']} batches, "
          f"{open_loop['device_served']} from the card, cache hit rate {m['cache_hit_rate']:.3f}, shed 0; p50/p99 "
          f"queue wait {open_loop['queue_wait_p50_ms']:.1f}/{open_loop['queue_wait_p99_ms']:.1f} ms, device "
          f"{open_loop['device_p50_ms']:.1f}/{open_loop['device_p99_ms']:.1f} ms, e2e "
          f"{open_loop['e2e_p50_ms']:.1f}/{open_loop['e2e_p99_ms']:.1f} ms")

    t0 = time.perf_counter()
    mgr, served = run_sessions(opts)
    sessions_s = time.perf_counter() - t0
    cpu = np.load(cpu_path)
    stats = mgr.stats()
    for name, n in SESSIONS:
        reps = [r for t, r in served if t == name]
        check(len(reps) == SESSION_PERIODS and all(r.validated and r.solver == "spectra_online_torch" for r in reps),
              f"session {name}: {len(reps)} periods, or one not validated")
        for f in SESSION_FIELDS:
            got = np.array([r.extras[f] for r in reps])
            check(np.array_equal(got, cpu[f"session.{name}.{f}"]),
                  f"session {name}: {f} on the card {got.tolist()} vs the CPU {cpu[f'session.{name}.{f}'].tolist()}")
        print(f"serving session {name} n={n}: {SESSION_PERIODS} periods validated, warm "
              f"{[bool(r.extras['warm']) for r in reps]}, k {[r.extras['k'] for r in reps]}, reuse "
              f"{[r.extras['reuse_count'] for r in reps]}, δ avoided {stats[name]['delta_avoided']:.4g}; decisions "
              f"== the CPU's")
    check(stats["moe_phases"]["warm"] > 0, f"session moe_phases: no warm period ({stats['moe_phases']})")
    launches = auction_counters()
    check(launches["decompose_rounds"] > 0 and launches["auction_bid"] == 0, f"serving launches {launches}")
    print(f"serving sessions: {2 * SESSION_PERIODS} periods in {sessions_s * 1e3:.1f} ms (CPU child "
          f"{float(cpu['session.seconds']):.1f} s); serving launches {launches}")
    return dict(launches=launches, solve_ms=solve_s * 1e3, install_ms=install * 1e3,
                sync_ms=[w * 1e3 for w in walls["sync"]], async_ms=[w * 1e3 for w in walls["async"]], ratio=ratio,
                schedules_per_s=sustained, open_loop=open_loop, sessions_ms=sessions_s * 1e3)


# ---------------------------------------------------------------------------
# The gpt-100m OCS twin, the sharded step, the legacy auction shim,
# bench/matching, and the dry run (a CPU child).
# ---------------------------------------------------------------------------

GPT_STEPS, GPT_B, GPT_S, GPT_OCS_EVERY = 300, 8, 256, 20
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k"), ("zamba2-1.2b", "decode_32k"))
# The same cells' counts a chip before the loss and the query heads were
# sharded (PERF.md §6): FLOPs, bytes, wire bytes, resident bytes.
DRYRUN_BEFORE = {"qwen3-moe-30b-a3b__train_4k": dict(flops=1.050e15, bytes=8.794e13, wire=3.404e11, resident=42.15e9),
                 "zamba2-1.2b__decode_32k": dict(flops=2.404e9, bytes=7.805e9, wire=5.139e9, resident=1.134e9)}


def auction_counters() -> dict:
    from repro_torch.kernels.auction_bid import auction_rounds, decompose_rounds, masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction, polish_2swap

    return {"auction_bid": masked_row_top2.launches, "auction_rounds": auction_rounds.launches,
            "decompose_rounds": decompose_rounds.launches,
            "auction_fused": fused_auction.launches, "polish_2swap": polish_2swap.launches,
            "auction_fused_cluster": fused_auction.cluster_launches}


def zero_auction_counters() -> None:
    from repro_torch.kernels.auction_bid import auction_rounds, decompose_rounds, masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction, polish_2swap

    masked_row_top2.launches = auction_rounds.launches = fused_auction.launches = polish_2swap.launches = 0
    fused_auction.cluster_launches = decompose_rounds.launches = 0


def round_kernels(launches: dict) -> int:
    """Launches of the n ≤ 128 auction kernels: DECOMPOSE's whole round loop
    (``decompose_rounds``) or one matcher call (``auction_rounds``)."""
    return launches["decompose_rounds"] + launches["auction_rounds"]


def flash_f32_gpt_shape(rng) -> dict:
    """flash_attention float32 (the CUDA-core kernel) at gpt-100m's (8, 12,
    256, 64) causal: against mha_ref at atol 1e-4, timed with its plain
    version, scaled_dot_product_attention in float32 and its bound."""
    from repro_torch.kernels.flash_attention import flash_attention, mha_ref

    B, H, S, D = GPT_B, 12, GPT_S, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)).cuda() for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = mha_ref(q, k, v, causal=True)
    err = float((got - want).abs().max())
    check(err <= 1e-4, f"flash_attention float32 at gpt-100m's shape: max |Δ| {err}")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 50)
    plain_ms = cuda_ms(lambda: mha_ref(q, k, v, causal=True), 20)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), 50)
    b_ms, b_by, flops, _ = kernel_bound("flash_attention", FP32_FLOPS, B=B, Hq=H, Hkv=H, Sq=S, Sk=S, D=D, causal=True,
                                     window=None, itemsize=4)
    print(f"flash_attention float32 (8, 12, 256, 64) causal, gpt-100m's shape: max |kernel − plain| {err:.3g}; "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention float32 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(shape=[B, H, S, D], dtype="float32", ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, flops=flops, max_abs_err=err)


def phase_gpt100m(rng) -> dict:
    """The twin of examples/train_gpt_ocs.py at full width: gpt-100m (12
    layers, d 768, 12 heads, float32), 300 steps at B = 8 × S = 256, the OCS
    tick every 20 steps on OCSFabric(4, 20 µs) over 8 racks. The loss must
    decrease, every step must launch flash_attention 12 times (counters set to
    0 just before each step), and every tick must equal the host spectra on
    the same ring matrix."""
    from repro_torch.fabric import OCSFabric
    from repro_torch.launch.train_gpt_ocs import make_gpt_trainer
    from repro_torch.train.loop import _demand_from_stats

    free_device_memory()
    timed = flash_f32_gpt_shape(rng)
    tr, cfg, steps = make_gpt_trainer(steps=GPT_STEPS, batch=GPT_B, seq=GPT_S, ocs_every=GPT_OCS_EVERY)
    per_step: list = []
    tr.train_step = counted(tr.train_step, per_step)
    walls: list = []
    step_fn = tr.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        out[2]["loss"].item()
        walls.append(time.perf_counter() - t0)
        return out

    tr.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.run(0)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in state.history]
    check(state.step == GPT_STEPS and len(per_step) == GPT_STEPS, f"gpt-100m: {state.step} steps, {len(per_step)} counted")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"gpt-100m: loss did not decrease: {losses}")
    check(all(c["flash_attention"] == cfg.num_layers for c in per_step),
          f"gpt-100m: flash launches a step {sorted({c['flash_attention'] for c in per_step})}, expected {cfg.num_layers}")
    ring = _demand_from_stats(8, {}, 0)
    res, cct = OCSFabric(num_switches=4, reconfig_delay_s=20e-6).schedule_bytes(ring * 1e9)
    check([r["step"] for r in state.cct_log] == list(range(GPT_OCS_EVERY - 1, GPT_STEPS, GPT_OCS_EVERY)),
          f"gpt-100m ticks at {[r['step'] for r in state.cct_log]}")
    for r in state.cct_log:
        check(r["cct_s"] == cct and r["makespan"] == res.makespan and r["configs"] == res.schedule.num_configs(),
              f"gpt-100m tick {r} differs from host spectra ({cct} s)")
    ms = float(np.mean(walls[1:])) * 1e3
    phases, groups, span = step_breakdown(tr, state)
    busy = sum(groups.values())
    print("gpt-100m train step, device time by phase (CUDA events, one step): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in phases.items()) + "; by kernel group (torch.profiler, one more "
          + "step): " + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f", busy {busy:.2f} ms of that step's {span:.2f} ms event span (idle share {1 - busy / span:.3f})")
    print(f"gpt-100m ({tr.model.param_count() / 1e6:.1f} M parameters, float32): {GPT_STEPS} steps at B={GPT_B} "
          f"S={GPT_S} in {run_s:.1f} s; loss {losses[0]:.4f} → {losses[-1]:.4f}; step after the first {ms:.2f} ms "
          f"(min {min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}), {GPT_B * GPT_S / ms * 1e3:.0f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; flash_attention {per_step[-1]['flash_attention']} launches a step; {len(state.cct_log)} "
          f"ticks, each CCT {cct * 1e3:.4f} ms = host spectra (makespan {res.makespan:.6f}, LB {res.lower_bound:.6f}, "
          f"{res.schedule.num_configs()} circuits)")
    return dict(launches=sum(c["flash_attention"] for c in per_step), ms_per_step=ms,
                tokens_per_s=GPT_B * GPT_S / ms * 1e3, peak_gb=peak_gb, loss_first=losses[0], loss_last=losses[-1],
                ticks=len(state.cct_log), cct_ms=cct * 1e3, run_s=run_s, flash_f32=timed, phases_ms=phases,
                groups_ms=groups, idle_share=1 - busy / span)


def phase_sharded_step() -> dict:
    """The sharded train step on the card: an in-process NCCL group of one
    rank, a 1 × 1 mesh, gpt-100m at full width. It must equal the unsharded
    step (loss 1e-6 relative, every gradient tensor 1e-5 of its largest
    entry, parameters 1e-5) with flash_attention launched on the local shards
    through local_map (12 a forward). The group is destroyed at the end."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data import make_stream
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train_gpt_ocs import gpt_100m
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.steps import (loss_and_grads, make_model_for_cell, make_optimizer,
                                            make_sharded_train_step, make_train_step, shard_state)

    cfg = gpt_100m()
    model = build_model(cfg)
    opt = make_optimizer()
    params = model.init(0)
    batch = make_stream(cfg.vocab_size, GPT_S, GPT_B).next_batch(0)
    p1, _, m1 = make_train_step(model, opt)(params, opt.init(params), batch)
    _, _, g1 = loss_and_grads(model, params, batch)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, model=1)
        smodel = make_model_for_cell(cfg, mesh, remat=False)
        ps, os_, bs = shard_state(params, opt.init(params), batch, mesh)
        step = make_sharded_train_step(smodel, opt, mesh)
        step(ps, os_, bs)  # the first call fills DTensor's sharding caches
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        p2, _, m2 = step(ps, os_, bs)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        launches = flash_attention.launches
        with implicit_replication():
            _, _, g2 = loss_and_grads(smodel, ps, bs)
        loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
        grad_worst = max(float((g2[k].full_tensor() - g1[k]).abs().max() / g1[k].abs().max()) for k in g1)
        param_worst = max(float((p2[k].full_tensor() - p1[k]).abs().max()) for k in p1)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the NCCL group outlived the sharded phase")
    check(launches == cfg.num_layers, f"sharded step: flash_attention launched {launches} times, "
                                      f"expected {cfg.num_layers} through local_map")
    check(loss_rel <= 1e-6, f"sharded step loss {float(m2['loss'])} vs unsharded {float(m1['loss'])}")
    check(grad_worst <= 1e-5, f"sharded step: a gradient differs by {grad_worst} of its largest entry")
    check(param_worst <= 1e-5, f"sharded step: parameters differ by {param_worst}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_train_step(model, opt)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"sharded step, gpt-100m on an in-process NCCL group of 1 (1 × 1 mesh): loss {float(m2['loss']):.6f} vs "
          f"{float(m1['loss']):.6f} (relative {loss_rel:.3g}); worst gradient tensor {grad_worst:.3g} of its largest "
          f"entry; parameters {param_worst:.3g}; flash_attention {launches} launches through local_map; step "
          f"{sharded_ms:.1f} ms sharded vs {plain_ms:.1f} ms unsharded (host clock, one step each)")
    return dict(launches=launches, loss_rel=loss_rel, grad_worst=grad_worst, param_worst=param_worst,
                sharded_ms=sharded_ms, plain_ms=plain_ms)


def phase_shim(rng) -> dict:
    """The legacy auction shim on a CUDA W: the permutation of match_auction,
    through auction_rounds at n = 64 and masked_row_top2 at n = 160."""
    from repro_torch.core.torchopt.auction import auction_maximize
    from repro_torch.core.torchopt.matching import match_auction
    from repro_torch.traffic import permutations_workload

    zero_auction_counters()
    for n in (64, 160):
        D = permutations_workload(n=n, k=16, rng=rng)[None].astype(np.float32)
        W = bonus_weights(torch.from_numpy(D))[0].cuda()
        perm, conv = auction_maximize(W)
        want = match_auction(W[None])
        check(bool(conv) and torch.equal(perm, want.perm[0]), f"shim n={n}: permutation differs from match_auction")
        check(torch.equal(perm.cpu(), auction_maximize(W.cpu())[0]), f"shim n={n}: card differs from the CPU")
    launches = auction_counters()
    check(launches["auction_rounds"] > 0 and launches["auction_bid"] > 0, f"shim launches {launches}")
    print(f"legacy auction shim on the card: the permutation of match_auction and of the CPU at n = 64 and 160; "
          f"launches {launches} (the shim's and match_auction's calls)")
    return launches


def phase_bench_matching() -> tuple[dict, list[str], dict]:
    """bench/matching --check on the card: n = 100, 256, 512 with the
    reference's matchers a size, and auction and auction_fused at 1024, as
    the module's own CLI runs them. Its gates, the quality gate (≤ 1.10)
    and the speed gate (auction_fused ≥ 1.5× auction at n ≥ 256), are
    returned and enforced once every later phase has printed its numbers.
    Prints auction_fused's speed-up over auction at each n and one
    auction_fused dispatch at each n split by CUDA events
    (``bench.fused_split``: the ε schedule's host read, the kernel, the
    polish and the rest)."""
    from repro_torch.bench import matching as bench

    zero_auction_counters()
    t0 = time.perf_counter()
    rows = bench.run((100, 256, 512), 3) + bench.run((1024,), 1, only=("auction", "auction_fused"))
    launches = auction_counters()
    failures = bench.check(rows)
    path = bench.write(rows, "cuda")
    by = {(r["n"], r["matcher"]): r["ms_per_dispatch"] for r in rows}
    speedup = {n: by[(n, "auction")] / by[(n, "auction_fused")] for n in (256, 512, 1024)}
    split = {n: bench.fused_split(n) for n in (256, 512, 1024)}
    print(json.dumps({"bench_matching": rows, "gate_failures": failures, "fused_split_ms": split,
                      "artifact": str(path)}))
    print(f"bench/matching --check in {time.perf_counter() - t0:.1f} s: gates "
          f"{'FAILED: ' + '; '.join(failures) if failures else 'passed'}; auction_fused over auction "
          + ", ".join(f"n={n} {x:.2f}x" for n, x in speedup.items())
          + "; an auction_fused dispatch by CUDA events, ms: "
          + "; ".join(f"n={n} ε schedule {d['eps']:.3f}, kernel {d['kernel']:.3f}, polish {d['polish']:.3f}, "
                      f"rest {d['rest']:.3f} (total {d['total']:.3f}, host wall {d['wall']:.3f})"
                      for n, d in split.items())
          + f"; launches {launches}")
    return launches, failures, dict(speedup=speedup, split=split)


def start_dryrun(tmp_dir: str):
    """The dry run in a child process on the CPU (no card), beside the card's phases."""
    log = open(Path(tmp_dir) / "dryrun.log", "w")
    cmd = [sys.executable, "-c", "import sys, time; from repro_torch.launch.dryrun import main; t = time.time(); "
           "rc = max(main(['--single-pod', '--force', '--arch', a, '--shape', s]) for a, s in "
           + repr(DRYRUN_CELLS) + "); print(f'DRYRUN_SECONDS {time.time() - t:.1f}'); sys.exit(rc)"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(Path(__file__).resolve().parent / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, log, time.perf_counter()


def phase_dryrun(child) -> dict:
    """Wait for the dry-run child, require exit 0 and a JSON file a cell, and
    print its fake-mesh counts: per-chip FLOPs, bytes and wire bytes, the
    collectives by kind, the three terms against the H100 SXM data sheet and
    the calibration cross-check. Counts, not timings."""
    from repro_torch.launch.dryrun import cell_path

    proc, log, _ = child
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    log.close()
    waited = time.perf_counter() - t0
    text = Path(log.name).read_text()
    tail = "\n".join(line for line in text.splitlines() if "W1017" not in line and line.strip())[-3000:]
    check(rc == 0, f"dry-run child exited {rc}:\n{tail}")
    out = {}
    for arch, shape in DRYRUN_CELLS:
        path = cell_path(arch, shape, False)
        check(path.exists(), f"dry run wrote no {path}")
        art = json.loads(path.read_text())
        r, cal = art["roofline"], art["calibration"]
        print(f"dry run {arch} × {shape} on a fake 16 × 16 mesh (counts on one rank, not timings; traced in "
              f"{art['trace_s']} s): per chip {r['flops_per_chip']:.4g} FLOP, {r['bytes_per_chip']:.4g} B, wire "
              f"{r['wire_bytes_per_chip']:.4g} B; collectives {r['collectives']['ops']}; terms against the H100 SXM "
              f"data sheet: compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, collective "
              f"{r['collective_s']:.4g} s (dominant {r['dominant']}, useful {r['useful_ratio']:.3g}, roofline "
              f"fraction {r['roofline_fraction']:.3g}); resident {art['bytes_per_device_est'] / 1e9:.4g} GB a chip "
              f"({art['resident_bytes']}); FLOPs by op {art['flops_by_op']} (bmm: the routed experts and, in "
              f"training, the attention backward's plain recompute; flash_attention and ssd_chunk at the kernels' "
              f"cost); "
              f"calibration base + (units − 1)·per-unit vs traced, relative {cal.get('rel_diff')}")
        before = DRYRUN_BEFORE[f"{arch}__{shape}"]
        print(f"dry run {arch} × {shape}, a chip, before the loss and heads were sharded → now: FLOPs {before['flops']:.4g} → "
              f"{r['flops_per_chip']:.4g}, bytes {before['bytes']:.4g} → {r['bytes_per_chip']:.4g}, wire "
              f"{before['wire']:.4g} → {r['wire_bytes_per_chip']:.4g}, resident {before['resident'] / 1e9:.4g} → "
              f"{art['bytes_per_device_est'] / 1e9:.4g} GB")
        if arch == "qwen3-moe-30b-a3b":
            # Each rank of the 16-wide model axis runs 2 of the 32 query heads (one KV head of 4)
            # on its 16 rows: flash counted at kernel_cost, a forward and remat's forward a layer.
            from repro_torch.analysis.roofline import kernel_cost
            from repro_torch.configs import get_arch, get_shape

            cfg, sh = get_arch(arch), get_shape(shape)
            one, _ = kernel_cost("flash_attention", B=sh.global_batch // 16, Hq=cfg.num_heads // 16, Hkv=1,
                                 Sq=sh.seq_len, Sk=sh.seq_len, D=cfg.resolved_head_dim, causal=True, window=None,
                                 itemsize=2)
            got = art["flops_by_op"].get("flash_attention")
            check(got == 2 * cfg.num_layers * one,
                  f"dry run {arch}: flash_attention {got} FLOPs a chip, not {2 * cfg.num_layers} calls of 2 query "
                  f"heads ({2 * cfg.num_layers * one})")
        out[f"{arch}__{shape}"] = dict(trace_s=art["trace_s"], roofline=r, calibration=cal,
                                       bytes_per_device_est=art["bytes_per_device_est"],
                                       resident_bytes=art["resident_bytes"], flops_by_op=art["flops_by_op"],
                                       before=before)
    took = [line.split()[1] for line in text.splitlines() if line.startswith("DRYRUN_SECONDS")]
    print(f"dry-run child: {took[0] if took else '?'} s of its own, beside the card's phases (the card's phases "
          f"waited {waited:.1f} s for it at the end)")
    out["child_s"] = float(took[0]) if took else None
    return out


# ---------------------------------------------------------------------------
# The entry points above the solver API: bench/{runtime,serve,online,
# scenarios,experiments} and the examples, each as a user runs it (no
# --device: the card).
# ---------------------------------------------------------------------------

def kernel_counters() -> dict:
    """Every kernel's launch counter but demand_accum's (no path calls it)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    return {**auction_counters(), "flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches}


def zero_kernel_counters() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    zero_auction_counters()
    flash_attention.launches = ssd_chunk.launches = 0


RUNTIME_QUALITY = (0.97, 1.02)  # device/host makespan, as the solver layer's bucket ratios are bounded


def phase_runtime() -> tuple[dict, list[dict]]:
    """bench/runtime (the §V-A runtime table) at full size: gpt, moe and
    benchmark at B = 16 with 10 host reps, benchmark_large (n = 256) and
    permutations_large (n = 512) at B = 2 with 2. Every row must be finite,
    with its device/host makespan within RUNTIME_QUALITY; the n ≤ 128 rows
    launch decompose_rounds, the large ones auction_fused, and no
    masked_row_top2. The gpt row's B = 16 batch is then solved again on the
    card and on the plain CPU path: makespans equal to 1e-4."""
    from repro_torch.api import solve_many
    from repro_torch.bench import runtime
    from repro_torch.bench.common import fast_options

    zero_kernel_counters()
    rows, _ = runtime.run()
    launches = kernel_counters()
    lo, hi = RUNTIME_QUALITY
    for r in rows:
        check(all(np.isfinite(r[k]) and r[k] > 0 for k in ("mean_ms", "p95_ms", "batched_device_ms_per_instance",
                                                          "device_quality_vs_host")), f"runtime row {r}")
        check(lo <= r["device_quality_vs_host"] <= hi,
              f"runtime {r['workload']}: device/host makespan {r['device_quality_vs_host']} outside {RUNTIME_QUALITY}")
        print(f"runtime {r['workload']}: host spectra mean {r['mean_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms; "
              f"spectra_torch {r['batched_device_ms_per_instance']:.3f} ms a matrix at B={r['batch_size']} (one "
              f"solve_many after a warm one); device/host makespan {r['device_quality_vs_host']:.4f}")
    check(launches["decompose_rounds"] > 0 and launches["auction_fused"] > 0 and launches["auction_bid"] == 0,
          f"runtime launches {launches}")
    Ds = runtime.device_matrices("gpt", runtime.BATCH)
    gpu = solve_many(Ds, 4, runtime.DELTA, solver="spectra_torch", options=fast_options(None))
    cpu = solve_many(Ds, 4, runtime.DELTA, solver="spectra_torch", options=fast_options("cpu"))
    rel = max(abs(g.makespan - c.makespan) / c.makespan for g, c in zip(gpu, cpu))
    check(rel <= 1e-4, f"runtime gpt B={len(Ds)}: GPU makespans differ from the plain CPU path by {rel}")
    print(f"runtime gpt B={len(Ds)}: GPU makespans agree with the plain CPU path (max relative difference {rel:.3g})")
    return launches, rows


def phase_serve_bench() -> tuple[dict, list[str], list[dict]]:
    """bench/serve --check: speedup (n = 16, B = 4, 6 batches, the install at
    max(solve, 10 ms)), the tiny and mixed cache profiles, the 2× overload.
    Its gates are returned and enforced once every later phase has printed."""
    from repro_torch.bench import serve
    from repro_torch.bench.common import write_artifact

    zero_kernel_counters()
    rows = serve.run(fast=False)
    launches = kernel_counters()
    failures = serve.check(rows)
    write_artifact("serve_torch", {"rows": rows, "device": "cuda"}, workload="serve-control-plane")
    sp = next(r for r in rows if r["experiment"] == "speedup")
    tiny = next(r for r in rows if r["experiment"] == "cache" and r["profile"] == "tiny")
    over = next(r for r in rows if r["experiment"] == "overload")
    print(f"bench/serve: speedup async/sync {sp['speedup']:.3f} (gate {serve.SPEEDUP_GATE}) beside its ideal "
          f"{sp['ideal_speedup']:.3f}, a batch's solve {sp['solve_ms']:.2f} ms, install {sp['install_ms']:.2f} ms; "
          f"tiny profile hit rate {tiny['cache_hit_rate']:.3f} (gate {serve.CACHE_HIT_GATE}), "
          f"{tiny['schedules_per_sec']:.1f} schedules/s (floor {serve.THROUGHPUT_FLOOR}), e2e p99 "
          f"{tiny['p99_e2e_s']:.4f} s (ceiling {serve.P99_CEILING}); overload shed {over['shed']} of "
          f"{over['requests']}, max depth {over['max_depth']} (bound {over['max_queue']}), accounted "
          f"{over['accounted']}; gates {'FAILED: ' + '; '.join(failures) if failures else 'passed'}; "
          f"launches {launches}")
    check(round_kernels(launches) > 0, f"bench/serve launches {launches}")
    return launches, failures, [{k: v for k, v in r.items() if k != "metrics"} for r in rows]


def phase_online_fig() -> tuple[dict, list[dict]]:
    """bench/online at full size: gpt, moe, benchmark at T = 8 and 32, the
    host controller and the device scan. The device rows must run the scan
    and launch an n ≤ 128 round kernel."""
    from repro_torch.bench import online

    zero_kernel_counters()
    data, rows = online.run()
    launches = kernel_counters()
    for d, r in zip(data, rows):
        check(np.isfinite(d["ratio"]) and (d["solver"] == "spectra" or d["online_backend"] == "scan"),
              f"online row {d}")
        print(f"{r['name']}: online/stateless {d['ratio']:.4f} ({d['online_total_makespan']:.4f} / "
              f"{d['stateless_total_makespan']:.4f}), reuse {d['reuse']}, δ paid {d['delta_paid']:.3f}, avoided "
              f"{d['delta_avoided']:.3f}; {1e3 * d['runtime_s'] / d['T']:.2f} ms a period ({d['online_backend']})")
    check(round_kernels(launches) > 0, f"bench/online launches {launches}")
    return launches, data


def phase_scenario_mode() -> tuple[dict, int]:
    """bench/scenarios --solver spectra_torch --online --flowsim --obs on gpt,
    moe and benchmark at their registered sizes; its exit status is enforced
    once every later phase has printed."""
    from repro_torch.bench import scenarios

    zero_kernel_counters()
    rc = scenarios.main(["--scenario", "gpt", "moe", "benchmark", "--solver", "spectra_torch", "--online",
                         "--flowsim", "--obs"])
    launches = kernel_counters()
    print(f"bench/scenarios exit status {rc}; launches {launches}")
    check(round_kernels(launches) > 0, f"bench/scenarios launches {launches}")
    return launches, rc


def phase_experiments() -> tuple[dict, list[dict]]:
    """bench/experiments on the dry-run child's two artifacts (copied alone
    into a directory of their own, so no artifact of an earlier run enters
    the tables): both tables and the roofline CSV, one row a cell, each with
    the fabric's CCT from host spectra and from spectra_torch on the card."""
    from repro_torch.bench import experiments
    from repro_torch.launch.dryrun import cell_path

    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRYRUN_CELLS:
            shutil.copy(cell_path(arch, shape, False), tmp)
        zero_kernel_counters()
        table = experiments.report(Path(tmp), experiments.OUT_DIR, None)
        launches = kernel_counters()
    check(sorted(t["cell"] for t in table) == sorted(f"{arch}×{shape}" for arch, shape in DRYRUN_CELLS),
          f"bench/experiments rows {[t['cell'] for t in table]}, expected the cells {DRYRUN_CELLS}")
    print(f"bench/experiments: {len(table)} roofline rows; launches {launches}")
    check(round_kernels(launches) > 0, f"bench/experiments launches {launches}")
    return launches, table


def phase_examples() -> tuple[dict, dict]:
    """The four examples of the device path as a user runs them, each with its
    seconds and launches: batched_device_scheduling (decompose_rounds),
    serve_loadtest (an n ≤ 128 round kernel), serve_decode (decode by replay, as the
    reference's: no kernel), moe_traffic_schedule (flash_attention in its
    train steps)."""
    from repro_torch.api import SolveOptions, solve_many
    from repro_torch.examples import batched_device_scheduling, moe_traffic_schedule, serve_decode, serve_loadtest
    from repro_torch.scenarios import make_trace

    total: dict = {}
    out = {}
    for name, mod in (("batched_device_scheduling", batched_device_scheduling), ("serve_loadtest", serve_loadtest),
                      ("serve_decode", serve_decode), ("moe_traffic_schedule", moe_traffic_schedule)):
        zero_kernel_counters()
        t0 = time.perf_counter()
        res = mod.main([])
        took = time.perf_counter() - t0
        launches = kernel_counters()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"example {name}: {took:.1f} s; launches {launches}")
        out[name] = dict(seconds=took, launches=launches)
        if name == "batched_device_scheduling":
            lo, hi = RUNTIME_QUALITY
            check(launches["decompose_rounds"] > 0 and all(lo <= q <= hi for q in res["ratios"]),
                  f"{name}: device/host ratios {res['ratios']} outside {RUNTIME_QUALITY}, {launches}")
            cpu = solve_many(make_trace("benchmark", n=32, m=8, num_big=4, periods=4).demands, 4, 0.01,
                             solver="spectra_torch", options=SolveOptions(extra={"matcher": "auction", "device": "cpu"}))
            rel = max(abs(g.makespan - c.makespan) / c.makespan for g, c in zip(res["reports"], cpu))
            check(rel <= 1e-4, f"{name}: GPU makespans differ from the plain CPU path by {rel}")
            print(f"example {name}: GPU makespans agree with the plain CPU path (max relative difference {rel:.3g})")
            out[name]["worst_quality"] = res["worst"]
        elif name == "serve_loadtest":
            check(round_kernels(launches) > 0 and res["open_loop"]["schedules"] == res["arrivals"]
                  and res["shed"] > 0 and res["served"] + res["shed"] == res["overload"], f"{name}: {res}, {launches}")
            out[name].update(hit_rate=res["open_loop"]["cache_hit_rate"], shed=res["shed"])
        elif name == "serve_decode":
            check(all(t.shape == (4, 64) for t in res["tokens"].values()), f"{name}: token shapes")
        else:
            check(launches["flash_attention"] > 0 and res["load"].sum() > 0, f"{name}: {launches}")
    return total, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-online", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    if args.cpu_online:
        cpu_online(args.cpu_online)
        return
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
    # The online phase's CPU reference runs beside the card's phases.
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    cpu_path = str(Path(tmp.name) / "cpu_online.npz")
    # Its own process group: stopping it stops its worker processes too.
    cpu_child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-online", cpu_path],
                                 env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, start_new_session=True)
    dry_child = start_dryrun(tmp.name)
    try:
        run_phases(args, t_start, cpu_child, cpu_path, dry_child)
    finally:
        for child in (cpu_child, dry_child[0]):
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            child.wait()
        dry_child[1].close()
        tmp.cleanup()


def run_phases(args, t_start: float, cpu_child, cpu_path: str, dry_child) -> None:
    from repro_torch.kernels import backend

    t0 = time.perf_counter()
    backend.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s ({backend.library_path().name})")

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.demand_accum import demand_accum

    rng = np.random.default_rng(args.seed)
    bid = phase_bid(rng)
    rounds = phase_rounds(rng)
    decomp = phase_decompose(rng)
    fused = phase_fused(rng)
    polish = phase_polish(rng)
    flash = phase_flash(rng)
    ssd = phase_ssd(rng)
    accum = phase_demand_accum(rng)
    demand_accum.launches = 0  # no system path runs it: read after the last one
    t0 = time.perf_counter()
    launches = phase_main_path(args.seed)
    print(f"solver path: {time.perf_counter() - t0:.1f} s")
    check(launches["decompose_rounds"] > 0 and launches["auction_fused"] > 0 and launches["auction_bid"] == 0,
          f"main path launches {launches}")
    api_launches, matcher_api = phase_matcher_api(args.seed)
    t0 = time.perf_counter()
    above = phase_matchers_above_128(np.random.default_rng([17, args.seed]))
    layer = phase_solver_layer(args.seed)
    print(f"matcher and solver layer phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_model_parity(args.seed)
    launches.update(phase_zamba2(args.seed))
    print(f"LM phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_parity(args.seed)
    train_launches = phase_train(args.seed)
    print(f"training phases: {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    phase_moe_parity(args.seed)
    by_path = {"forward": launches["flash_attention"], "train": train_launches["flash_attention"],
               "moe_forward": phase_moe_serve(args.seed), "moe_train": phase_moe_train(args.seed)}
    print(f"MoE phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["vlm_forward"] = phase_vlm(args.seed)
    by_path["audio_forward"] = phase_whisper(args.seed)
    print(f"VLM and audio phases: {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    online = phase_online(np.random.default_rng([18, args.seed]), cpu_child, cpu_path)
    print(f"online phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_dashboard = phase_dashboard(str(Path(cpu_path).parent))
    serving = phase_serving(args.seed, cpu_path)
    print(f"dashboard and serving phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gpt = phase_gpt100m(np.random.default_rng([20, args.seed]))
    print(f"gpt-100m phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded = phase_sharded_step()
    print(f"sharded step phase: {time.perf_counter() - t0:.1f} s")
    by_path["gpt100m_train"] = gpt["launches"]
    by_path["sharded_step"] = sharded["launches"]
    t0 = time.perf_counter()
    by_shim = phase_shim(np.random.default_rng([21, args.seed]))
    by_bench, bench_failures, bench_numbers = phase_bench_matching()
    print(f"shim and bench/matching phases: {time.perf_counter() - t0:.1f} s")
    entry = {"matcher_api": api_launches}  # the entry points' launches by phase
    t0 = time.perf_counter()
    entry["runtime"], runtime_rows = phase_runtime()
    print(f"runtime phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["serve_bench"], serve_failures, serve_rows = phase_serve_bench()
    print(f"bench/serve phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["online_fig"], online_fig = phase_online_fig()
    print(f"bench/online phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["scenario_mode"], scenario_rc = phase_scenario_mode()
    print(f"bench/scenarios phase: {time.perf_counter() - t0:.1f} s")
    dry = phase_dryrun(dry_child)
    t0 = time.perf_counter()
    entry["experiments"], roofline = phase_experiments()
    print(f"bench/experiments phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["examples"], examples = phase_examples()
    print(f"examples phase: {time.perf_counter() - t0:.1f} s")
    launches["demand_accum"] = demand_accum.launches

    bid_main = bid["shapes"][3]  # (4, 512): the widest the round loop serves on the solver layer's path
    by_layer = layer["launches"]

    by_online = online["launches"]  # the online runs with their flow replay
    by_serving = serving["launches"]

    def paths(key: str) -> dict:
        return {"solver_buckets": launches[key], "solver_layer": by_layer[key], "online": by_online[key],
                "dashboard": by_dashboard.get(key, 0), "serving": by_serving.get(key, 0),
                "shim": by_shim[key], "bench_matching": by_bench[key], **{k: v[key] for k, v in entry.items()}}

    kernels = [
        dict(name="auction_bid", route="cuda", source="src/repro_torch/csrc/auction_bid.cu",
             replaces="src/repro/kernels/auction_bid/kernel.py:22",
             launches=sum(paths("auction_bid").values()), launches_by_path=paths("auction_bid"),
             max_abs_err=bid["max_abs_err"], ms=bid_main["ms"], plain_ms=bid_main["plain_ms"],
             bound_ms=bid_main["bound_ms"], bound_by=bid_main["bound_by"], library_ms=bid_main["library_ms"],
             shape=bid_main["shape"], shapes=bid["shapes"], matchers_above_128=above),
        dict(name="auction_rounds", route="cuda", source="src/repro_torch/csrc/auction_rounds.cu",
             replaces="src/repro/kernels/auction_bid/kernel.py:22",
             launches=sum(paths("auction_rounds").values()), launches_by_path=paths("auction_rounds"),
             online_warm_launches=by_online["auction_rounds_warm"],
             prices0_cases=online["warm_check_cases"], prices0_max_abs_err=online["warm_check_max_abs_err"],
             max_abs_err=max(rounds["max_abs_err"], online["warm_check_max_abs_err"]), ms=rounds["ms"],
             plain_ms=rounds["plain_ms"],
             bound_ms=rounds["bound_ms"], bound_by=rounds["bound_by"], library_ms=None,
             shape=rounds["shape"], rounds=rounds["rounds"], bids=rounds["bids"],
             matcher_call_ms=rounds["matcher_call_ms"]),
        dict(name="decompose_rounds", route="cuda", source="src/repro_torch/csrc/auction_rounds.cu",
             replaces="src/repro/core/jaxopt/decompose_jax.py (the round loop around kernel.py:22)",
             launches=sum(paths("decompose_rounds").values()), launches_by_path=paths("decompose_rounds"),
             online_warm_launches=by_online["decompose_rounds_warm"],
             max_abs_err=decomp["max_abs_err"], ms=decomp["ms"], plain_ms=decomp["plain_ms"], loop_ms=decomp["loop_ms"],
             bound_ms=decomp["bound_ms"], bound_by=decomp["bound_by"], library_ms=None, shape=decomp["shape"],
             k=decomp["k"], rounds=decomp["rounds"]),
        dict(name="auction_fused", route="cuda", source="src/repro_torch/csrc/auction_fused.cu",
             replaces="src/repro/kernels/auction_fused/kernel.py:55",
             launches=sum(paths("auction_fused").values()), launches_by_path=paths("auction_fused"),
             cluster_launches=sum(paths("auction_fused_cluster").values()),
             online_warm_entries=by_online["auction_fused_warm_entries"],
             max_abs_err=fused["max_abs_err"], ms=fused["ms"], plain_ms=fused["plain_ms"],
             bound_ms=fused["bound_ms"], bound_by=fused["bound_by"], library_ms=None,
             shape=fused["shape"], kernel=fused["kernel"], us_per_round=fused["us_per_round"],
             block_ms=fused["block_ms"], block_us_per_round=fused["block_us_per_round"],
             cluster8_ms=fused["cluster8_ms"], kernel_by_n=fused["kernel_by_n"], rounds=fused["rounds"],
             bids=fused["bids"], bench_speedup_over_auction=bench_numbers["speedup"],
             bench_dispatch_split_ms=bench_numbers["split"]),
        dict(name="polish_2swap", route="cuda", source="src/repro_torch/csrc/auction_fused.cu",
             replaces="src/repro/core/jaxopt/matching.py:367",
             launches=sum(paths("polish_2swap").values()), launches_by_path=paths("polish_2swap"),
             max_abs_err=polish["max_abs_err"], ms=polish["ms"], plain_ms=polish["plain_ms"],
             bound_ms=polish["bound_ms"], bound_by=polish["bound_by"], library_ms=None, shape=polish["shape"],
             cases=polish["cases"]),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=sum(by_path.values()) + entry["examples"]["flash_attention"],
             launches_by_path={**by_path, "examples": entry["examples"]["flash_attention"]},
             max_abs_err=flash["max_abs_err"], ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"], library_ms=flash["library_ms"],
             shape=flash["shape"], dtype=flash["dtype"], shapes=flash["shapes"] + [gpt["flash_f32"]]),
        dict(name="ssd_chunk", route="cuda", source="src/repro_torch/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:25",
             launches=launches["ssd_chunk"] + train_launches["ssd_chunk"] + entry["examples"]["ssd_chunk"],
             launches_by_path={"forward": launches["ssd_chunk"], "train": train_launches["ssd_chunk"],
                               "examples": entry["examples"]["ssd_chunk"]},
             max_abs_err=ssd["max_abs_err"], ms=ssd["ms"], plain_ms=ssd["plain_ms"],
             bound_ms=ssd["bound_ms"], bound_by=ssd["bound_by"], library_ms=None,
             shape=ssd["shape"], chunk=ssd["chunk"], dtype=ssd["dtype"]),
        dict(name="demand_accum", route="cuda", source="src/repro_torch/csrc/demand_accum.cu",
             replaces="src/repro/kernels/demand_accum/kernel.py:24", launches=launches["demand_accum"],
             max_abs_err=accum["max_abs_err"], ms=accum["ms"], plain_ms=accum["plain_ms"],
             bound_ms=accum["bound_ms"], bound_by=accum["bound_by"], library_ms=accum["library_ms"],
             shape=accum["shape"], shapes=accum["shapes"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"online": online["rows"], "online_loops_n512": online["loops"]}))
    print(json.dumps({"serving": {k: v for k, v in serving.items() if k != "launches"}}))
    print(json.dumps({"gpt100m": {k: v for k, v in gpt.items() if k != "launches"}, "sharded_step": sharded,
                      "dryrun": dry}))
    print(json.dumps({"entry_points": {"runtime": runtime_rows, "serve": serve_rows, "online": online_fig,
                                       "scenario_mode_rc": scenario_rc, "roofline": roofline, "examples": examples}}))
    print(json.dumps({"matcher_api": matcher_api}))
    print(json.dumps({"kernels": kernels}))
    check(not bench_failures, f"bench/matching gates: {bench_failures}")
    check(not serve_failures, f"bench/serve gates: {serve_failures}")
    check(scenario_rc == 0, f"bench/scenarios exited {scenario_rc}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
