"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and holds each one against its plain PyTorch
   version on the card: the auction kernels exactly (``auction_rounds``, a
   whole matcher call in one launch, on the solver workloads' weights and on
   tie-rich ones, forward and forward-reverse, with the round budget cut
   too; ``auction_fused``, the thread block cluster kernel at n ≤ 645 and
   the one-block kernel above, both at n = 512), ``flash_attention``
   (bfloat16 on the tensor cores, float32 on the CUDA cores) and
   ``ssd_chunk`` (bfloat16 on the tensor cores, float32 on the CUDA cores)
   to stated tolerances (at the forward's and the training's shapes, flash
   also at qwen3-moe's GQA 32:4, qwen2-vl's 12:2 and whisper's non-causal
   encoder and cross-attention shapes),
   ``demand_accum`` against a float64
   sum and its plain version within 1e-5 / 2e-5 of each cell's mass (float
   atomics change the sum's order from run to run). It times kernel, plain
   version and, where one exists, a single PyTorch call computing the same
   function.
2. Drives the solver's path, ``repro_torch.api.solve_many(...,
   solver="spectra_torch")``, on four shape buckets (gpt n=32, moe n=64,
   benchmark n=100, permutations n=512): one warm-up run of the gpt bucket,
   then one timed run of each bucket with the kernels' launch counters set
   to 0 just before it. Every report must validate (Eq. 3 at 1e-4),
   converge, respect its §IV lower bound and finish EQUALIZE on the device;
   gpt, moe and benchmark must launch ``auction_rounds`` and no
   ``masked_row_top2`` (no round-by-round loop), permutations only the
   cluster ``auction_fused`` kernel; the gpt bucket must also agree with the
   port's plain CPU path to 1e-4. One more run of the permutations bucket
   times every ``auction_fused`` call with CUDA events, splitting the
   bucket's wall into the kernel and the rest.
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
   trace written to the temp dir. All three auction kernels must launch.
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
10. Prints one ``{"kernels": [...]}`` line (launches split by path for
   the auction kernels and ``flash_attention``) and, last, the ``{"ok": true, "device": {...}}`` line.
   Any failed check exits non-zero.

Without a CUDA device, or without the repository beside it, it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
    for B, n in [(8, 32), (8, 64), (8, 100), (4, 128), (4, 160), (4, 256), (4, 512)]:
        # The widths the round loop serves above 128 draw from their
        # own stream, so the earlier shapes and phases keep their inputs.
        r = rng if n <= 128 else np.random.default_rng([17, n])
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
          f"(4,512), random and tie-rich, W and W.T")

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


def phase_fused(rng) -> dict:
    """auction_fused against fused_auction_ref, bit for bit in r2c, c2r,
    prices, rounds and bids, on permutations + M-bonus weights at (B, n) in
    (4, 100), (4, 256), (4, 512) and (1, 1024), each on the kernel the wrapper
    picks for n (the cluster kernel up to n = 645, the one-block kernel
    above), and the one-block kernel at n = 512 too. The n = 512 call is timed
    on both kernels (CUDA events around eager calls), with µs a round of the
    longest lane: a round is a chain of dependent steps, so rounds × a round's
    latency, not the bytes or the flops, bounds the kernel."""
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.kernels.auction_fused.ops import fused_kernel_for
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
        kernel = served[n] = fused_kernel_for(n)
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
            block = fused_auction(W, p0, eps, max_iters=mi, kernel="block")
            for name, g, w in zip(("r2c", "c2r", "prices", "rounds", "bids"), block, want):
                check(torch.equal(g, w), f"auction_fused (block kernel) {name} B={B} n={n} differs from its plain version")
            print(f"auction_fused B={B} n={n}, block kernel: kernel == plain version exactly")
            ms = cuda_ms(lambda: fused_auction(W, p0, eps, max_iters=mi), 5, warmup=1)
            block_ms = cuda_ms(lambda: fused_auction(W, p0, eps, max_iters=mi, kernel="block"), 5, warmup=1)
            longest = int(got[3].max())
            P = eps.shape[1]
            nbytes = 4.0 * (B * n * n + B * n + B * P + 3 * B * n + B) + 8.0 * B
            b_ms, b_by = bound(nbytes, 2.0 * n * float(got[4].sum()))
            timed = dict(shape=[B, n, n], kernel=kernel, ms=ms, us_per_round=ms * 1e3 / longest, block_ms=block_ms,
                         block_us_per_round=block_ms * 1e3 / longest, plain_ms=plain_s * 1e3, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by, rounds=got[3].tolist(), bids=got[4].tolist())
            print(f"auction_fused B={B} n={n}: {kernel} kernel {ms:.3f} ms ({ms * 1e3 / longest:.3f} us a round of "
                  f"the longest lane, {longest} rounds), block kernel {block_ms:.3f} ms "
                  f"({block_ms * 1e3 / longest:.3f} us a round), plain {plain_s * 1e3:.1f} ms, "
                  f"bound {b_ms * 1e3:.3f} us ({b_by})")
    timed["max_abs_err"] = max_err
    timed["kernel_by_n"] = served
    return timed


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps: the work an exact kernel needs."""
    total = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(Sk - 1, qpos) if causal else Sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


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
                flops = 4.0 * D * B * Hq * attended_pairs(Sq, Sk, True, None)
                b_ms, b_by = bound(2.0 * 2 * (B * Hq * Sq * D + B * Hkv * Sk * D), flops, BF16_FLOPS)
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
                flops = 4.0 * D * B * Hq * attended_pairs(Sq, Sk, True, None)
                b_ms, b_by = bound(2.0 * 2 * (B * Hq * Sq * D + B * Hkv * Sk * D), flops, BF16_FLOPS)
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
                nc = S // L
                flops = BH * nc * (L * (L + 1) / 2 * 2 * (N + P) + 2.0 * L * N * P)
                nbytes = BH * S * (2.0 * (P + 2 * N) + 4 + 4 * P) + 4.0 * BH * nc * (N * P + 1)
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
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


def phase_demand_accum(rng) -> dict:
    """demand_accum against a float64 sum and its plain version. Float
    atomics sum in an order that changes from run to run, so the kernel must
    lie within 1e-5 of each cell's mass Σ|w| (plus 1e-30) of the float64 sum
    of the same events, and within twice that of the plain version (each of
    the two lies within 1e-5 of the exact sum)."""
    from repro_torch.kernels.demand_accum import demand_accum, demand_accum_ref, in_range

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))

    def uniform(T, n, lo=0, hi=None):
        hi = n if hi is None else hi
        return (torch.randint(lo, hi, (T,), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(lo, hi, (T,), generator=gen, device=dev, dtype=torch.int32),
                torch.rand((T,), generator=gen, device=dev))

    cases = [  # name, n, (src, dst, w)
        ("uniform T=2^23", 64, uniform(1 << 23, 64)),
        ("uniform T=2^23", 512, uniform(1 << 23, 512)),
        ("T=1000", 64, uniform(1000, 64)),
        ("one cell T=2^16", 64, (torch.full((1 << 16,), 21, dtype=torch.int32, device=dev),
                                 torch.full((1 << 16,), 42, dtype=torch.int32, device=dev),
                                 torch.rand((1 << 16,), generator=gen, device=dev))),
        ("out of range T=2^20", 130, uniform(1 << 20, 130, -5, 135)),
        ("out of range T=2^20", 512, uniform(1 << 20, 512, -5, 517)),
    ]
    max_err, shapes = 0.0, []
    for name, n, (src, dst, w) in cases:
        got = demand_accum(src, dst, w, n=n)
        torch.cuda.synchronize()
        keep = in_range(src, dst, n)
        idx = (src[keep].long(), dst[keep].long())
        exact = torch.zeros((n, n), dtype=torch.float64, device=dev).index_put_(idx, w[keep].double(), accumulate=True)
        mass = torch.zeros((n, n), dtype=torch.float64, device=dev).index_put_(idx, w[keep].double().abs(),
                                                                               accumulate=True)
        plain = demand_accum_ref(src, dst, w, n)
        err_exact = float(((got.double() - exact).abs() / (mass + 1e-30)).max())
        err_plain = float(((plain.double() - exact).abs() / (mass + 1e-30)).max())
        check(bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all()),
              f"demand_accum {name} n={n}: kernel off the float64 sum by {err_exact} of the cell mass")
        check(bool(((got.double() - plain.double()).abs() <= 2e-5 * mass + 1e-30).all()),
              f"demand_accum {name} n={n}: kernel differs from its plain version beyond 2e-5 of the cell mass")
        max_err = max(max_err, float((got - plain).abs().max()))
        print(f"demand_accum {name} n={n}: kernel within {err_exact:.3g} of the cell mass of the float64 sum "
              f"(plain version {err_plain:.3g}), max |kernel − plain| {float((got - plain).abs().max()):.3g}")
        if name.startswith("uniform"):
            T = src.shape[0]
            ms = cuda_ms(lambda: demand_accum(src, dst, w, n=n), 20)
            plain_ms = cuda_ms(lambda: demand_accum_ref(src, dst, w, n), 5, warmup=1)
            flat = (src[keep].long() * n + dst[keep].long()).contiguous()
            wk = w[keep].contiguous()
            lib_ms = cuda_ms(lambda: torch.bincount(flat, weights=wk, minlength=n * n), 20)
            b_ms, b_by = bound(12.0 * T + 4.0 * n * n, float(T))
            shapes.append(dict(shape=[T, n], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                               bound_by=b_by))
            print(f"demand_accum T={T} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bincount "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
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
    from repro_torch.kernels.auction_bid import auction_rounds, masked_row_top2
    from repro_torch.kernels.auction_fused import fused_auction

    launches = {"auction_bid": 0, "auction_rounds": 0, "auction_fused": 0, "auction_fused_cluster": 0}
    for i, (name, matcher, Ds) in enumerate(buckets(seed)):
        if i == 0:
            solve_many(Ds, 4, 0.01, solver="spectra_torch")  # warm-up (first use of every piece)
        masked_row_top2.launches = auction_rounds.launches = fused_auction.launches = 0
        fused_auction.cluster_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = solve_many(Ds, 4, 0.01, solver="spectra_torch")
        wall_ms = (time.perf_counter() - t0) * 1e3
        bid, rounds_l, fused = masked_row_top2.launches, auction_rounds.launches, fused_auction.launches
        cluster = fused_auction.cluster_launches
        launches["auction_bid"] += bid
        launches["auction_rounds"] += rounds_l
        launches["auction_fused"] += fused
        launches["auction_fused_cluster"] += cluster
        for b, rep in enumerate(reports):
            check(rep.validated, f"{name}[{b}] not validated")
            check(rep.extras["matcher"] == matcher, f"{name}[{b}] used {rep.extras['matcher']}, expected {matcher}")
            check(rep.extras["converged"], f"{name}[{b}] matcher did not converge")
            check(not rep.extras["eq_exhausted"], f"{name}[{b}] EQUALIZE ran out of slots")
            check(np.isfinite(rep.makespan) and rep.makespan >= rep.lower_bound * (1 - 1e-6),
                  f"{name}[{b}] makespan {rep.makespan} below its lower bound {rep.lower_bound}")
        got = (bid, rounds_l, fused)
        if matcher == "auction_fused":
            check(fused > 0 and cluster == fused and bid == 0 and rounds_l == 0,
                  f"{name}: expected launches of the cluster auction_fused kernel only, got bid/rounds/fused "
                  f"{got}, of which cluster {cluster}")
        else:
            check(rounds_l > 0 and bid == 0 and fused == 0, f"{name}: expected auction_rounds launches only, got "
                                                            f"bid/rounds/fused {got}")
        rounds = sum(r.extras["bidding_rounds"] for r in reports)
        ratio = float(np.mean([r.makespan / r.lower_bound for r in reports]))
        print(f"bucket {name} B={len(Ds)} n={Ds.shape[-1]} matcher={matcher}: wall {wall_ms:.1f} ms, "
              f"bidding rounds {rounds}, launches bid={bid} rounds={rounds_l} fused={fused} (cluster kernel "
              f"{cluster}), mean makespan/LB {ratio:.4f}")
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
    3. ``torch_auction`` at n = 256 with its default ``matcher="auction"``: the
       round loop, ``masked_row_top2`` a round.
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

    masked_row_top2.launches = auction_rounds.launches = fused_auction.launches = 0
    fused_auction.cluster_launches = 0
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
    check(set(totals) == {"solve_many", "bucket", "torch.dispatch", "torch.collect"}, f"spans {sorted(totals)}")
    trace_path = tracer.save(Path(tempfile.gettempdir()) / "repro_torch_solver_trace.json")
    tracer.reset()
    print(f"traced permutations bucket n=512 B={len(Ds)} (device_sync): wall {traced_wall:.1f} ms; span totals "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in totals.items()) + f"; Chrome trace {trace_path}")

    launches = {"auction_bid": masked_row_top2.launches, "auction_rounds": auction_rounds.launches,
                "auction_fused": fused_auction.launches, "auction_fused_cluster": fused_auction.cluster_launches}
    check(all(launches[k] > 0 for k in ("auction_bid", "auction_rounds", "auction_fused")),
          f"solver layer launches {launches}")
    print(f"solver layer: {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return dict(launches=launches, ratios=ratios, walls_s=walls, worst_rel=worst, wall256_ms=wall256,
                wall512_ms=wall512, traced_wall_ms=traced_wall, span_ms=totals)


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

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.demand_accum import demand_accum

    rng = np.random.default_rng(args.seed)
    bid = phase_bid(rng)
    rounds = phase_rounds(rng)
    fused = phase_fused(rng)
    flash = phase_flash(rng)
    ssd = phase_ssd(rng)
    accum = phase_demand_accum(rng)
    demand_accum.launches = 0  # no system path runs it: read after the last one
    t0 = time.perf_counter()
    launches = phase_main_path(args.seed)
    print(f"solver path: {time.perf_counter() - t0:.1f} s")
    check(launches["auction_rounds"] > 0 and launches["auction_fused"] > 0 and launches["auction_bid"] == 0,
          f"main path launches {launches}")
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
    launches["demand_accum"] = demand_accum.launches

    bid_main = bid["shapes"][3]  # (4, 512): the widest the round loop serves on the solver layer's path
    by_layer = layer["launches"]

    def paths(key: str) -> dict:
        return {"solver_buckets": launches[key], "solver_layer": by_layer[key]}

    kernels = [
        dict(name="auction_bid", route="cuda", source="src/repro_torch/csrc/auction_bid.cu",
             replaces="src/repro/kernels/auction_bid/kernel.py:22",
             launches=launches["auction_bid"] + by_layer["auction_bid"], launches_by_path=paths("auction_bid"),
             max_abs_err=bid["max_abs_err"], ms=bid_main["ms"], plain_ms=bid_main["plain_ms"],
             bound_ms=bid_main["bound_ms"], bound_by=bid_main["bound_by"], library_ms=bid_main["library_ms"],
             shape=bid_main["shape"], shapes=bid["shapes"], matchers_above_128=above),
        dict(name="auction_rounds", route="cuda", source="src/repro_torch/csrc/auction_rounds.cu",
             replaces="src/repro/kernels/auction_bid/kernel.py:22",
             launches=launches["auction_rounds"] + by_layer["auction_rounds"], launches_by_path=paths("auction_rounds"),
             max_abs_err=rounds["max_abs_err"], ms=rounds["ms"], plain_ms=rounds["plain_ms"],
             bound_ms=rounds["bound_ms"], bound_by=rounds["bound_by"], library_ms=None,
             shape=rounds["shape"], rounds=rounds["rounds"], bids=rounds["bids"],
             matcher_call_ms=rounds["matcher_call_ms"]),
        dict(name="auction_fused", route="cuda", source="src/repro_torch/csrc/auction_fused.cu",
             replaces="src/repro/kernels/auction_fused/kernel.py:55",
             launches=launches["auction_fused"] + by_layer["auction_fused"], launches_by_path=paths("auction_fused"),
             cluster_launches=launches["auction_fused_cluster"] + by_layer["auction_fused_cluster"],
             max_abs_err=fused["max_abs_err"], ms=fused["ms"], plain_ms=fused["plain_ms"],
             bound_ms=fused["bound_ms"], bound_by=fused["bound_by"], library_ms=None,
             shape=fused["shape"], kernel=fused["kernel"], us_per_round=fused["us_per_round"],
             block_ms=fused["block_ms"], block_us_per_round=fused["block_us_per_round"],
             kernel_by_n=fused["kernel_by_n"], rounds=fused["rounds"], bids=fused["bids"]),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=sum(by_path.values()), launches_by_path=by_path,
             max_abs_err=flash["max_abs_err"], ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"], library_ms=flash["library_ms"],
             shape=flash["shape"], dtype=flash["dtype"], shapes=flash["shapes"]),
        dict(name="ssd_chunk", route="cuda", source="src/repro_torch/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:25",
             launches=launches["ssd_chunk"] + train_launches["ssd_chunk"],
             launches_by_path={"forward": launches["ssd_chunk"], "train": train_launches["ssd_chunk"]},
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
