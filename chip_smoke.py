"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and holds each one against its plain PyTorch
   version on the card: the auction kernels exactly, ``flash_attention`` and
   ``ssd_chunk`` to stated tolerances in float32 and bfloat16 (at the
   forward's and the training's shapes), ``demand_accum`` against a float64
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
   the gpt bucket must also agree with the port's plain CPU path to 1e-4.
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
7. Prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line. Any failed check exits non-zero.

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
    """flash_attention against mha_ref: float32 to accumulation order (atol
    1e-4), bfloat16 to the output's rounding (|Δ| ≤ 1e-2 + 1e-2·|ref|, about
    two bf16 ulps of the output)."""
    from repro_torch.kernels.flash_attention import flash_attention, mha_ref

    tol = {torch.float32: dict(rtol=0.0, atol=1e-4), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
    cases = [  # B, Hq, Hkv, Sq, Sk, D, causal, window
        (2, 32, 32, 4096, 4096, 64, True, None),  # zamba2-1.2b prefill
        (2, 32, 32, 2048, 2048, 64, True, None),  # zamba2-1.2b training
        (1, 8, 2, 512, 512, 128, True, None),      # GQA 4:1
        (1, 4, 4, 1024, 1024, 64, True, 64),       # sliding window
        (1, 8, 2, 256, 1024, 64, True, None),      # Sq < Sk
        (1, 4, 2, 77, 77, 32, False, None),        # ragged tiles, no mask
    ]
    max_err, timed = 0.0, None
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
            if (B, Sq, dtype) == (2, 4096, torch.bfloat16):
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
    timed["max_abs_err"] = max_err
    return timed


def phase_ssd(rng) -> dict:
    """ssd_chunk against ssd_chunk_ref: both compute in float32 from the same
    inputs, so rtol/atol 1e-4 covers the sum order in both types."""
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
        if "ssd_chunk" in name:
            group = "ssd_chunk"
        elif "flash_attention" in name:
            group = "flash_attention"
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
            group = "matmul (cuBLAS)"
        else:
            group = "other (elementwise, copies, reductions)"
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((e.key[:90], ms, e.count))
    return groups, sorted(kernels, key=lambda k: -k[1])[:10]


def decode_vs_forward(model, engine, prompts):
    """Serve ``prompts`` (32 new tokens, greedy) and replay the forward on the
    tokens it produced (teacher forcing). Returns (result, wall ms, ‖Δ‖/‖ref‖,
    the forward's logits, the kernel launches of the decode alone)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk

    flash_attention.launches = ssd_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(prompts, 32, keep_logits=True)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches}
    with torch.inference_mode():
        forced = model.apply({"tokens": torch.from_numpy(res.tokens[:, :-1]).cuda()})["logits"]
    check(bool(torch.isfinite(res.logits).all()), "decode logits not finite")
    return res, wall_ms, float((res.logits - forced).norm() / forced.norm()), forced, launches


def phase_zamba2(seed: int) -> dict:
    """The LM's path at full size: the forward, then the decode server."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models import build_model, concrete_inputs
    from repro_torch.serve import DecodeEngine

    cfg = get_arch("zamba2-1.2b")
    model = build_model(cfg, seed=seed)
    print(f"zamba2-1.2b: {model.param_count() / 1e9:.3f} B parameters in {cfg.dtype}, {cfg.num_layers} Mamba-2 "
          f"layers, shared attention after every {cfg.attn_every}")
    B, S = 2, 4096
    batch = concrete_inputs(cfg, ShapeCfg("prefill_4k", S, B, "prefill"), seed=seed)
    with torch.inference_mode():
        model.apply(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = ssd_chunk.launches = 0
        t0 = time.perf_counter()
        logits = model.apply(batch)["logits"]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches, "ssd_chunk": ssd_chunk.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == {"flash_attention": 6, "ssd_chunk": 38}, f"zamba2 forward launches {launches}, expected 6 and 38")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"zamba2 forward logits {tuple(logits.shape)} not finite or of the wrong shape")
    print(f"zamba2-1.2b forward B={B} S={S} bf16: wall {wall_ms:.1f} ms, {B * S / wall_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB, launches {launches}")
    del logits
    groups, top = device_time_by_kernel(model, batch)
    busy = sum(groups.values())
    print("zamba2-1.2b forward, device time by kernel (torch.profiler, one more forward): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; busy {busy:.1f} ms of the {wall_ms:.1f} ms wall (idle share {1 - busy / wall_ms:.3f})")
    for name, ms, count in top:
        print(f"  {ms:8.2f} ms  {count:5d} launches  {name}")

    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    engine = DecodeEngine(model, max_len=128)
    engine.generate(prompts[:, :4], 2)  # warm-up
    res, wall_ms, rel, forced, decode_launches = decode_vs_forward(model, engine, prompts)
    steps = res.logits.shape[1]
    check(res.tokens.shape == (4, 96) and (res.tokens[:, :64] == prompts).all()
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(), "decode: bad tokens")
    agree = float((res.logits.argmax(-1) == forced.argmax(-1)).float().mean())
    print(f"zamba2-1.2b DecodeEngine bf16: 4 requests, prompt 64, 32 new tokens, greedy: {steps} decode steps in "
          f"{wall_ms:.1f} ms ({wall_ms / steps:.2f} ms per step), kernel launches while decoding "
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
        name = e.key.lower()
        if "ssd_chunk" in name:
            group = "ssd_chunk"
        elif "flash_attention" in name:
            group = "flash_attention"
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
            group = "matmul (cuBLAS)"
        elif "multi_tensor" in name or "foreach" in name:
            group = "optimizer (foreach)"
        else:
            group = "other (elementwise, copies, reductions)"
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
    for i, (name, matcher, Ds) in enumerate(buckets(seed)):
        if i == 0:
            solve_many(Ds, 4, 0.01, solver="spectra_torch")  # warm-up (first use of every piece)
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

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.demand_accum import demand_accum

    rng = np.random.default_rng(args.seed)
    bid = phase_bid(rng)
    fused = phase_fused(rng)
    flash = phase_flash(rng)
    ssd = phase_ssd(rng)
    accum = phase_demand_accum(rng)
    demand_accum.launches = 0  # no system path runs it: read after the last one
    t0 = time.perf_counter()
    launches = phase_main_path(args.seed)
    print(f"solver path: {time.perf_counter() - t0:.1f} s")
    check(launches["auction_bid"] > 0 and launches["auction_fused"] > 0, f"main path launches {launches}")
    t0 = time.perf_counter()
    phase_model_parity(args.seed)
    launches.update(phase_zamba2(args.seed))
    print(f"LM phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_parity(args.seed)
    train_launches = phase_train(args.seed)
    print(f"training phases: {time.perf_counter() - t0:.1f} s")
    launches["demand_accum"] = demand_accum.launches

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
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=launches["flash_attention"] + train_launches["flash_attention"],
             launches_by_path={"forward": launches["flash_attention"], "train": train_launches["flash_attention"]},
             max_abs_err=flash["max_abs_err"], ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"], library_ms=flash["library_ms"],
             shape=flash["shape"], dtype=flash["dtype"]),
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
