"""Time design variants of the port's CUDA kernels on one GPU.

    python3 tools/kernel_variants.py [flash|bid|auction|fused|ssd|accum ...] [--rounds 2] [--baseline DIR]

Each variant is the kernel source with a few text substitutions (fewer
warpgroups, no ping-pong, another ring depth or block size, ...) and the
wrapper's options. The script copies ``src/repro_torch/csrc`` for each
variant, applies its substitutions, builds the library from the copy (under
``build/``), checks the result against the plain version and times it, in
turns, ``--rounds`` times, so that every variant is measured on the same card
in the same call. Before the first round it prints each variant kernel's
registers, shared memory and spills from ``nvcc -Xptxas -v``:

- ``flash``: ``flash_attention`` bf16 at zamba2-1.2b's prefill shape
  (2, 32, 4096, 64), causal and not, beside ``scaled_dot_product_attention``;
  held to the plain version at |Δ| ≤ 1e-2 + 1e-2·|ref|.
- ``bid``: ``masked_row_top2`` at (8, 100), (4, 512) and (4, 129) (4-byte
  loads) on random weights, µs a launch in a CUDA graph of 100 launches, at
  256 (as built), 128 or 512 threads a block, and with ``--baseline DIR``
  that tree's op; bit for bit.
- ``auction``: ``auction_rounds`` on the gpt, moe and benchmark buckets'
  first-round weights (forward for gpt, forward-reverse for the others, as
  the matchers run them), held to the plain version bit for bit, at three
  block sizes; and ``tools/auction_rounds_above_128.cu`` in its place (W in
  device memory and L2 above n = 128, a design that does not ship), also on
  ``bench/matching``'s weights at (1, 256), (1, 512) and (1, 1024), forward,
  held to the round loop (``auction_round_loop``) bit for bit, with a
  dispatch of ``match_auction`` on it and of ``match_auction_fused`` timed
  in turns on the host's clock as ``bench/matching`` times them, and the
  speed gate's ratio of the two.
- ``fused``: ``auction_fused`` at the permutations bucket's shape (4, 512),
  its first-round weights (permutations + M-bonus), P = 16, and on
  ``bench/matching``'s weights at (1, 256), (1, 512) and (1, 1024): the
  cluster kernel at 8 and 16 CTAs (and 256 threads a CTA at 16) where W
  fits, the one-block kernel, the wrapper's own pick, and, with ``--baseline DIR`` (the ``csrc`` directory of an earlier
  tree, e.g. ``git archive <commit> src/repro_torch/csrc``), that tree's
  one-block kernel (for a tree from before the packed word, that design); bit
  for bit.
- ``ssd``: ``ssd_chunk`` bf16 at zamba2-1.2b's prefill shape (BH 128,
  S 4096, L 128, N = P = 64): the tensor-core kernel with the hi/lo split,
  without it (reported as failing the rtol/atol 1e-4 gate where it does),
  with two chunks a block (both chunks' loads issued before the first
  chunk's products), and the float32 CUDA-core kernel launched on the bf16
  inputs, which served them before the tensor-core kernel.
- ``accum``: ``demand_accum`` on ``chip_smoke.accum_events``' cases (T = 2²³
  uniform at n = 64, 300 and 512, int64 at 64, 90% of the events on 1% of
  the cells at 64 and 512, and every event on one cell, T = 2¹⁶, at 64), ms
  a call as ``chip_smoke.py`` times it (the wrapper's zeroed output
  included), each held to a float64 sum within 1e-5 of each cell's mass.
  Each variant builds ``demand_accum.cu`` alone (or
  ``tools/demand_accum_clusters.cu``, designs that do not ship: copies
  summed over clusters, rows split over clusters, warp-aggregated adds) and
  calls its launcher through ``ctypes``. With ``--baseline DIR`` it also
  times that tree's kernel (the first port's design) and its split: the event pass
  without the flush, the flush alone (every cell of every copy 1), and the
  global path's loads without their atomics; the shipped design's split
  likewise (the variants named "alone" are not checked).

It needs a CUDA device and ``nvcc``; it prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import backend  # noqa: E402

VARIANTS_DIR = ROOT / "build" / "variants"

NO_PINGPONG = [
    ("auto my_turn = [&]() { hopper::named_sync(1 + wg, 256); };", "auto my_turn = [&]() {};"),
    ("if (wg < kWG - 1 || ++turn < turns) hopper::named_arrive(1 + (wg + 1) % kWG, 256);", ""),
    ("if (wg == kWG - 1 && ntiles > 0) hopper::named_arrive(1, 256);", ""),
]

# The one-launch auction_rounds above n = 128 that does not ship (its header says why).
ABOVE_128 = ROOT / "tools" / "auction_rounds_above_128.cu"

# kernel -> variant name -> (substitutions, options for the wrapper); a
# substitution whose first item is a path replaces the file named second.
VARIANTS = {
    "flash": {
        "as built": ([], {}),
        "2 consumer warpgroups": ([("constexpr int kWG = 3;", "constexpr int kWG = 2;")], {}),
        "no ping-pong": (NO_PINGPONG, {}),
        "3-stage ring": ([("constexpr int kStages = 2;", "constexpr int kStages = 3;")], {}),
        "64-key tiles": ([("launch_bf16<64, 128>(", "launch_bf16<64, 64>(")], {}),
    },
    "bid": {
        "as built": ([], {}),
        **{f"{t} threads a block": ([("constexpr int kThreads = 256;", f"constexpr int kThreads = {t};")], {})
           for t in (128, 512)},
    },
    "auction": {**{f"{t} threads": ([("constexpr int kThreads = 512;", f"constexpr int kThreads = {t};")], {})
                   for t in (512, 256, 1024)},
                "one launch above 128": ([(ABOVE_128, "auction_rounds.cu")], {"above_128": True})},
    "fused": {
        "cluster 8": ([], {"kernel": "cluster", "cluster": 8}),
        "cluster 16": ([], {"kernel": "cluster", "cluster": 16}),
        "cluster 16, 256 threads a CTA": ([("constexpr int kClusterThreads = 512;",
                                            "constexpr int kClusterThreads = 256;")], {"kernel": "cluster", "cluster": 16}),
        "one block": ([], {"kernel": "block"}),
        "as picked": ([], {}),
    },
    "ssd": {
        "tensor cores, hi/lo split (as built)": ([], {}),
        "tensor cores, no split": ([("constexpr bool kSplit = true;", "constexpr bool kSplit = false;")], {}),
        "tensor cores, two chunks a block": ([("constexpr int kChunks = 1;", "constexpr int kChunks = 2;")], {}),
        "CUDA cores, float32 (the earlier bf16 route)": ([("return tc::launch_bf16(", "return launch<__nv_bfloat16>(")], {}),
    },
}
BASELINE = "baseline tree"  # the variant built from --baseline
SOURCE = {"flash": "flash_attention.cu", "bid": "auction_bid.cu", "auction": "auction_rounds.cu", "fused": "auction_fused.cu",
          "ssd": "ssd_chunk.cu", "accum": "demand_accum.cu"}

# demand_accum: variant name -> (the source it starts from, substitutions).
# "baseline" is --baseline's kernel (the first port's), "current" this tree's, and
# "clusters" tools/demand_accum_clusters.cu (the designs that do not ship).
ACCUM_SOURCES = {"current": backend.CSRC_DIR / SOURCE["accum"],
                 "clusters": ROOT / "tools" / "demand_accum_clusters.cu"}
_EVENTS = "  for_each_event(src, dst, w, T, n, head, groups, [&](int c, float v) { atomicAdd(acc + c, v); });"
_ZERO = "smem[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n  __syncthreads();"
_FLUSH = "  __syncthreads();\n  // The copies' sum"


def _knob(name: str, old, new) -> tuple:
    """A substitution of one of the kernel's constexpr knobs."""
    kind = "bool" if isinstance(old, bool) else "int"
    text = {True: "true", False: "false"}
    old, new = (text[v] if kind == "bool" else v for v in (old, new))
    return (f"constexpr {kind} {name} = {old};", f"constexpr {kind} {name} = {new};")


_ROWS_ON = _knob("kMaxRowCluster", 0, 16)
ACCUM_VARIANTS = {
    "baseline as built": ("baseline", []),
    "baseline: event pass alone (no flush)": ("baseline", [("    if (v != 0.0f) atomicAdd(&out[i], v);",
                                                         "    if (v < 0.0f) atomicAdd(&out[i], v);")]),
    "baseline: flush alone (no events)": ("baseline", [("if (cell(src, dst, t, n, &c)) atomicAdd(&acc[c], w[t]);", ""),
                                                     ("acc[i] = 0.0f;", "acc[i] = 1.0f;")]),
    "baseline: global path's loads alone (no atomics)": (
        "baseline", [("if (cell(src, dst, t, n, &c)) atomicAdd(&out[c], w[t]);",
                      "if (cell(src, dst, t, n, &c) && w[t] < 0.0f) out[c] = w[t];")]),
    "as built": ("current", []),
    "event pass alone (no flush)": ("current", [(_FLUSH, "  __syncthreads();\n  if (acc[0] < 0.0f) return;\n"
                                                         "  // The copies' sum")]),
    "flush alone (no events)": ("current", [(_EVENTS, ""), (_ZERO, _ZERO.replace("0.0f", "1.0f"))]),
    "four copies a CTA": ("current", [_knob("kCopies", 8, 4)]),
    "two copies a CTA": ("current", [_knob("kCopies", 8, 2)]),
    "one copy a CTA": ("current", [_knob("kCopies", 8, 1)]),
    "512 threads a CTA": ("current", [_knob("kThreads", 1024, 512)]),
    "one 16-byte group a thread in flight": ("current", [_knob("kUnroll", 2, 1)]),
    "4-byte loads": ("current", [("    groups = (T - h) / 4;", "    groups = 0;")]),
    "two copies, summed by clusters of 2": ("clusters", [_knob("kCopyCluster", 1, 2)]),
    "two copies, summed by clusters of 8": ("clusters", [_knob("kCopyCluster", 1, 8)]),
    "two copies, warp-aggregated adds": ("clusters", [_knob("kAggregate", False, True)]),
    "rows split over clusters above 241, remote atomicAdd": ("clusters", [_ROWS_ON]),
    "rows split over clusters above 241, remote red.shared::cluster": ("clusters", [_ROWS_ON, _knob(
        "kRemoteRed", False, True)]),
}


def event_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copy_tree(key: str, subs, orig: Path) -> Path:
    """A copy of ``orig`` with ``subs`` applied, under ``build/variants/<key>``."""
    src = VARIANTS_DIR / key / "csrc"
    if not src.exists():
        shutil.copytree(orig, src)
        for old, new in subs:
            if isinstance(old, Path):
                shutil.copy(old, src / new)
                continue
            hits = [f for f in src.iterdir() if old in f.read_text()]
            if not hits:
                raise SystemExit(f"substitution not found: {old!r}")
            for f in hits:
                f.write_text(f.read_text().replace(old, new))
    return src


def build(key: str, subs, orig: Path) -> None:
    """Load the library built from a copy of ``orig`` with ``subs`` applied
    (copied and built at first use)."""
    src = copy_tree(key, subs, orig)
    backend.CSRC_DIR, backend.BUILD_DIR = src, src.parent / "lib"
    backend.load_library.cache_clear()
    backend.load_library()


def kernel_name(mangled: str) -> str:
    """``ns::kernel<arg>`` from an Itanium-mangled kernel name."""
    parts, i = [], mangled.find("_ZN") + 3
    while 2 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    tmpl = re.match(r"ILi(\d+)E", mangled[i:])
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL")) or mangled
    return name + (f"<{tmpl.group(1)}>" if tmpl else "")


def ptxas_report(src: Path) -> str:
    """Registers, shared memory and spills of each kernel in ``src``."""
    cmd = [backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(src.with_suffix(".o")), str(src)]
    err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    out, name = [], None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers" + (f", {m.group(2)} bytes static smem" if m.group(2) else ""))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (m.group(1) != "0" or m.group(2) != "0") and name:
            out.append(f"{name}: spills {m.group(1)} / {m.group(2)} bytes")
    return "; ".join(out)


def flash_case():
    from repro_torch.kernels.flash_attention import flash_attention, mha_ref

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 4096, 64), dtype=np.float32)).to("cuda", torch.bfloat16)
               for _ in range(3))
    want = mha_ref(q, k, v, causal=True).float()
    flops = 4.0 * 64 * 64 * (4096 * 4097 / 2)

    def run(opts) -> str:
        got = flash_attention(q, k, v, causal=True).float()
        ok = not bool(((got - want).abs() > 1e-2 + 1e-2 * want.abs()).any())
        ms = event_ms(lambda: flash_attention(q, k, v, causal=True), 30)
        full = event_ms(lambda: flash_attention(q, k, v, causal=False), 10)
        lib = event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), 30)
        return (f"causal {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), non-causal {full:.4f} ms, "
                f"scaled_dot_product_attention {lib:.4f} ms, within tolerance {ok}")
    return run


def bid_case(baseline_lib=None):
    from chip_smoke import graph_ms
    from repro_torch.kernels.auction_bid import masked_row_top2, masked_row_top2_ref

    def baseline(W, p):
        """The baseline tree's op."""
        B, n, m = W.shape
        out = [torch.empty((B, n), device="cuda") for _ in range(2)] + [torch.empty((B, n), dtype=torch.int32,
                                                                                   device="cuda")]
        err = baseline_lib.auction_bid_launch(W.data_ptr(), p.data_ptr(), *(t.data_ptr() for t in out), B, n, m,
                                              backend.current_stream(W))
        if err:
            raise RuntimeError(f"baseline auction_bid_launch: CUDA error {err}")
        return out[0], out[1], out[2]

    rng = np.random.default_rng(0)
    cases = []
    for B, n in ((8, 100), (4, 512), (4, 129)):
        W = torch.from_numpy(rng.random((B, n, n), dtype=np.float32)).cuda()
        p = torch.from_numpy(rng.random((B, n), dtype=np.float32)).cuda()
        cases.append((B, n, W, p, masked_row_top2_ref(W, p)))

    def run(opts) -> str:
        out = []
        for B, n, W, p, want in cases:
            call = baseline if opts is None else masked_row_top2
            ok = all(torch.equal(g, w) for g, w in zip(call(W, p), want))
            us = 1e3 * graph_ms(lambda: call(W, p), 100)
            out.append(f"({B}, {n}) {us:.3f} us a launch in a graph, exact {ok}")
        return "; ".join(out)
    return run


def auction_case():
    from chip_smoke import bonus_weights
    from repro_torch.bench.matching import bench_weights
    from repro_torch.core.torchopt import matching
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_bid import auction_round_loop, auction_rounds, auction_rounds_ref
    from repro_torch.traffic import benchmark_workload, gpt3b_workload, moe_workload

    cases = []
    for name, make, n in (("gpt", gpt3b_workload, 32), ("moe", moe_workload, 64),
                          ("benchmark", benchmark_workload, 100)):
        D = np.stack([make(rng=np.random.default_rng(b)) for b in range(8)])
        W = bonus_weights(torch.from_numpy(D.astype(np.float32)).cuda())
        eps = _eps_schedule(W, default_num_phases(n)).contiguous()
        args = (W, eps, default_max_iters(n))
        rev = name != "gpt"
        cases.append((name, args, rev, auction_rounds_ref(*args, reverse=rev)))
    above = []  # bench/matching's weights, held to the round loop the matchers run there
    for n in (256, 512, 1024):
        W = torch.from_numpy(bench_weights(n)).cuda()[None]
        args = (W, _eps_schedule(W, default_num_phases(n)).contiguous(), default_max_iters(n))
        above.append((f"bench (1, {n})", args, auction_round_loop(*args, reverse=False)))

    def one_launch(W, eps, max_iters, reverse):
        """The variant's launcher, which takes Wᵀ after W."""
        B, n, _ = W.shape
        out = [torch.empty((B, n), dtype=torch.int32, device="cuda") for _ in range(2)]
        out += [torch.empty((B, n), device="cuda"), torch.empty((B,), dtype=torch.int32, device="cuda"),
                torch.empty((B,), dtype=torch.int64, device="cuda")]
        Wt = W.transpose(1, 2).contiguous() if reverse and n > 128 else None
        fn = backend.load_library().auction_rounds_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        err = fn(W.data_ptr(), None if Wt is None else Wt.data_ptr(), eps.data_ptr(), None,
                 *(t.data_ptr() for t in out), B, n, eps.shape[1], int(max_iters), int(reverse),
                 backend.current_stream(W))
        if err:
            raise RuntimeError(f"auction_rounds_launch: CUDA error {err}")
        return out[0].long(), out[1].long(), out[2], out[3].long(), out[4]

    def auction_dispatch(W):
        """match_auction with its rounds in the variant's one launch."""
        W, n, num_phases, max_iters = matching._prepare(W, None, None)
        r2c, c2r, prices, rounds, _ = one_launch(W, matching._eps_schedule(W, num_phases).contiguous(),
                                                 max_iters, False)
        return matching.MatchResult(matching._complete_greedy(r2c, c2r), (r2c >= 0).all(dim=1), prices, rounds)

    def host_ms(fn) -> float:
        """ms of one call and a sync on the host's clock (as bench/matching times a dispatch)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def run(opts) -> str:
        call = one_launch if opts.get("above_128") else auction_rounds
        out = []
        for name, args, rev, want in cases:
            got = call(*args, reverse=rev)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = event_ms(lambda: call(*args, reverse=rev), 5)
            out.append(f"{name} {ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round), exact {ok}")
        if not opts.get("above_128"):
            return "; ".join(out)
        for name, args, want in above:
            W = args[0]
            got = one_launch(*args, reverse=False)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = event_ms(lambda: one_launch(*args, reverse=False), 5)
            auction_dispatch(W), matching.match_auction_fused(W)  # first calls
            a, f = [], []
            for _ in range(5):  # in turns, as the gate compares them
                a.append(host_ms(lambda: auction_dispatch(W)))
                f.append(host_ms(lambda: matching.match_auction_fused(W)))
            out.append(f"{name} kernel {ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round), == round loop "
                       f"{ok}; a dispatch (mean of 5, host clock) auction {np.mean(a):.3f} ms, auction_fused "
                       f"{np.mean(f):.3f} ms: auction_fused over auction {np.mean(a) / np.mean(f):.2f}x")
        return "; ".join(out)
    return run


def fused_case(baseline_lib=None):
    from chip_smoke import bonus_weights
    from repro_torch.bench.matching import bench_weights
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.kernels.auction_fused.ops import fused_kernel_for
    from repro_torch.traffic import permutations_workload

    D = np.stack([permutations_workload(n=512, k=16, rng=np.random.default_rng(b)) for b in range(4)])
    shapes = [("permutations (4, 512)", bonus_weights(torch.from_numpy(D.astype(np.float32)).cuda()))]
    shapes += [(f"bench (1, {n})", torch.from_numpy(bench_weights(n)).cuda()[None]) for n in (256, 512, 1024)]
    cases = []
    for name, W in shapes:
        B, n, _ = W.shape
        eps = _eps_schedule(W, default_num_phases(n)).contiguous()
        p0 = torch.zeros((B, n), device="cuda")
        mi = default_max_iters(n)
        cases.append((name, W, p0, eps, mi, fused_auction_ref(W, p0, eps, max_iters=mi)))

    def baseline(W, p0, eps, mi):
        """The baseline tree's one-block kernel (launcher without ``cluster``)."""
        B, n, _ = W.shape
        out = [torch.empty((B, n), dtype=torch.int32, device="cuda") for _ in range(2)]
        out += [torch.empty((B, n), device="cuda"), torch.empty((B,), dtype=torch.int32, device="cuda"),
                torch.empty((B,), dtype=torch.int64, device="cuda")]
        err = baseline_lib.auction_fused_launch(W.data_ptr(), p0.data_ptr(), eps.data_ptr(),
                                                *(t.data_ptr() for t in out), B, n, eps.shape[1], mi,
                                                backend.current_stream(W))
        if err:
            raise RuntimeError(f"baseline auction_fused_launch: CUDA error {err}")
        return out

    def run(opts) -> str:
        out = []
        for name, W, p0, eps, mi, want in cases:
            n = W.shape[1]
            if opts and opts["kernel"] == "cluster" and fused_kernel_for(n, opts["cluster"]) != "cluster":
                out.append(f"{name} does not fit")
                continue
            call = ((lambda: baseline(W, p0, eps, mi)) if opts is None
                    else (lambda: fused_auction(W, p0, eps, max_iters=mi, **opts)))
            got = call()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = event_ms(call, 3)
            out.append(f"{name} {ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round of the longest "
                       f"lane), exact {ok}")
        return "; ".join(out)
    return run


def ssd_case():
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref

    rng = np.random.default_rng(0)
    BH, S, N, P, L = 128, 4096, 64, 64, 128
    xd = torch.from_numpy(rng.standard_normal((BH, S, P), dtype=np.float32)).to("cuda", torch.bfloat16)
    loga = torch.from_numpy((-0.5 * rng.random((BH, S))).astype(np.float32)).cuda()
    B, C = (torch.from_numpy((rng.standard_normal((BH, S, N)) / np.sqrt(N)).astype(np.float32)).to("cuda", torch.bfloat16)
            for _ in range(2))
    want = ssd_chunk_ref(xd, loga, B, C, L)

    def run(opts) -> str:
        got = ssd_chunk(xd, loga, B, C, L)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(torch.allclose(g, w, rtol=1e-4, atol=1e-4) for g, w in zip(got, want))
        ms = event_ms(lambda: ssd_chunk(xd, loga, B, C, L), 20)
        return f"{ms:.4f} ms, max |Δ| {err:.3g}, within rtol/atol 1e-4 {ok}"
    return run


def accum_variants(rounds: int, baseline: Path | None) -> None:
    """The ``accum`` variants: each ``demand_accum.cu`` built alone (all
    variants' ``nvcc`` at once) and called through ``ctypes``."""
    from chip_smoke import accum_events
    from repro_torch.kernels.demand_accum import in_range

    variants = {k: v for k, v in ACCUM_VARIANTS.items() if v[0] != "baseline" or baseline is not None}
    libs, procs = {}, []
    for i, (name, (base, subs)) in enumerate(variants.items()):
        d = VARIANTS_DIR / f"accum{i}"
        d.mkdir(parents=True, exist_ok=True)
        text = (baseline / SOURCE["accum"] if base == "baseline" else ACCUM_SOURCES[base]).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"substitution not found in {name!r}: {old!r}")
            text = text.replace(old, new)
        (d / SOURCE["accum"]).write_text(text)
        libs[name] = d / "libaccum.so"
        cmd = [backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(libs[name]),
               str(d / SOURCE["accum"])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"accum [{name}]: nvcc failed\n{err}")
        regs = "; ".join(f"{kernel_name(m.group(1))}: {m.group(3)} registers, spills {m.group(2)}" for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+ bytes spill stores, \d+ bytes spill loads).*?Used (\d+) registers",
            err, re.S))
        print(f"accum [{name}] ptxas: {regs}", flush=True)
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).demand_accum_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for kind, T, n in (("uniform", 1 << 23, 64), ("uniform", 1 << 23, 512), ("uniform", 1 << 23, 300),
                       ("uniform int64", 1 << 23, 64), ("skewed", 1 << 23, 64), ("skewed", 1 << 23, 512),
                       ("one cell", 1 << 16, 64)):
        src, dst, w = accum_events(kind, T, n, gen)
        keep = in_range(src, dst, n)
        idx = (src[keep].long(), dst[keep].long())
        exact = torch.zeros((n, n), dtype=torch.float64, device="cuda").index_put_(idx, w[keep].double(),
                                                                                   accumulate=True)
        mass = torch.zeros((n, n), dtype=torch.float64, device="cuda").index_put_(idx, w[keep].double().abs(),
                                                                                  accumulate=True)
        cases.append((f"{kind} T={T} n={n}", src, dst, w, n, exact, mass))

    def call(fn, src, dst, w, n):
        out = torch.zeros((n, n), dtype=torch.float32, device="cuda")
        err = fn(src.data_ptr(), dst.data_ptr(), w.data_ptr(), out.data_ptr(), src.shape[0], n,
                 int(src.dtype == torch.int64), backend.current_stream(src))
        if err:
            raise RuntimeError(f"demand_accum_launch: CUDA error {err}")
        return out

    for r in range(rounds):
        for name, fn in fns.items():
            out = []
            for label, src, dst, w, n, exact, mass in cases:
                got = call(fn, src, dst, w, n)
                torch.cuda.synchronize()
                ok = "split, not checked" if "alone" in name else (
                    f"within 1e-5 of the cell mass {bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all())}")
                ms = event_ms(lambda: call(fn, src, dst, w, n), 20)
                out.append(f"{label} {ms:.4f} ms ({ok})")
            print(f"accum round {r} [{name}]: " + "; ".join(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help=f"any of {', '.join(VARIANTS)}, accum (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", type=Path,
                    help="csrc directory of an earlier tree (fused: its one-block kernel; bid: its op)")
    args = ap.parse_args()
    if set(args.kernels) - set(VARIANTS) - {"accum"}:
        ap.error(f"unknown kernels {sorted(set(args.kernels) - set(VARIANTS) - {'accum'})}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    orig = backend.CSRC_DIR
    shutil.rmtree(VARIANTS_DIR, ignore_errors=True)  # copies of an earlier tree would be stale
    baseline_lib = None
    if args.baseline:
        backend.CSRC_DIR, backend.BUILD_DIR = args.baseline.resolve(), VARIANTS_DIR / "baseline" / "lib"
        baseline_lib = ctypes.CDLL(str(backend.build_library()))
        baseline_lib.auction_fused_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        baseline_lib.auction_fused_launch.restype = ctypes.c_int
        baseline_lib.auction_bid_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        baseline_lib.auction_bid_launch.restype = ctypes.c_int
        backend.CSRC_DIR, backend.BUILD_DIR = orig, VARIANTS_DIR / "lib"
    runners = {"flash": flash_case, "bid": lambda: bid_case(baseline_lib), "auction": auction_case, "fused": lambda: fused_case(baseline_lib),
               "ssd": ssd_case}
    for kernel in args.kernels or [*VARIANTS, "accum"]:
        if kernel == "accum":
            accum_variants(args.rounds, args.baseline.resolve() if args.baseline else None)
            continue
        variants = dict(VARIANTS[kernel])
        if kernel in ("fused", "bid") and baseline_lib is not None:
            variants[BASELINE] = ([], None)
        for i, (name, (subs, _)) in enumerate(variants.items()):
            src = args.baseline.resolve() if name == BASELINE else copy_tree(f"{kernel}{i}", subs, orig)
            print(f"{kernel} [{name}] ptxas: {ptxas_report(src / SOURCE[kernel])}", flush=True)
        run = runners[kernel]()
        for r in range(args.rounds):
            for i, (name, (subs, opts)) in enumerate(variants.items()):
                if name != BASELINE:
                    build(f"{kernel}{i}", subs, orig)
                print(f"{kernel} round {r} [{name}]: {run(opts)}", flush=True)
    backend.CSRC_DIR = orig


if __name__ == "__main__":
    main()
