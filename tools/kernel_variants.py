"""Time design variants of the port's CUDA kernels on one GPU.

    python3 tools/kernel_variants.py [flash|auction|fused|ssd ...] [--rounds 2] [--baseline DIR]

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
- ``auction``: ``auction_rounds`` on the gpt, moe and benchmark buckets'
  first-round weights (forward for gpt, forward-reverse for the others, as
  the matchers run them); held to the plain version bit for bit.
- ``fused``: ``auction_fused`` at the permutations bucket's shape (4, 512),
  its first-round weights (permutations + M-bonus), P = 16: the cluster
  kernel at 8 and 16 CTAs and 512 or 1024 threads a CTA, the one-block
  kernel, and, with ``--baseline DIR`` (the ``csrc`` directory of an earlier
  tree, e.g. ``git archive <commit> src/repro_torch/csrc``), that tree's
  one-block kernel (for a tree from before the packed word, that design); bit
  for bit.
- ``ssd``: ``ssd_chunk`` bf16 at zamba2-1.2b's prefill shape (BH 128,
  S 4096, L 128, N = P = 64): the tensor-core kernel with the hi/lo split,
  without it (reported as failing the rtol/atol 1e-4 gate where it does),
  with two chunks a block (both chunks' loads issued before the first
  chunk's products), and the float32 CUDA-core kernel launched on the bf16
  inputs, which served them before the tensor-core kernel.

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

CLUSTER_1024 = [("constexpr int kClusterThreads = 512;", "constexpr int kClusterThreads = 1024;")]

# kernel -> variant name -> (substitutions, options for the wrapper)
VARIANTS = {
    "flash": {
        "as built": ([], {}),
        "2 consumer warpgroups": ([("constexpr int kWG = 3;", "constexpr int kWG = 2;")], {}),
        "no ping-pong": (NO_PINGPONG, {}),
        "3-stage ring": ([("constexpr int kStages = 2;", "constexpr int kStages = 3;")], {}),
        "64-key tiles": ([("launch_bf16<64, 128>(", "launch_bf16<64, 64>(")], {}),
    },
    "auction": {f"{t} threads": ([("constexpr int kThreads = 512;", f"constexpr int kThreads = {t};")], {})
                for t in (512, 256, 1024)},
    "fused": {
        "cluster 8 (as built)": ([], {"kernel": "cluster", "cluster": 8}),
        "cluster 16": ([], {"kernel": "cluster", "cluster": 16}),
        "cluster 8, 1024 threads": (CLUSTER_1024, {"kernel": "cluster", "cluster": 8}),
        "cluster 16, 1024 threads": (CLUSTER_1024, {"kernel": "cluster", "cluster": 16}),
        "one block, packed word": ([], {"kernel": "block"}),
    },
    "ssd": {
        "tensor cores, hi/lo split (as built)": ([], {}),
        "tensor cores, no split": ([("constexpr bool kSplit = true;", "constexpr bool kSplit = false;")], {}),
        "tensor cores, two chunks a block": ([("constexpr int kChunks = 1;", "constexpr int kChunks = 2;")], {}),
        "CUDA cores, float32 (the earlier bf16 route)": ([("return tc::launch_bf16(", "return launch<__nv_bfloat16>(")], {}),
    },
}
BASELINE = "baseline tree"  # the variant built from --baseline
SOURCE = {"flash": "flash_attention.cu", "auction": "auction_rounds.cu", "fused": "auction_fused.cu",
          "ssd": "ssd_chunk.cu"}


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


def auction_case():
    from chip_smoke import bonus_weights
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_bid import auction_rounds, auction_rounds_ref
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

    def run(opts) -> str:
        out = []
        for name, args, rev, want in cases:
            got = auction_rounds(*args, reverse=rev)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = event_ms(lambda: auction_rounds(*args, reverse=rev), 5)
            out.append(f"{name} {ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round), exact {ok}")
        return "; ".join(out)
    return run


def fused_case(baseline_lib=None):
    from chip_smoke import bonus_weights
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.traffic import permutations_workload

    B, n = 4, 512
    D = np.stack([permutations_workload(n=n, k=16, rng=np.random.default_rng(b)) for b in range(B)])
    W = bonus_weights(torch.from_numpy(D.astype(np.float32)).cuda())
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    p0 = torch.zeros((B, n), device="cuda")
    mi = default_max_iters(n)
    want = fused_auction_ref(W, p0, eps, max_iters=mi)

    def baseline():
        """The baseline tree's one-block kernel (launcher without ``cluster``)."""
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
        call = baseline if opts is None else (lambda: fused_auction(W, p0, eps, max_iters=mi, **opts))
        got = call()
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = event_ms(call, 5)
        return (f"{ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round of the longest lane, rounds "
                f"{got[3].tolist()}), exact {ok}")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", type=Path, help="csrc directory of an earlier tree (fused: its one-block kernel)")
    args = ap.parse_args()
    if set(args.kernels) - set(VARIANTS):
        ap.error(f"unknown kernels {sorted(set(args.kernels) - set(VARIANTS))}")
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
        backend.CSRC_DIR, backend.BUILD_DIR = orig, VARIANTS_DIR / "lib"
    runners = {"flash": flash_case, "auction": auction_case, "fused": lambda: fused_case(baseline_lib),
               "ssd": ssd_case}
    for kernel in args.kernels or list(VARIANTS):
        variants = dict(VARIANTS[kernel])
        if kernel == "fused" and baseline_lib is not None:
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
