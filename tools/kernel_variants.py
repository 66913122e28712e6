"""Time design variants of the port's CUDA kernels on one GPU.

    python3 tools/kernel_variants.py [flash|auction ...] [--rounds 2]

Each variant is the kernel source with a few text substitutions (fewer
warpgroups, no ping-pong, another ring depth or block size, ...). The
script copies ``src/repro_torch/csrc`` for each variant, applies its
substitutions, builds the library from the copy (under ``build/``), checks
the result against the plain version and times it, in turns, ``--rounds``
times, so that every variant is measured on the same card in the same call:

- ``flash``: ``flash_attention`` bf16 at zamba2-1.2b's prefill shape
  (2, 32, 4096, 64), causal and not, beside ``scaled_dot_product_attention``;
  held to the plain version at |Δ| ≤ 1e-2 + 1e-2·|ref|.
- ``auction``: ``auction_rounds`` on the gpt, moe and benchmark buckets'
  first-round weights (forward for gpt, forward-reverse for the others, as
  the matchers run them); held to the plain version bit for bit.

It needs a CUDA device and ``nvcc``; it prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
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

VARIANTS = {
    "flash": {
        "as built": [],
        "2 consumer warpgroups": [("constexpr int kWG = 3;", "constexpr int kWG = 2;")],
        "no ping-pong": NO_PINGPONG,
        "3-stage ring": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "64-key tiles": [("launch_bf16<64, 128>(", "launch_bf16<64, 64>(")],
    },
    "auction": {f"{t} threads": [("constexpr int kThreads = 512;", f"constexpr int kThreads = {t};")]
                for t in (512, 256, 1024)},
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


def build(key: str, subs, orig: Path) -> None:
    """Load the library built from a copy of ``orig`` with ``subs`` applied
    (copied and built at first use, under ``build/variants/<key>``)."""
    src = VARIANTS_DIR / key / "csrc"
    if not src.exists():
        shutil.copytree(orig, src)
        for old, new in subs:
            hits = [f for f in src.iterdir() if old in f.read_text()]
            if not hits:
                raise SystemExit(f"substitution not found: {old!r}")
            for f in hits:
                f.write_text(f.read_text().replace(old, new))
    backend.CSRC_DIR, backend.BUILD_DIR = src, src.parent / "lib"
    backend.load_library.cache_clear()
    backend.load_library()


def flash_case():
    from repro_torch.kernels.flash_attention import flash_attention, mha_ref

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 4096, 64), dtype=np.float32)).to("cuda", torch.bfloat16)
               for _ in range(3))
    want = mha_ref(q, k, v, causal=True).float()
    flops = 4.0 * 64 * 64 * (4096 * 4097 / 2)

    def run() -> str:
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

    def run() -> str:
        out = []
        for name, args, rev, want in cases:
            got = auction_rounds(*args, reverse=rev)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = event_ms(lambda: auction_rounds(*args, reverse=rev), 5)
            out.append(f"{name} {ms:.3f} ms ({ms * 1e3 / int(got[3].max()):.3f} us a round), exact {ok}")
        return "; ".join(out)
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if set(args.kernels) - set(VARIANTS):
        ap.error(f"unknown kernels {sorted(set(args.kernels) - set(VARIANTS))}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    orig = backend.CSRC_DIR
    shutil.rmtree(VARIANTS_DIR, ignore_errors=True)  # copies of an earlier tree would be stale
    runners = {"flash": flash_case, "auction": auction_case}
    for kernel in args.kernels or list(VARIANTS):
        run = runners[kernel]()
        for r in range(args.rounds):
            for i, (name, subs) in enumerate(VARIANTS[kernel].items()):
                build(f"{kernel}{i}", subs, orig)
                print(f"{kernel} round {r} [{name}]: {run()}", flush=True)
    backend.CSRC_DIR = orig


if __name__ == "__main__":
    main()
