"""Serving launcher: batched greedy decode on a reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 4 --prompt-len 16 --new-tokens 32 [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU the default
raises. Every registered arch is served but the audio one (whisper-tiny):
its decoder needs an encoder output that this launcher, like the
reference's, does not make.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    from ..configs.registry import get_arch
    from ..models.registry import build_model
    from ..serve.engine import DecodeEngine

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, device=args.device, seed=args.seed)
    dev = model.device
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    eng = DecodeEngine(model, max_len=args.prompt_len + args.new_tokens + 8)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    res = eng.generate(prompts, args.new_tokens, temperature=args.temperature, seed=args.seed)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"arch={cfg.name} batch={args.batch} generated={toks} tokens in {dt:.2f}s "
          f"→ {toks / dt:.1f} tok/s ({dev.type}: {device_name}, reduced config)")
    print("first row:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
