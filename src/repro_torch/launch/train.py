"""Training launcher (the flags of ``repro.launch.train``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --reduced --steps 20 --batch 2 --seq 64 --ckpt-dir /tmp/ckpt \\
        --ocs-switches 4 --ocs-delta-us 20 [--device cpu]

``--reduced`` (default) trains the smoke-scale config; ``--full`` the
published one. Runs on CUDA unless ``--device cpu`` is given; without a GPU
the default raises. With ``--ocs-switches`` the loop runs the SPECTRA fabric
controller every ``--ocs-every`` steps and logs the optical CCT.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

from ..configs.base import ModelConfig


def make_trainer(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float, seed: int = 0,
                 ckpt_dir: str | None = None, ckpt_every: int = 50, ocs_switches: int = 0,
                 ocs_delta_us: float = 20.0, ocs_every: int = 10, device=None, remat: bool = False,
                 failure_injector: Callable[[int], None] | None = None, **loop_kw):
    """The launcher's ``Trainer`` for ``cfg``: model from ``seed``, AdamW
    under ``warmup_stable_decay(lr, steps)``, the token stream from
    ``seed``, and the fabric when ``ocs_switches`` > 0. ``loop_kw`` goes to
    ``LoopConfig``."""
    from ..data.pipeline import make_stream
    from ..fabric.ocs import OCSFabric
    from ..models.registry import build_model
    from ..parallel.steps import make_train_step
    from ..train.loop import LoopConfig, Trainer
    from ..train.optimizer import AdamW, warmup_stable_decay

    model = build_model(cfg, device=device, seed=seed, remat=remat)
    opt = AdamW(schedule=warmup_stable_decay(lr, steps))
    stream = make_stream(cfg.vocab_size, seq, batch, seed=seed, device=device)
    fabric = None
    if ocs_switches:
        fabric = OCSFabric(num_switches=ocs_switches, reconfig_delay_s=ocs_delta_us * 1e-6)
    loop_cfg = LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          ocs_every=ocs_every if fabric else 0, **loop_kw)
    return Trainer(model, opt, stream, make_train_step(model, opt), loop_cfg, fabric=fabric,
                   failure_injector=failure_injector, device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ocs-switches", type=int, default=0)
    ap.add_argument("--ocs-delta-us", type=float, default=20.0)
    ap.add_argument("--ocs-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    from ..configs.registry import get_arch

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tr = make_trainer(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, ocs_switches=args.ocs_switches,
                      ocs_delta_us=args.ocs_delta_us, ocs_every=args.ocs_every, device=args.device)
    state = tr.run(args.seed)
    print(json.dumps({
        "arch": args.arch,
        "device": str(tr.device),
        "steps": state.step,
        "restarts": state.restarts,
        "stragglers": state.stragglers,
        "history": state.history[-5:],
        "cct": state.cct_log[-3:],
    }, indent=1))


if __name__ == "__main__":
    main()
