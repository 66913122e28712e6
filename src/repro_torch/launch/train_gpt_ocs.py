"""End to end: train a ~100M-parameter GPT while SPECTRA schedules
the fabric, the paper's deployment scenario in one script (the twin of
``examples/train_gpt_ocs.py``).

Every ``--ocs-every`` steps the training loop emits the rack-level demand
matrix of its parallelism plan, and the SPECTRA controller schedules it on
the parallel-OCS core, logging the collective completion time (CCT).

    PYTHONPATH=src python -m repro_torch.launch.train_gpt_ocs             # ~100M run, CUDA
    PYTHONPATH=src python -m repro_torch.launch.train_gpt_ocs --tiny --device cpu

Runs on CUDA unless ``--device cpu`` is given; without a GPU the default
raises.
"""

from __future__ import annotations

import argparse

from ..configs.base import ModelConfig


def gpt_100m() -> ModelConfig:
    # ~110M params: 12L × d768 × 12H, d_ff 3072, 32k vocab (GPT-2-small-ish).
    return ModelConfig(
        name="gpt-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32000,
        dtype="float32",
    )


def make_gpt_trainer(*, tiny: bool = False, steps: int | None = None, batch: int = 8, seq: int = 256,
                     ocs_every: int = 20, device=None):
    """The example's ``Trainer``: gpt-100m (``reduced()`` with ``tiny``), AdamW
    under ``warmup_stable_decay`` (peak 3e-4, 3e-3 tiny), the token stream
    of seed 0, ``OCSFabric(4, 20 µs)`` ticked every ``ocs_every`` steps over
    8 racks. Returns (trainer, config, steps)."""
    from ..data.pipeline import make_stream
    from ..fabric.ocs import OCSFabric
    from ..models.registry import build_model
    from ..parallel.steps import make_train_step
    from ..train.loop import LoopConfig, Trainer
    from ..train.optimizer import AdamW, warmup_stable_decay

    cfg = gpt_100m()
    n_steps = steps or 300
    if tiny:
        cfg = cfg.reduced()
        n_steps = steps or 30
    model = build_model(cfg, device=device)
    opt = AdamW(schedule=warmup_stable_decay(3e-3 if tiny else 3e-4, n_steps))
    stream = make_stream(cfg.vocab_size, seq, batch, device=device)
    fabric = OCSFabric(num_switches=4, reconfig_delay_s=20e-6)
    loop_cfg = LoopConfig(total_steps=n_steps, log_every=max(n_steps // 20, 1), ocs_every=ocs_every,
                          ocs_num_racks=8)
    return Trainer(model, opt, stream, make_train_step(model, opt), loop_cfg, fabric=fabric, device=device), cfg, n_steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="smoke-scale run")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ocs-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    tr, cfg, steps = make_gpt_trainer(tiny=args.tiny, steps=args.steps, batch=args.batch, seq=args.seq,
                                      ocs_every=args.ocs_every, device=args.device)
    print(f"model: {cfg.name}  params ≈ {tr.model.param_count() / 1e6:.0f}M  "
          f"steps={steps} batch={args.batch} seq={args.seq}")
    state = tr.run(0)

    print("\nloss curve (sampled):")
    for h in state.history:
        print(f"  step {h['step']:>4}  loss {h['loss']:.4f}  {h['time_s'] * 1e3:.0f} ms")
    print("\nOCS controller log (SPECTRA on the DP gradient ring):")
    for rec in state.cct_log[-5:]:
        print(f"  step {rec['step']:>4}  CCT {rec['cct_s'] * 1e3:.3f} ms  "
              f"makespan {rec['makespan']:.4f}  LB {rec['lb']:.4f}  "
              f"{rec['configs']} circuits")
    assert state.history[-1]["loss"] < state.history[0]["loss"]
    print("\nOK: loss decreased and the optical fabric schedule stayed "
          "within", f"{max(r['makespan'] / max(r['lb'], 1e-12) for r in state.cct_log):.2f}x",
          "of the lower bound.")
    return state


if __name__ == "__main__":
    main()
