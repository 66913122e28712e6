"""Model + input factory (counterpart of ``repro.models.registry``)."""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..kernels.backend import resolve_device
from .lm import LM


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0) -> LM:
    """The model with random weights from ``seed``; ``device=None`` means CUDA."""
    return LM(cfg, device=device, seed=seed)


def concrete_inputs(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0, device=None) -> dict:
    """Random inputs for a cell, drawn with numpy from ``seed``.

    The tokens are ``default_rng(seed).integers(0, vocab, (B, S))``, so a
    test can hand the same array to the reference. Decode cells get one
    token per row.
    """
    dev = resolve_device(device)
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return {"tokens": torch.from_numpy(tokens).to(dev)}
