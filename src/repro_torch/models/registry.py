"""Model + input factory (counterpart of ``repro.models.registry``)."""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..kernels.backend import resolve_device
from .lm import LM, torch_dtype


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0, remat: bool = False) -> LM:
    """The model with random weights from ``seed``; ``device=None`` means CUDA.
    ``remat`` checkpoints each scanned block in the backward (``LM.remat``)."""
    return LM(cfg, device=device, seed=seed, remat=remat)


def concrete_inputs(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0, device=None) -> dict:
    """Random inputs for a cell, drawn with numpy from ``seed`` (the
    reference's ``input_specs``).

    The tokens are ``default_rng(seed).integers(0, vocab, (B, S))``; the same
    generator then draws the stubbed modality inputs, N(0, 0.02²) in the
    model's type: ``frames`` (B, max(S // 2, 8), D) for audio,
    ``patch_embeds`` (B, min(256, S), D) for vlm, with ``positions``
    (B, S, 3), three equal ``arange`` streams, as the reference's
    ``concrete_inputs`` makes them. So a test can hand the same arrays to
    the reference. Decode cells get one token per row and nothing else.
    """
    dev = resolve_device(device)
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    if shape.kind == "decode":
        return out

    def normal(*dims):
        return torch.from_numpy(rng.standard_normal(dims, dtype=np.float32) * np.float32(0.02)).to(dev, torch_dtype(cfg))

    if cfg.family == "audio":
        out["frames"] = normal(B, max(S // 2, 8), cfg.d_model)
    if cfg.family == "vlm":
        out["patch_embeds"] = normal(B, min(256, S), cfg.d_model)
        out["positions"] = torch.arange(S, device=dev)[None, :, None].expand(B, S, len(cfg.mrope_sections)).contiguous()
    return out
