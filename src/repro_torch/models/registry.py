"""Model + input factory (counterpart of ``repro.models.registry``)."""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..kernels.backend import resolve_device
from .lm import LM, init_cache, torch_dtype


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0, remat: bool = False,
                act_pspec: tuple | None = None) -> LM:
    """The model with random weights from ``seed``; ``device=None`` means CUDA.
    ``remat`` checkpoints each scanned block in the backward (``LM.remat``);
    ``act_pspec`` constrains the activations between blocks of a sharded
    step (``LM._constrain``)."""
    return LM(cfg, device=device, seed=seed, remat=remat, act_pspec=act_pspec)


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """Abstract inputs of a cell: ``meta`` tensors of the right shapes and
    types (the reference's ``ShapeDtypeStruct`` stand-ins).

    Training/prefill: the token batch (+ the stubbed modality inputs).
    Decode: one new token a row; the caches come from ``cache_specs``.
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1), torch.int32)}
    dt = torch_dtype(cfg)
    batch = {"tokens": spec((B, S), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = spec((B, max(S // 2, 8), cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["patch_embeds"] = spec((B, min(256, S), cfg.d_model), dt)
        batch["positions"] = spec((B, S, len(cfg.mrope_sections)), torch.int32)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict | None:
    """The decode caches of a cell as ``meta`` tensors (None for other kinds)."""
    if shape.kind != "decode":
        return None
    B, S = shape.global_batch, shape.seq_len
    enc_out = None
    if cfg.family == "audio":
        enc_out = torch.empty((B, max(S // 2, 8), cfg.d_model), dtype=torch_dtype(cfg), device="meta")
    return init_cache(cfg, B, S, enc_out=enc_out, device="meta")


def param_specs(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's parameters as ``meta`` tensors, keyed by state name: their
    shapes and types, with no memory (a full-size config is fine)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = LM(cfg, device="cpu")
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in model.state_dict().items()}


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
