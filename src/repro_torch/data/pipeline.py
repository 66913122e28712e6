"""Deterministic synthetic token pipeline, a copy of ``repro.data.pipeline``.

A counter-based numpy token stream, fully deterministic in (seed, step,
host): a restart reproduces the exact batches, and the port's batches are
bit-identical to the reference's. Only ``next_batch`` differs: it puts the
tokens on the stream's device. Structured sequences (Zipf-ish marginals plus
short-range repetition) so the cross-entropy actually decreases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.backend import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _batch_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """(host_batch, seq_len) int32, deterministic in (seed, step, host)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    # Zipf-like marginal over a smallish working set, then inject
    # copy-structure: each sequence repeats a short motif with noise.
    working = min(V, 4096)
    base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
    tokens = (base - 1) % working
    motif_len = 16
    motif = tokens[:, :motif_len]
    reps = S // motif_len
    motifed = np.tile(motif, (1, reps))[:, :S]
    mask = rng.random((B, S)) < 0.7
    tokens = np.where(mask, motifed, tokens)
    return tokens.astype(np.int32)


class TokenStream:
    """Stateless-resumable iterator: next_batch(step) → {"tokens": (B, S) int32 on the device}.

    ``device=None`` means CUDA and raises without a GPU.
    """

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def next_batch(self, step: int) -> dict:
        return {"tokens": torch.from_numpy(_batch_tokens(self.cfg, step)).to(self.device)}

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed}


def make_stream(vocab_size: int, seq_len: int, global_batch: int, seed: int = 0, *, device=None) -> TokenStream:
    return TokenStream(DataConfig(vocab_size, seq_len, global_batch, seed), device=device)
