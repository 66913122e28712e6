"""Batched LLM decode serving (counterpart of ``repro.serve.engine.DecodeEngine``).

A batch of same-length prompts is prefilled by cache replay (one
``decode_step`` per prompt position), then decoded greedily or by
temperature sampling for ``max_new_tokens``. Steps run eagerly on the
model's device; the tokens stay there until the end of ``generate``, so a
step needs no host read. Temperature sampling draws from a
``torch.Generator`` seeded with ``seed``: it cannot reproduce the
reference's JAX random bits, only their distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GenerationResult:
    tokens: np.ndarray       # (B, prompt + generated)
    prompt_len: int
    steps: int
    # With ``keep_logits``: (B, steps − 1, V) float32, the logits of every
    # decode step; entry t predicts token t + 1.
    logits: torch.Tensor | None = None


class DecodeEngine:
    def __init__(self, model, *, max_len: int = 512):
        self.model = model
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int, *, temperature: float = 0.0,
                 seed: int = 0, keep_logits: bool = False, enc_out: torch.Tensor | None = None) -> GenerationResult:
        """prompts: (B, S0) int, the same length per batch. ``enc_out`` is the
        encoder's output for an encoder–decoder model (``LM.encode``)."""
        B, S0 = prompts.shape
        total = S0 + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"{total} exceeds engine max_len {self.max_len}")
        dev = self.model.device
        cache = self.model.init_cache(B, self.max_len, enc_out=enc_out)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)
        kept = []
        logits = None
        for t in range(S0):  # prefill by replay
            logits, cache = self.model.decode_step(cache, toks[:, t:t + 1])
            kept.append(logits[:, -1])
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = [toks]
        nxt = None
        for _ in range(max_new_tokens):
            if nxt is not None:
                logits, cache = self.model.decode_step(cache, nxt)
                kept.append(logits[:, -1])
            lg = logits[:, -1]
            if temperature > 0:
                nxt = torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1, generator=gen)
            else:
                nxt = lg.argmax(dim=-1, keepdim=True)
            out.append(nxt)
        tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=tokens, prompt_len=S0, steps=total,
                                logits=torch.stack(kept, dim=1) if keep_logits else None)
