"""Language-model assembly for the dense, ssm and hybrid families.

Counterpart of ``repro.models.lm.LM``:

  dense   — GQA transformer; ``pattern_local`` layers per period use the
            sliding ``window`` (gemma3's 5 local : 1 global), the rest are
            global; layers that do not fill a period form the remainder
  ssm     — a pure Mamba-2 stack
  hybrid  — Mamba-2 groups of ``attn_every`` layers, each followed by ONE
            shared attention block (zamba2: the same parameters at every
            insertion), then the remainder Mamba-2 layers

The layers the reference stacks for ``lax.scan`` are ``nn.ModuleList``s
here, run by a Python loop. The moe, audio and vlm families are not ported
yet (ROADMAP Queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.backend import resolve_device
from .blocks import Attention, Mamba, ssm_dims
from .layers import rms_norm, winit, zinit

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_pattern(cfg: ModelConfig) -> tuple[list[bool], int, list[bool]]:
    """(period pattern of is_local flags, number of periods, remainder flags)."""
    if cfg.pattern_local:
        period = [True] * cfg.pattern_local + [False] * cfg.pattern_global
        n = cfg.num_layers // len(period)
        return period, n, period[:cfg.num_layers - n * len(period)]
    return [False], cfg.num_layers, []


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(number of groups, number of remainder Mamba-2 layers)."""
    n_groups = cfg.num_layers // cfg.attn_every
    return n_groups, cfg.num_layers - n_groups * cfg.attn_every


class LM(nn.Module):
    """``LM(cfg, device=None, seed=0)``: the model with fresh random weights.

    ``device=None`` means CUDA and raises without a GPU; the CPU runs only
    when named. Weights are drawn by a ``torch.Generator`` on the device,
    seeded with ``seed``, at the reference's scales and in the config's type.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1: the MoE, audio and VLM families)")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(dtype=torch_dtype(cfg), device=dev)
        self.embed = nn.Parameter(winit(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, **kw), requires_grad=False)
        self.final_norm = nn.Parameter(zinit((cfg.d_model,), **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(winit(gen, (cfg.d_model, cfg.vocab_size), **kw), requires_grad=False)
        if cfg.family == "dense":
            period, n_periods, rem = layer_pattern(cfg)
            self.periods = nn.ModuleList(
                nn.ModuleList(Attention(cfg, gen, **kw) for _ in period) for _ in range(n_periods))
            self.remainder = nn.ModuleList(Attention(cfg, gen, **kw) for _ in rem)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(cfg.num_layers))
        else:
            n_groups, rem_n = hybrid_layout(cfg)
            self.groups = nn.ModuleList(
                nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(cfg.attn_every)) for _ in range(n_groups))
            self.shared_attn = Attention(cfg, gen, **kw)  # ONE set of parameters
            self.remainder = nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(rem_n))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- forward
    def _backbone(self, x, positions, caches=None):
        """Decoder trunk; ``caches=None`` is the full-sequence forward."""
        cfg = self.cfg
        decode = caches is not None
        new = {}

        def cache_of(*path):
            if not decode:
                return None
            c = caches
            for key in path:
                c = c[key]
            return c

        if cfg.family == "dense":
            period, _, rem = layer_pattern(cfg)
            new_periods = []
            for i, layers in enumerate(self.periods):
                ncs = []
                for j, (layer, local) in enumerate(zip(layers, period)):
                    x, nc = layer(x, positions=positions, window=cfg.window if local else None,
                                  cache=cache_of("periods", i, j))
                    ncs.append(nc)
                new_periods.append(ncs)
            new_rem = []
            for i, (layer, local) in enumerate(zip(self.remainder, rem)):
                x, nc = layer(x, positions=positions, window=cfg.window if local else None,
                              cache=cache_of("remainder", i))
                new_rem.append(nc)
            new = {"periods": new_periods, "remainder": new_rem}
        elif cfg.family == "ssm":
            ncs = []
            for i, layer in enumerate(self.layers):
                x, nc = layer(x, cache=cache_of("layers", i))
                ncs.append(nc)
            new = {"layers": ncs}
        else:
            new_groups = []
            for g, group in enumerate(self.groups):
                m_ncs = []
                for i, layer in enumerate(group):
                    x, nc = layer(x, cache=cache_of("groups", g, "mamba", i))
                    m_ncs.append(nc)
                x, a_nc = self.shared_attn(x, positions=positions, cache=cache_of("groups", g, "attn"))
                new_groups.append({"mamba": m_ncs, "attn": a_nc})
            new_rem = []
            for i, layer in enumerate(self.remainder):
                x, nc = layer(x, cache=cache_of("remainder", i))
                new_rem.append(nc)
            new = {"groups": new_groups, "remainder": new_rem}
        return x, (new if decode else None)

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x @ head.to(x.dtype)).float()

    def apply(self, batch: dict) -> dict:
        """Full-sequence forward: {"tokens": (B, S) int} → {"logits": (B, S, V) float32}."""
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        x, _ = self._backbone(x, positions)
        return {"logits": self._logits(x)}

    forward = apply

    # -------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        kw = dict(dtype=torch_dtype(cfg), device=self.device)
        dh, Hkv = cfg.resolved_head_dim, cfg.num_kv_heads

        def kv(length):
            return {"k": torch.zeros((batch_size, Hkv, length, dh), **kw),
                    "v": torch.zeros((batch_size, Hkv, length, dh), **kw), "pos": 0}

        def ssm_cache():
            s, _, H, conv_dim = ssm_dims(cfg)
            return {"conv": torch.zeros((batch_size, s.conv_width - 1, conv_dim), **kw),
                    "ssm": torch.zeros((batch_size * H, s.d_state, s.head_dim), dtype=torch.float32,
                                       device=self.device)}

        if cfg.family == "dense":
            period, n_periods, rem = layer_pattern(cfg)

            def layer_len(local):  # local layers need only a window-sized cache
                return min(cfg.window, max_len) if local and cfg.window else max_len

            return {"periods": [[kv(layer_len(local)) for local in period] for _ in range(n_periods)],
                    "remainder": [kv(layer_len(local)) for local in rem]}
        if cfg.family == "ssm":
            return {"layers": [ssm_cache() for _ in range(cfg.num_layers)]}
        n_groups, rem_n = hybrid_layout(cfg)
        return {"groups": [{"mamba": [ssm_cache() for _ in range(cfg.attn_every)], "attn": kv(max_len)}
                           for _ in range(n_groups)],
                "remainder": [ssm_cache() for _ in range(rem_n)]}

    def decode_step(self, caches: dict, token: torch.Tensor):
        """token: (B, 1) int → (logits (B, 1, V) float32, new caches)."""
        x = self.embed[token.to(self.device)]
        x, new_caches = self._backbone(x, None, caches=caches)
        return self._logits(x), new_caches

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
