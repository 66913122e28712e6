"""Config system: model architecture + input-shape cells.

The port's own copy of ``repro.configs.base``, field for field, so that
``reduced()`` gives both packages the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMCfg:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    # Attention pattern: window size for local layers; pattern gives the
    # repeating local:global structure (e.g. gemma3 = 5 local + 1 global).
    window: int | None = None
    pattern_local: int = 0  # local layers per period (0 → all global/full)
    pattern_global: int = 1
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()
    # MoE / SSM / hybrid extras
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    attn_every: int = 0  # hybrid: shared attn block after every k SSM layers
    # Encoder-decoder (audio)
    encoder_layers: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // self.num_heads)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=min(self.window, 16) if self.window else None,
            encoder_layers=min(self.encoder_layers, 2),
            attn_every=2 if self.attn_every else 0,
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, num_experts=8, top_k=2, d_ff_expert=64,
                num_shared=min(self.moe.num_shared, 1),
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16)
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 6, 6)  # scaled to half of head_dim=32
        if self.pattern_local:
            kw["pattern_local"] = 2
            kw["pattern_global"] = 1
            kw["num_layers"] = 6
        if self.attn_every:
            kw["num_layers"] = 5  # 2 groups of 2 + 1 remainder
        kw["dtype"] = "float32"
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
