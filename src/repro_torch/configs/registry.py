"""The 10 architectures (exact dims) + shapes: the port's copy of
``repro.configs.registry``; every one of them runs in the port.

`head_dim` choices follow the public configs where the sources leave them
implicit.
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, MoECfg, SSMCfg, ShapeCfg

ARCHS: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# — hybrid: Mamba2 + shared attention blocks [arXiv:2411.15242] —
_reg(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, n_groups=1),
    attn_every=6,  # shared attn block after every 6 Mamba2 layers
))

# — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01] —
_reg(ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
))

# — dense, WSD schedule, llama-like [arXiv:2404.06395] —
_reg(ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122753,
))

# — dense, 5:1 local:global sliding window, 128k [hf:google/gemma-3] —
_reg(ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    window=1024, pattern_local=5, pattern_global=1,
))

# — dense GQA [hf:ibm-granite/granite-3.0] —
_reg(ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
))

# — audio enc-dec, conv frontend stubbed [arXiv:2212.04356] —
_reg(ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    head_dim=64, d_ff=1536, vocab_size=51865,
))

# — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B] —
_reg(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    moe=MoECfg(num_experts=128, top_k=8, d_ff_expert=768),
))

# — MoE 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066] —
_reg(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
))

# — VLM backbone, M-RoPE, patch frontend stubbed [arXiv:2409.12191] —
_reg(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24),
))

# — pure SSM (SSD) [arXiv:2405.21060] —
_reg(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1),
))

# Sub-quadratic archs eligible for the long_500k decode cell.
LONG_CONTEXT_OK = {"zamba2-1.2b", "mamba2-2.7b", "gemma3-27b"}
# Cells skipped: long_500k × pure full-attention archs (+ whisper audio).
SKIPPED_CELLS = {
    (a, "long_500k")
    for a in ARCHS
    if a not in LONG_CONTEXT_OK
}


def get_arch(name: str) -> ModelConfig:
    return ARCHS[name]


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]


def all_cells():
    """All (arch, shape) dry-run cells, with skip markers."""
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, (arch, shape) in SKIPPED_CELLS
