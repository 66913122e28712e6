"""Three-term roofline of a traced sharded step (``repro.analysis.roofline``).

    compute term    = FLOPs_per_chip / peak FLOP/s
    memory term     = bytes_per_chip / HBM bandwidth
    collective term = wire_bytes_per_chip / link bandwidth

The counts are one rank's local ops (``analysis.collectives.LocalCounter``),
so they are per chip already. MODEL_FLOPS = 6·N_active·tokens (+ the exact
attention-matmul FLOPs, windowed where the arch is windowed);
useful_ratio = MODEL_FLOPS_per_chip / traced FLOPs catches remat and
redundant work; roofline_fraction = ideal compute time on MODEL_FLOPS over
the dominant term. These are counts against a data sheet, not times.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..configs.base import ModelConfig, ShapeCfg

# NVIDIA H100 SXM data-sheet peaks (dense), per chip.
H100_SXM = {
    "peak_flops_bf16": 989e12,  # FLOP/s, bf16 tensor cores, dense
    "hbm_bw": 3.35e12,          # B/s, HBM3
    "link_bw": 450e9,           # B/s a direction, NVLink 4
}


def count_params(params_shape: dict) -> tuple[int, int]:
    """(total, routed-expert-only) parameter counts from {state name: tensor
    or shape}; a routed expert's weights are the ``we_*`` ones."""
    total, expert = 0, 0
    for name, leaf in params_shape.items():
        n = 1
        for d in getattr(leaf, "shape", leaf):
            n *= int(d)
        total += n
        if any(part.startswith("we_") for part in name.split(".")):
            expert += n
    return total, expert


def model_flops(cfg: ModelConfig, shape: ShapeCfg, params_shape: dict) -> float:
    """6·N_active·D (+ attention score/PV matmuls), global per step."""
    total, expert = count_params(params_shape)
    n_active = total - expert
    if cfg.moe is not None and expert:
        n_active += expert * cfg.moe.top_k / cfg.moe.num_experts
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens

    # Attention matmuls (QK^T + PV): 4·B·Hq·dh·Σ_q kv_len(q) per layer (fwd);
    # ×3 for train (fwd+bwd). Σ_q kv: S²/2 causal-global, S·w local, S for
    # a single decode query.
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        dh, Hq = cfg.resolved_head_dim, cfg.num_heads
        B, S = shape.global_batch, shape.seq_len
        fwd_mult = 3.0 if shape.kind == "train" else 1.0
        per = (cfg.pattern_local + cfg.pattern_global) if cfg.pattern_local else 1
        n_local = cfg.num_layers * cfg.pattern_local // per if cfg.pattern_local else 0
        n_global = cfg.num_layers + cfg.encoder_layers - n_local
        if cfg.family == "hybrid" and cfg.attn_every:
            n_local, n_global = 0, cfg.num_layers // cfg.attn_every
        w = min(cfg.window or S, S)
        if shape.kind == "decode":
            sum_kv_global, sum_kv_local = float(S), float(w)
        else:
            sum_kv_global, sum_kv_local = S * S / 2.0, float(S) * w
        flops += fwd_mult * 4 * B * Hq * dh * (n_global * sum_kv_global + n_local * sum_kv_local)
    return flops


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    useful_ratio: float
    roofline_fraction: float
    collectives: dict

    def as_dict(self):
        return asdict(self)


def analyze(trace: dict, cfg: ModelConfig, shape: ShapeCfg, n_chips: int, params_shape: dict,
            hw: dict = H100_SXM) -> Roofline:
    """The roofline of a trace record (``{"flops", "bytes", "wire",
    "collectives"}``, per chip) against ``hw``'s peaks."""
    flops, nbytes, wire = float(trace["flops"]), float(trace["bytes"]), float(trace["wire"])
    terms = {"compute": flops / hw["peak_flops_bf16"], "memory": nbytes / hw["hbm_bw"],
             "collective": wire / hw["link_bw"]}
    mf = model_flops(cfg, shape, params_shape)
    ideal_s = (mf / n_chips) / hw["peak_flops_bf16"]
    bound = max(terms.values())
    return Roofline(
        compute_s=terms["compute"], memory_s=terms["memory"], collective_s=terms["collective"],
        dominant=max(terms, key=terms.get), model_flops=mf, flops_per_chip=flops, bytes_per_chip=nbytes,
        wire_bytes_per_chip=wire, useful_ratio=(mf / n_chips / flops) if flops else 0.0,
        roofline_fraction=(ideal_s / bound) if bound > 0 else 0.0, collectives=trace["collectives"],
    )
