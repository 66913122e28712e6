"""Transformer, MoE and Mamba-2 blocks with full-sequence and decode paths.

Counterpart of ``repro.models.blocks``. Each block is an ``nn.Module``
holding the reference's parameters under the reference's names and layouts;
``forward(x, ...)`` returns ``(y, new_cache)``, the MoE block ``(y, stats)``.

Caches are dicts of tensors. Unlike the reference, whose arrays are
immutable, the attention cache is written in place (one slot per step) and
the returned dict shares its tensors: a decode step costs no copy of the
cache. The position ``pos`` is a Python int, so a step needs no host read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, MoECfg
from ..kernels.flash_attention.ops import mha
from ..kernels.ssd_scan.ops import ssd_decode_step, ssd_scan
from .layers import apply_rope, causal_conv1d, dense, rms_norm, silu, winit, zinit


def _params(module: nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# Attention block.
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, dh).transpose(1, 2)  # (B, H, S, dh)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _decode_attention(q, k_cache, v_cache, keep, scale):
    """Masked single-query attention over a fixed-size cache, in float32.

    q: (B, Hq, 1, dh); caches: (B, Hkv, Smax, dh); keep: (Smax,) bool mask of
    the valid cache slots.
    """
    B, Hq, _, dh = q.shape
    Hkv = k_cache.shape[1]
    group = Hq // Hkv
    qf = q.float().reshape(B, Hkv, group, dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) * scale
    s = torch.where(keep[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, dh).to(q.dtype)


class Attention(nn.Module):
    """Pre-norm self-attention (+ SwiGLU MLP) with residuals (``attn_init``/``attn_apply``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *, with_mlp: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.with_mlp = with_mlp
        D, dh, F_ = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(dtype=dtype, device=device)
        p = {
            "norm1": zinit((D,), **kw),
            "wq": winit(gen, (D, Hq * dh), **kw),
            "wk": winit(gen, (D, Hkv * dh), **kw),
            "wv": winit(gen, (D, Hkv * dh), **kw),
            "wo": winit(gen, (Hq * dh, D), **kw),
        }
        if with_mlp:
            p.update({
                "norm2": zinit((D,), **kw),
                "wi_gate": winit(gen, (D, F_), **kw),
                "wi_up": winit(gen, (D, F_), **kw),
                "wdown": winit(gen, (F_, D), **kw),
            })
        _params(self, p)

    def forward(self, x, *, positions=None, causal: bool = True, window: int | None = None,
                cache: dict | None = None, kv_override=None):
        """``cache`` (decode): {"k": (B, Hkv, Smax, dh), "v": ..., "pos": int}.
        ``kv_override``: (k_src, v_src) activations for cross-attention."""
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        scale = dh ** -0.5

        h = rms_norm(x, self.norm1, cfg.norm_eps)
        q = _split_heads(dense(h, self.wq), Hq, dh)
        ksrc, vsrc = (h, h) if kv_override is None else kv_override
        k = _split_heads(dense(ksrc, self.wk), Hkv, dh)
        v = _split_heads(dense(vsrc, self.wv), Hkv, dh)

        new_cache = None
        if cache is None:
            if kv_override is None:  # self-attention: rotate q and k
                q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
                k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
            attn = mha(q, k, v, causal=causal, window=window, scale=scale)
        elif kv_override is None:
            pos = cache["pos"]
            shape = (x.shape[0], 1, len(cfg.mrope_sections)) if cfg.mrope_sections else (x.shape[0], 1)
            pos_b = torch.full(shape, pos, dtype=torch.int64, device=x.device)
            q = apply_rope(q, pos_b, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, pos_b, cfg.rope_theta, cfg.mrope_sections)
            k_cache, v_cache = cache["k"], cache["v"]
            smax = k_cache.shape[2]
            slots = torch.arange(smax, device=x.device)
            if window is not None and smax == window:
                # Ring buffer: the cache holds only the last `window` keys.
                write = pos % window
                abs_pos = pos - torch.remainder(pos - slots, window)
                keep = abs_pos >= 0  # slots not written yet are negative
            else:
                write = pos
                keep = slots <= pos
                if window is not None:
                    keep &= slots > pos - window
            k_cache[:, :, write] = k[:, :, 0].to(k_cache.dtype)
            v_cache[:, :, write] = v[:, :, 0].to(v_cache.dtype)
            new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
            attn = _decode_attention(q, k_cache, v_cache, keep, scale)
        else:
            # Cross-attention decode: K/V recomputed from the source each step.
            keep = torch.ones((k.shape[2],), dtype=torch.bool, device=x.device)
            new_cache = cache
            attn = _decode_attention(q, k, v, keep, scale)

        x = x + dense(_merge_heads(attn), self.wo)
        if self.with_mlp:
            h = rms_norm(x, self.norm2, cfg.norm_eps)
            x = x + dense(silu(dense(h, self.wi_gate)) * dense(h, self.wi_up), self.wdown)
        return x, new_cache


# ---------------------------------------------------------------------------
# MoE block: capacity-based gather/scatter dispatch, as the reference's.
# ---------------------------------------------------------------------------

def expert_capacity(T: int, m: MoECfg) -> int:
    """Slots an expert has for a group of T tokens: ⌈T·K·cf / E⌉ rounded up
    to a multiple of 4, at least 4."""
    C = int(math.ceil(T * m.top_k * m.capacity_factor / m.num_experts))
    return max(4, -(-C // 4) * 4)


def top_k_stable(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: "MoE", x: torch.Tensor, m: MoECfg):
    """Routed expert FFN on G groups of T tokens, x (G, T, D) → (G, T, D),
    plus the routing stats (``repro.models.blocks.moe_ffn`` on each group).

    Each (token, choice) takes its place in its expert's queue of its group
    by a token-major, choice-minor exclusive prefix count; one past the
    capacity C it goes to a sentinel slot and is dropped. The slots are laid
    out expert-major over the groups, (E, G·C), so one batched product an
    expert serves every group without a transpose. Tokens gather their K
    slots' outputs and sum them weighted by their gates, which are 0 for a
    dropped choice (it reads slot 0): the sums of the reference's
    scatter-add, without float atomics.
    ``expert_load`` counts every choice, dropped ones too, summed over the
    groups; ``aux_loss`` is the groups' mean.
    """
    G, T, D = x.shape
    E, K = m.num_experts, m.top_k
    probs = torch.softmax(dense(x, p.router).float(), dim=-1)  # (G, T, E)
    gate_vals, gate_idx = top_k_stable(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    C = expert_capacity(T, m)
    e_flat = gate_idx.reshape(G, T * K)  # token-major, choice-minor
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device).scatter_add_(1, e_flat, torch.ones_like(e_flat))
    # The exclusive prefix count of each choice's expert, as the reference's
    # cumsum of one-hots gives it: its rank among the same expert's choices
    # in a stable sort by expert.
    order = torch.argsort(e_flat, dim=1, stable=True)
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(T * K, device=x.device) - torch.gather(starts, 1, torch.gather(e_flat, 1, order))
    pos = torch.empty_like(rank).scatter_(1, order, rank)
    keep = pos < C
    group = torch.arange(G, device=x.device)[:, None]
    n = E * G * C
    slot = (e_flat * G + group) * C + pos
    sent = torch.where(keep, slot, n).reshape(-1)  # overflow → sentinel n, dropped with it
    tok = (group * T + torch.arange(T, device=x.device).repeat_interleave(K)).reshape(-1)
    token_map = torch.zeros((n + 1,), dtype=torch.int64, device=x.device).scatter_(0, sent, tok)[:n]
    valid = torch.zeros((n + 1,), dtype=x.dtype, device=x.device).scatter_(
        0, sent, torch.ones((1,), dtype=x.dtype, device=x.device).expand(G * T * K))[:n]

    xe = (x.reshape(G * T, D).index_select(0, token_map) * valid[:, None]).reshape(E, G * C, D)
    he = torch.bmm(xe, p.we_gate.to(x.dtype))
    ue = torch.bmm(xe, p.we_up.to(x.dtype))
    ye = torch.bmm(silu(he) * ue, p.we_down.to(x.dtype)).reshape(n, D)
    gate = (gate_vals.reshape(G, T * K) * keep).to(x.dtype)
    picked = ye.index_select(0, torch.where(keep, slot, 0).reshape(-1)).reshape(G, T * K, D)
    y = (picked * gate[..., None]).reshape(G, T, K, D).sum(2)

    # Stats: each expert's token load (the MoE demand matrix) and the aux loss.
    load = counts.float()  # (G, E)
    importance = probs.sum(1)
    aux = E * torch.mean((load / torch.clamp(load.sum(-1, keepdim=True), min=1.0))
                         * (importance / torch.clamp(importance.sum(-1, keepdim=True), min=1.0)), dim=-1)
    return y, {"expert_load": load.sum(0), "aux_loss": (aux * m.router_aux_coef).mean()}


class MoE(nn.Module):
    """Pre-norm routed-expert FFN (+ shared experts) with residual
    (``moe_init``/``moe_apply``). ``forward(x)`` → (y, stats).

    Tokens are dispatched in one group per batch row when a row holds
    S ≥ 4·E of them, else in one group of all B·S (decode).
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        D, Fe, E = cfg.d_model, m.d_ff_expert, m.num_experts
        kw = dict(dtype=dtype, device=device)
        p = {
            "norm1": zinit((D,), **kw),
            "router": winit(gen, (D, E), **kw),
            "we_gate": winit(gen, (E, D, Fe), **kw),  # fan-in shape[0] = E, as the reference's winit
            "we_up": winit(gen, (E, D, Fe), **kw),
            "we_down": winit(gen, (E, Fe, D), **kw),
        }
        if m.num_shared:
            Fs = Fe * m.num_shared
            p.update({
                "ws_gate": winit(gen, (D, Fs), **kw),
                "ws_up": winit(gen, (D, Fs), **kw),
                "ws_down": winit(gen, (Fs, D), **kw),
            })
        _params(self, p)

    def forward(self, x):
        B, S, D = x.shape
        m = self.cfg.moe
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        groups = h if S >= 4 * m.num_experts else h.reshape(1, B * S, D)
        y, stats = moe_ffn(self, groups, m)
        y = y.reshape(B, S, D)
        if m.num_shared:
            y = y + dense(silu(dense(h, self.ws_gate)) * dense(h, self.ws_up), self.ws_down)
        return x + y, stats


# ---------------------------------------------------------------------------
# Mamba-2 block.
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, H, conv_dim


class Mamba(nn.Module):
    """Mamba-2 (SSD) block (``mamba_init``/``mamba_apply``).

    cache: {"conv": (B, K−1, conv_dim), "ssm": (B·H, N, P) float32}.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        s, d_inner, H, conv_dim = ssm_dims(cfg)
        D = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        _params(self, {
            "norm": zinit((D,), **kw),
            "w_xz": winit(gen, (D, 2 * d_inner), **kw),
            "w_bc": winit(gen, (D, 2 * s.n_groups * s.d_state), **kw),
            "w_dt": winit(gen, (D, H), **kw),
            "dt_bias": zinit((H,), **kw),
            "A_log": zinit((H,), **kw),  # A = −exp(A_log) = −1 initially
            "skip_D": torch.ones((H,), **kw),
            "conv_w": winit(gen, (s.conv_width, conv_dim), scale=0.5, **kw),
            "out_norm": zinit((d_inner,), **kw),
            "w_out": winit(gen, (d_inner, D), **kw),
        })

    def forward(self, x, *, cache: dict | None = None):
        cfg = self.cfg
        s, d_inner, H, conv_dim = ssm_dims(cfg)
        B, S, D = x.shape
        N, P, G = s.d_state, s.head_dim, s.n_groups

        h = rms_norm(x, self.norm, cfg.norm_eps)
        xi, z = dense(h, self.w_xz).chunk(2, dim=-1)  # (B, S, d_inner) each
        bc = dense(h, self.w_bc)  # (B, S, 2GN)
        dt_raw = dense(h, self.w_dt)  # (B, S, H)

        conv_in = torch.cat([xi, bc], dim=-1)
        conv_out, new_conv_state = causal_conv1d(conv_in, self.conv_w, None if cache is None else cache["conv"])
        conv_out = silu(conv_out)
        xi = conv_out[..., :d_inner]
        Bmat, Cmat = conv_out[..., d_inner:].chunk(2, dim=-1)  # (B, S, GN)

        dt = F.softplus(dt_raw.float() + self.dt_bias)  # (B, S, H)
        loga = -torch.exp(self.A_log)[None, None, :] * dt  # (B, S, H) ≤ 0
        xh = xi.reshape(B, S, H, P)
        xd = xh * dt[..., None].to(xh.dtype)
        # B/C are shared by the heads of a group: repeated, as the reference does.
        Bh = Bmat.reshape(B, S, G, N).repeat_interleave(H // G, dim=2)
        Ch = Cmat.reshape(B, S, G, N).repeat_interleave(H // G, dim=2)

        def fold(a):  # (B, S, H, ...) → (B·H, S, ...)
            return a.transpose(1, 2).reshape(B * H, S, *a.shape[3:])

        xd_f, loga_f, B_f, C_f = fold(xd), fold(loga[..., None])[..., 0], fold(Bh), fold(Ch)
        h0 = None if cache is None else cache["ssm"]
        if cache is None or S > 1:
            y_f, hT = ssd_scan(xd_f, loga_f, B_f, C_f, h0)
        else:
            hT, y_step = ssd_decode_step(h0, xd_f[:, 0], loga_f[:, 0], B_f[:, 0], C_f[:, 0])
            y_f = y_step[:, None]
        y = y_f.reshape(B, H, S, P).transpose(1, 2)  # (B, S, H, P)
        y = y + xh.to(y.dtype) * self.skip_D[None, None, :, None]
        y = y.reshape(B, S, d_inner)
        y = rms_norm(y * silu(z), self.out_norm, cfg.norm_eps)
        out = x + dense(y, self.w_out)
        new_cache = None if cache is None else {"conv": new_conv_state, "ssm": hT}
        return out, new_cache
