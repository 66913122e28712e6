"""Transformer and Mamba-2 blocks with full-sequence and decode paths.

Counterpart of ``repro.models.blocks`` (the MoE block is not ported yet).
Each block is an ``nn.Module`` holding the reference's parameters under the
reference's names and layouts; ``forward(x, ...)`` returns ``(y, new_cache)``.

Caches are dicts of tensors. Unlike the reference, whose arrays are
immutable, the attention cache is written in place (one slot per step) and
the returned dict shares its tensors: a decode step costs no copy of the
cache. The position ``pos`` is a Python int, so a step needs no host read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
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
