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


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``. On DTensors ``y`` (a row-parallel product's partial sum) is
    first placed like the residual stream ``x``: the reduce-scatter of a
    sequence-parallel block, which DTensor does not pick by itself."""
    from ..parallel.sharding import is_dtensor

    if is_dtensor(y) and is_dtensor(x) and tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def _params(module: nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# Attention block.
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    from ..parallel.sharding import fit_heads, is_dtensor

    B, S, _ = x.shape
    if is_dtensor(x):
        x = fit_heads(x, n_heads)
    return x.reshape(B, S, n_heads, dh).transpose(1, 2)  # (B, H, S, dh)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    from ..parallel.sharding import fit_heads_grad, is_dtensor

    B, H, S, dh = x.shape
    if is_dtensor(x):  # a copy first: a shard of one head has no stride to tell DTensor it cannot view
        return fit_heads_grad(x.transpose(1, 2).contiguous().reshape(B, S, H * dh), H)
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _write_slot(cache, slot: int, new):
    """``cache[:, :, slot] = new``, in place: cache (B, H, Smax, dh), new
    (B, H, dh). On a DTensor cache each rank writes its local shard (a rank
    of a cache sharded over its sequence only where it holds the slot): an
    indexed write into a sharded DTensor lands in a temporary."""
    from ..parallel.sharding import is_dtensor

    if not is_dtensor(cache):
        cache[:, :, slot] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, local = cache.device_mesh, cache.to_local()
    pl = tuple(Replicate() if p == Shard(2) else p for p in cache.placements)
    new = new.to(cache.dtype).redistribute(mesh, pl).to_local()
    for i, p in enumerate(cache.placements):
        if p == Shard(2):
            slot -= mesh.get_local_rank(i) * local.shape[2]
    if 0 <= slot < local.shape[2]:
        local[:, :, slot] = new


def _decode_attention(q, k_cache, v_cache, keep, scale):
    """Masked single-query attention over a fixed-size cache, in float32.

    q: (B, Hq, 1, dh); caches: (B, Hkv, Smax, dh); keep: (Smax,) bool mask of
    the valid cache slots. On DTensors it runs on each rank's (row, head)
    shards through ``local_map``; a cache sharded over its sequence (the
    reference's flash-decode ``cache_shardings``) stays so: each rank of
    the model axis attends over its slots (``_decode_attention_slots``).
    """
    from ..parallel.sharding import is_dtensor

    if is_dtensor(q):
        from torch.distributed.tensor import Shard

        from ..parallel.sharding import head_placements, local_call, mesh_axes

        mesh = q.device_mesh
        names = list(mesh_axes(mesh))
        if "model" in names and k_cache.placements[names.index("model")] == Shard(2):
            return _decode_attention_slots(q, k_cache, v_cache, keep, scale)
        keep = keep.full_tensor() if is_dtensor(keep) else keep
        pl = head_placements(mesh, q.shape[0], k_cache.shape[1])
        return local_call(lambda q, k, v: _decode_attention(q, k, v, keep, scale), (pl, pl, pl), pl,
                          q, k_cache, v_cache)
    B, Hq, _, dh = q.shape
    Hkv = k_cache.shape[1]
    group = Hq // Hkv
    qf = q.float().reshape(B, Hkv, group, dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) * scale
    s = torch.where(keep[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, dh).to(q.dtype)


def _decode_attention_slots(q, k_cache, v_cache, keep, scale):
    """Flash-decode over a cache sharded over its sequence on the model axis:
    each rank of that axis scores the query against its slots of the cache
    (its slice of ``keep`` masks them); the ranks then combine by
    log-sum-exp: the scores' max over the axis first (an all-reduce of
    max), then the partial sums of exp(s − max)·v and of exp(s − max) (one
    all-reduce), then the division. The cache is never gathered."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel.sharding import batch_axes, local_call, mesh_axes

    mesh = q.device_mesh
    axes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    B, Hq, _, dh = q.shape
    Hkv, smax = k_cache.shape[1], k_cache.shape[2]
    rows = Shard(0) if B % math.prod(axes[a] for a in baxes) == 0 else Replicate()
    group = (mesh, list(axes).index("model"))
    n_local = smax // axes["model"]
    lo = mesh.get_local_rank("model") * n_local
    mine = keep[lo:lo + n_local]

    def local(q, k, v):
        Bl = q.shape[0]
        qf = q.float().reshape(Bl, Hkv, Hq // Hkv, dh)
        s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * scale
        s = torch.where(mine[None, None, None, :], s, -1e30)
        m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
        p = torch.exp(s - m)
        num_den = torch.cat([torch.einsum("bhgs,bhsd->bhgd", p, v.float()), p.sum(-1, keepdim=True)], dim=-1)
        num_den = funcol.all_reduce(num_den, "sum", group)
        o = num_den[..., :dh] / num_den[..., dh:]
        return o.reshape(Bl, Hq, 1, dh).to(q.dtype)

    pl_q = tuple(rows if a in baxes else Replicate() for a in axes)
    pl_kv = tuple(rows if a in baxes else Shard(2) if a == "model" else Replicate() for a in axes)
    return local_call(local, (pl_q, pl_kv, pl_kv), pl_q, q, k_cache, v_cache)


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
            _write_slot(k_cache, write, k[:, :, 0])
            _write_slot(v_cache, write, v[:, :, 0])
            new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
            attn = _decode_attention(q, k_cache, v_cache, keep, scale)
        else:
            # Cross-attention decode: K/V recomputed from the source each step.
            keep = torch.ones((k.shape[2],), dtype=torch.bool, device=x.device)
            new_cache = cache
            attn = _decode_attention(q, k, v, keep, scale)

        x = _residual(x, dense(_merge_heads(attn), self.wo))
        if self.with_mlp:
            h = rms_norm(x, self.norm2, cfg.norm_eps)
            x = _residual(x, dense(silu(dense(h, self.wi_gate)) * dense(h, self.wi_up), self.wdown))
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


def moe_ffn(p: "MoE", x: torch.Tensor, m: MoECfg, first_expert: int = 0):
    """Routed expert FFN on G groups of T tokens, x (G, T, D) → (G, T, D),
    plus the routing stats (``repro.models.blocks.moe_ffn`` on each group).

    ``p.we_*`` may hold a slice of the experts, ``first_expert`` onwards
    (expert parallelism): the routing still runs over all E experts, and
    only the slice's slots are gathered, computed and summed into ``y``; a
    choice of another expert adds 0. The slices' ``y`` sum to the whole
    block's.

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

    E_l = p.we_gate.shape[0]
    lo, hi = first_expert * G * C, (first_expert + E_l) * G * C  # the slice's slots
    if E_l < E:
        keep = keep & (slot >= lo) & (slot < hi)
        token_map, valid = token_map[lo:hi], valid[lo:hi]

    xe = (x.reshape(G * T, D).index_select(0, token_map) * valid[:, None]).reshape(E_l, G * C, D)
    he = torch.bmm(xe, p.we_gate.to(x.dtype))
    ue = torch.bmm(xe, p.we_up.to(x.dtype))
    ye = torch.bmm(silu(he) * ue, p.we_down.to(x.dtype)).reshape(hi - lo, D)
    gate = (gate_vals.reshape(G, T * K) * keep).to(x.dtype)
    picked = ye.index_select(0, torch.where(keep, slot - lo, 0).reshape(-1)).reshape(G, T * K, D)
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
        from ..parallel.sharding import is_dtensor

        if is_dtensor(x):
            return self._forward_sharded(x)
        return _moe_forward(self, x, self.cfg)

    def _forward_sharded(self, x):
        """The block on DTensors (the sharded step). DTensor has no sharding
        strategy for the dispatch (the stable sort, the scatters and
        gathers), so the routed experts run through ``local_map`` on each
        rank's rows (gathered over the sequence): with one dispatch group a
        row (S ≥ 4·E) the batch stays sharded over the data axes and the
        loads and aux loss are partial sums over them; with one global
        group (decode) the tokens are gathered too.

        Expert parallelism, the reference's rule for the expert weights
        (E over the model axis): where the model axis divides E, each rank
        of it holds its E / |model| experts (gathered over the data axes
        only), routes every token of its rows over all E, and computes and
        sums only its own experts' slots, so the block's output leaves as a
        partial sum over the model axis and the residual stream's placement
        reduces it. The slots never leave their rank: a group's tokens are
        on every rank of the model axis. The router, the capacities and the
        loads are the same on every rank of the model axis; so the
        gradients that reach the router and the tokens are partial sums over
        it, and each rank passes back 1/|model| of the aux loss's. Where the
        model axis does not divide E (of the registry's configurations, the
        reduced ones, E = 8, on a model axis of 16), the experts are
        gathered over it too and every rank of it computes the whole block,
        as the reference's ``_fit`` replicates a dim the mesh does not
        divide. The shared experts run on DTensors, tensor-parallel as
        the dense MLP. The same numbers as ``_moe_forward`` on the full
        batch, to the float order of the sums."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        from ..parallel.sharding import batch_axes, local_call, mesh_axes, scale_grad

        mesh = x.device_mesh
        B, S, _ = x.shape
        cfg, m = self.cfg, self.cfg.moe
        E = m.num_experts
        axes = mesh_axes(mesh)
        baxes = batch_axes(mesh)
        n_b = math.prod(axes[a] for a in baxes)
        n_m = axes.get("model", 1)
        split = S >= 4 * E and B % n_b == 0 and n_b > 1
        ep = n_m > 1 and E % n_m == 0
        first = mesh.get_local_rank("model") * (E // n_m) if ep else 0

        def place(on_batch, on_model):
            return tuple(on_batch if a in baxes else on_model if a == "model" else Replicate() for a in axes)

        rows, part = Shard(0) if split else Replicate(), Partial() if ep else Replicate()
        summed = Partial() if split else Replicate()
        rep = place(Replicate(), Replicate())
        experts = place(Replicate(), Shard(0) if ep else Replicate())
        share = 1.0 / n_b if split else 1.0

        def local(h, router, *we):
            Bl = h.shape[0]
            groups = h if S >= 4 * E else h.reshape(1, Bl * S, -1)
            w = _Weights(dict(router=router, we_gate=we[0], we_up=we[1], we_down=we[2]))
            y, stats = moe_ffn(w, groups, m, first)
            aux = stats["aux_loss"] * share
            return y.reshape(Bl, S, -1), stats["expert_load"], scale_grad(aux, 1.0 / n_m) if ep else aux

        h = rms_norm(x, self.norm1, cfg.norm_eps)
        y, load, aux = local_call(
            local, (place(rows, Replicate()), rep, experts, experts, experts),
            (place(rows, part), place(summed, Replicate()), place(summed, Replicate())),
            h, self.router, self.we_gate, self.we_up, self.we_down,
            grad_placements=(place(rows, part), place(summed, part),
                             *(place(summed, Shard(0) if ep else Replicate()),) * 3))
        if m.num_shared:
            x = _residual(x, dense(silu(dense(h, self.ws_gate)) * dense(h, self.ws_up), self.ws_down))
        return _residual(x, y), {"expert_load": load, "aux_loss": aux}


class _Weights:
    """Local parameter tensors under their block's names (``moe_ffn`` reads
    them as attributes)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        self.__dict__.update(tensors)


def _moe_forward(p, x, cfg: ModelConfig):
    B, S, D = x.shape
    m = cfg.moe
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    groups = h if S >= 4 * m.num_experts else h.reshape(1, B * S, D)
    y, stats = moe_ffn(p, groups, m)
    y = y.reshape(B, S, D)
    if m.num_shared:
        y = y + dense(silu(dense(h, p.ws_gate)) * dense(h, p.ws_up), p.ws_down)
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


def _ssd_heads(xd, loga, Bh, Ch, h0=None):
    """The SSD transform on (B, S, H, ·) inputs (``loga`` (B, S, H)):
    folded to (B·H, S, ·) for ``ssd_scan`` (one token with a state:
    ``ssd_decode_step``) → (y (B, S, H, P), final state (B·H, N, P))."""
    B, S, H, _ = xd.shape

    def fold(a):  # (B, S, H, ...) → (B·H, S, ...)
        return a.transpose(1, 2).reshape(B * H, S, *a.shape[3:])

    xd_f, loga_f, B_f, C_f = fold(xd), fold(loga[..., None])[..., 0], fold(Bh), fold(Ch)
    if h0 is None or S > 1:
        y_f, hT = ssd_scan(xd_f, loga_f, B_f, C_f, h0)
    else:
        hT, y_step = ssd_decode_step(h0, xd_f[:, 0], loga_f[:, 0], B_f[:, 0], C_f[:, 0])
        y_f = y_step[:, None]
    return y_f.reshape(B, H, S, -1).transpose(1, 2), hT


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
        from ..parallel.sharding import head_placements, is_dtensor, local_call

        if is_dtensor(xd) and cache is None:  # the sharded step: each rank's (row, head) shards
            pl = head_placements(xd.device_mesh, B, H, head_dim=2)
            y, hT = local_call(lambda *a: _ssd_heads(*a)[0], (pl,) * 4, pl, xd, loga, Bh, Ch), None
        elif is_dtensor(xd):  # sharded decode: rows over the data axes; the state (B·H, N, P) is row-major
            mesh = xd.device_mesh
            pl, pl_h = head_placements(mesh, B, 1, head_dim=2), head_placements(mesh, B, 1)
            y, hT = local_call(_ssd_heads, (pl,) * 4 + (pl_h,), (pl, pl_h), xd, loga, Bh, Ch, cache["ssm"])
        else:
            y, hT = _ssd_heads(xd, loga, Bh, Ch, None if cache is None else cache["ssm"])
        y = y + xh.to(y.dtype) * self.skip_D[None, None, :, None]
        y = y.reshape(B, S, d_inner)
        y = rms_norm(y * silu(z), self.out_norm, cfg.norm_eps)
        out = _residual(x, dense(y, self.w_out))
        new_cache = None if cache is None else {"conv": new_conv_state, "ssm": hT}
        return out, new_cache
