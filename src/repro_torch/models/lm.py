"""Language-model assembly for all six families.

Counterpart of ``repro.models.lm.LM``:

  dense   — GQA transformer; ``pattern_local`` layers per period use the
            sliding ``window`` (gemma3's 5 local : 1 global), the rest are
            global; layers that do not fill a period form the remainder
  moe     — the dense layout with each layer an attention block (no MLP)
            followed by the routed-expert FFN (qwen3-moe, deepseek-moe);
            ``apply`` also returns the layers' summed ``aux_loss`` and
            ``expert_load``, which ``loss`` adds and reports
  vlm     — the dense layout with M-RoPE (qwen2-vl); ``patch_embeds``
            overwrite the first n_patch positions (the patch front end is
            stubbed, as in the reference)
  ssm     — a pure Mamba-2 stack
  hybrid  — Mamba-2 groups of ``attn_every`` layers, each followed by ONE
            shared attention block (zamba2: the same parameters at every
            insertion), then the remainder Mamba-2 layers
  audio   — whisper encoder–decoder: ``encode`` runs non-causal attention
            over precomputed ``frames`` (the conv front end is stubbed); each
            decoder layer is causal self-attention, then cross-attention to
            the encoder's output (its K/V recomputed every decode step, as
            in the reference)

The layers the reference stacks for ``lax.scan`` are ``nn.ModuleList``s
here, run by a Python loop.

Training is functional, as in the reference: ``init(seed)`` gives a fresh
parameter dict (the port's state names), ``bound(params)`` computes with
such a dict in place of the model's own parameters, and ``loss(batch)`` is
the next-token NLL (plus the MoE aux loss). ``remat`` (the reference's
field) checkpoints each scanned block: a period (dense, moe, vlm), a layer
(ssm), a group (hybrid) or a decoder layer (audio).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.backend import resolve_device
from .blocks import Attention, Mamba, MoE, ssm_dims
from .layers import dense, rms_norm, winit, zinit

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """−log softmax(logits)[target] at each position: logits (..., V)
    float32, targets (...) int64.

    A DTensor ``logits`` sharded over the vocabulary (its last dim, on mesh
    dims of more than one rank) stays so, as the reference's logits do under
    GSPMD: each rank works on its own range of the vocabulary through
    ``local_map`` (``_VocabParallelNLL``), with three all-reduces of one
    value a position over the axes that shard it (the max, the sum of
    exp(logit − max), the target's logit from the rank that owns it). Any
    other input runs ``log_softmax`` and a gather."""
    from ..parallel.sharding import is_dtensor

    if is_dtensor(logits):
        from torch.distributed.tensor import Shard

        last = logits.ndim - 1
        dims = [i for i, p in enumerate(logits.placements)
                if isinstance(p, Shard) and p.dim == last and logits.device_mesh.size(i) > 1]
        if dims:
            return _vocab_parallel_nll(logits, targets, dims)
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, targets[..., None])[..., 0]


class _VocabParallelNLL(torch.autograd.Function):
    """One rank's part of the NLL over its vocabulary range [lo, lo + V_local):
    z (..., V_local) its logits, t (...) the targets, ``groups`` the mesh dims
    that shard the vocabulary. The backward is softmax − onehot on the
    rank's own columns, times the upstream gradient: no collective."""

    @staticmethod
    def forward(ctx, z, t, lo: int, groups: list):
        import torch.distributed._functional_collectives as funcol

        def all_reduce(x, op):
            for g in groups:
                x = funcol.all_reduce(x, op, g)
            return x

        m = all_reduce(z.amax(dim=-1), "max")
        total = all_reduce(torch.exp(z - m[..., None]).sum(dim=-1), "sum")
        local = t - lo
        mine = (local >= 0) & (local < z.shape[-1])
        local = torch.where(mine, local, 0)
        zt = all_reduce(torch.where(mine, torch.gather(z, -1, local[..., None])[..., 0], 0.0), "sum")
        lse = torch.log(total) + m
        ctx.save_for_backward(z, lse, local, mine)
        return lse - zt

    @staticmethod
    def backward(ctx, g):
        z, lse, local, mine = ctx.saved_tensors
        grad = torch.exp(z - lse[..., None])
        grad.scatter_add_(-1, local[..., None], -mine.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _vocab_parallel_nll(logits, targets, dims: list):
    """``token_nll`` of ``logits`` sharded over the vocabulary on mesh dims
    ``dims``: the rows keep the logits' other placements, the result is
    replicated over ``dims``, and the logits' gradient keeps their
    placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..parallel.sharding import local_call

    mesh = logits.device_mesh
    z_pl = tuple(p if isinstance(p, Shard) else Replicate() for p in logits.placements)
    rows = tuple(Replicate() if i in dims else p for i, p in enumerate(z_pl))
    lo, size = 0, logits.shape[-1]  # this rank's first column: DTensor's chunks, the first mesh dim outermost
    for i in dims:
        chunk = -(-size // mesh.size(i))
        lo += mesh.get_local_rank(i) * chunk
        size = max(0, min(chunk, size - mesh.get_local_rank(i) * chunk))
    groups = [(mesh, i) for i in dims]
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, tuple(Replicate() for _ in range(mesh.ndim)), run_check=False)
    return local_call(lambda z, t: _VocabParallelNLL.apply(z, t, lo, groups), (z_pl, rows), rows, logits, targets)


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


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, enc_out: torch.Tensor | None = None,
               device=None) -> dict:
    """Fresh decode caches of ``cfg`` on ``device`` (``meta`` gives their
    shapes alone, ``cache_specs``); the audio family needs the encoder's
    output ``enc_out`` (B, S_enc, D), which the cache keeps."""
    kw = dict(dtype=torch_dtype(cfg), device=device)
    dh, Hkv = cfg.resolved_head_dim, cfg.num_kv_heads

    def kv(length):
        return {"k": torch.zeros((batch_size, Hkv, length, dh), **kw),
                "v": torch.zeros((batch_size, Hkv, length, dh), **kw), "pos": 0}

    def ssm_cache():
        s, _, H, conv_dim = ssm_dims(cfg)
        return {"conv": torch.zeros((batch_size, s.conv_width - 1, conv_dim), **kw),
                "ssm": torch.zeros((batch_size * H, s.d_state, s.head_dim), dtype=torch.float32, device=device)}

    if cfg.family in ("dense", "moe", "vlm"):
        period, n_periods, rem = layer_pattern(cfg)

        def layer_len(local):  # local layers need only a window-sized cache
            return min(cfg.window, max_len) if local and cfg.window else max_len

        return {"periods": [[kv(layer_len(local)) for local in period] for _ in range(n_periods)],
                "remainder": [kv(layer_len(local)) for local in rem]}
    if cfg.family == "ssm":
        return {"layers": [ssm_cache() for _ in range(cfg.num_layers)]}
    if cfg.family == "hybrid":
        n_groups, rem_n = hybrid_layout(cfg)
        return {"groups": [{"mamba": [ssm_cache() for _ in range(cfg.attn_every)], "attn": kv(max_len)}
                           for _ in range(n_groups)],
                "remainder": [ssm_cache() for _ in range(rem_n)]}
    if enc_out is None:
        raise ValueError("the audio decode cache needs the encoder's output enc_out")
    # Cross K/V are recomputed from enc_out every step; "cross" is the
    # reference's placeholder entry.
    return {"dec_layers": [{"self": kv(max_len), "cross": kv(8)} for _ in range(cfg.num_layers)],
            "enc_out": enc_out.to(device=device, dtype=kw["dtype"])}


class LM(nn.Module):
    """``LM(cfg, device=None, seed=0, remat=False)``: the model with fresh random weights.

    ``device=None`` means CUDA and raises without a GPU; the CPU runs only
    when named. Weights are drawn by a ``torch.Generator`` on the device,
    seeded with ``seed``, at the reference's scales and in the config's type.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0, remat: bool = False,
                 act_pspec: tuple | None = None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self.remat = remat
        self.act_pspec = act_pspec
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(dtype=torch_dtype(cfg), device=dev)
        self.embed = nn.Parameter(winit(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, **kw), requires_grad=False)
        self.final_norm = nn.Parameter(zinit((cfg.d_model,), **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(winit(gen, (cfg.d_model, cfg.vocab_size), **kw), requires_grad=False)
        if cfg.family in ("dense", "moe", "vlm"):
            def layer():
                if cfg.family == "moe":
                    return nn.ModuleDict({"attn": Attention(cfg, gen, with_mlp=False, **kw),
                                          "moe": MoE(cfg, gen, **kw)})
                return Attention(cfg, gen, **kw)

            period, n_periods, rem = layer_pattern(cfg)
            self.periods = nn.ModuleList(nn.ModuleList(layer() for _ in period) for _ in range(n_periods))
            self.remainder = nn.ModuleList(layer() for _ in rem)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(cfg.num_layers))
        elif cfg.family == "hybrid":
            n_groups, rem_n = hybrid_layout(cfg)
            self.groups = nn.ModuleList(
                nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(cfg.attn_every)) for _ in range(n_groups))
            self.shared_attn = Attention(cfg, gen, **kw)  # ONE set of parameters
            self.remainder = nn.ModuleList(Mamba(cfg, gen, **kw) for _ in range(rem_n))
        else:
            self.enc_layers = nn.ModuleList(Attention(cfg, gen, **kw) for _ in range(cfg.encoder_layers))
            self.enc_norm = nn.Parameter(zinit((cfg.d_model,), **kw), requires_grad=False)
            self.dec_layers = nn.ModuleList(
                nn.ModuleDict({"self": Attention(cfg, gen, with_mlp=False, **kw), "cross": Attention(cfg, gen, **kw)})
                for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ training
    def init(self, seed: int) -> dict[str, torch.Tensor]:
        """Fresh parameters from ``seed`` on the model's device, keyed by the
        port's state names (the reference's ``LM.init(key)``)."""
        return dict(LM(self.cfg, device=self.device, seed=seed).state_dict())

    def adopt(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Make ``params`` the model's own parameters, without a copy, and
        return the ones they replace. The trainer adopts its state after each
        step, so the weights live on the device once."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise KeyError(f"parameters do not match the model: missing {sorted(set(own) - set(params))[:3]}, "
                           f"unknown {sorted(set(params) - set(own))[:3]}")
        for name, t in params.items():
            mod_name, _, attr = name.rpartition(".")
            self.get_submodule(mod_name)._parameters[attr] = t
        return own

    @contextmanager
    def bound(self, params: dict[str, torch.Tensor]):
        """Compute with ``params`` in place of the model's own parameters,
        without a copy (autograd then reaches ``params``); the model's own
        come back on exit. With ``remat`` the backward recomputes blocks, so
        it must run inside the context too."""
        own = self.adopt(params)
        try:
            yield self
        finally:
            self.adopt(own)

    def loss(self, batch: dict):
        """Next-token NLL of ``batch["tokens"]`` (masked by ``loss_mask`` when
        given), plus the MoE aux loss → (loss, metrics) with metrics ``ce``
        and, for the moe family, ``expert_load``. Logits sharded over the
        vocabulary stay so (``token_nll``)."""
        out = self.apply(batch)
        tokens = batch["tokens"].to(self.device).long()
        nll = token_nll(out["logits"][:, :-1], tokens[:, 1:])
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask.to(device=self.device, dtype=nll.dtype)[:, 1:]
            nll = nll * mask
            denom = torch.clamp(mask.sum(), min=1.0)
        else:
            denom = nll.numel()
        ce = nll.sum() / denom
        loss = ce + out["aux_loss"] if "aux_loss" in out else ce
        metrics = {"ce": ce}
        if "expert_load" in out:
            metrics["expert_load"] = out["expert_load"]
        return loss, metrics

    # ------------------------------------------------------------- forward
    def _constrain(self, x):
        """The activation constraint between blocks (``act_pspec``, the
        reference's ``with_sharding_constraint``): a redistribution of a
        DTensor ``x``; anything else passes."""
        from ..parallel.sharding import is_dtensor

        if self.act_pspec is None or not is_dtensor(x):
            return x
        return x.redistribute(x.device_mesh, self._constrain_placements(x))

    def _constrain_placements(self, x):
        """The placements ``_constrain`` gives a DTensor ``x`` (None without ``act_pspec``)."""
        from ..parallel.sharding import fit_placements

        return None if self.act_pspec is None else fit_placements(self.act_pspec, x.shape, x.device_mesh)

    def _block(self, run, x, decode: bool):
        """One scanned block ``run(x) → (x, caches, *stats)``, checkpointed
        when ``remat`` and a gradient is being recorded (full sequence only),
        then constrained (``_constrain``)."""
        if decode:
            return run(x)
        if not (self.remat and torch.is_grad_enabled()):
            x, caches, *stats = run(x)
            return (self._constrain(x), caches, *stats)

        def forward(x):
            x, _, *stats = run(x)
            return (x, *stats)

        x, *stats = checkpoint(forward, x, use_reentrant=False)
        return (self._constrain(x), None, *stats)

    def _backbone(self, x, positions, caches=None):
        """Decoder trunk; ``caches=None`` is the full-sequence forward.
        Returns (x, new caches or None, stats): the moe family's stats are
        the layers' summed ``aux_loss`` and ``expert_load``, the others' {}."""
        cfg = self.cfg
        decode = caches is not None
        new, stats = {}, {}

        def cache_of(*path):
            if not decode:
                return None
            c = caches
            for key in path:
                c = c[key]
            return c

        if cfg.family in ("dense", "moe", "vlm"):
            period, _, rem = layer_pattern(cfg)
            aux = ()  # moe: (aux_loss, expert_load), summed layer by layer in the reference's order
            if cfg.family == "moe":
                aux = (torch.zeros((), device=x.device), torch.zeros((cfg.moe.num_experts,), device=x.device))

            def apply_layer(layer, x, local, cache, aux):
                window = cfg.window if local else None
                if cfg.family != "moe":
                    x, nc = layer(x, positions=positions, window=window, cache=cache)
                    return x, nc, aux
                x, nc = layer["attn"](x, positions=positions, window=window, cache=cache)
                x, stats = layer["moe"](x)
                return x, nc, (aux[0] + stats["aux_loss"], aux[1] + stats["expert_load"])

            new_periods = []
            for i, layers in enumerate(self.periods):
                def run_period(x, i=i, layers=layers, aux=aux):
                    ncs = []
                    for j, (layer, local) in enumerate(zip(layers, period)):
                        x, nc, aux = apply_layer(layer, x, local, cache_of("periods", i, j), aux)
                        ncs.append(nc)
                    return x, ncs, *aux
                x, ncs, *aux = self._block(run_period, x, decode)
                new_periods.append(ncs)
            new_rem = []
            for i, (layer, local) in enumerate(zip(self.remainder, rem)):
                x, nc, aux = apply_layer(layer, x, local, cache_of("remainder", i), aux)
                new_rem.append(nc)
            new = {"periods": new_periods, "remainder": new_rem}
            if cfg.family == "moe":
                stats = {"aux_loss": aux[0], "expert_load": aux[1]}
        elif cfg.family == "ssm":
            ncs = []
            for i, layer in enumerate(self.layers):
                x, nc = self._block(lambda x, i=i, layer=layer: layer(x, cache=cache_of("layers", i)), x, decode)
                ncs.append(nc)
            new = {"layers": ncs}
        else:
            new_groups = []
            for g, group in enumerate(self.groups):
                def run_group(x, g=g, group=group):
                    m_ncs = []
                    for i, layer in enumerate(group):
                        x, nc = layer(x, cache=cache_of("groups", g, "mamba", i))
                        m_ncs.append(nc)
                    x, a_nc = self.shared_attn(x, positions=positions, cache=cache_of("groups", g, "attn"))
                    return x, {"mamba": m_ncs, "attn": a_nc}
                x, nc = self._block(run_group, x, decode)
                new_groups.append(nc)
            new_rem = []
            for i, layer in enumerate(self.remainder):
                x, nc = layer(x, cache=cache_of("remainder", i))
                new_rem.append(nc)
            new = {"groups": new_groups, "remainder": new_rem}
        return x, (new if decode else None), stats

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Audio encoder (whisper): frames (B, S_enc, D) → (B, S_enc, D),
        non-causal self-attention layers, then ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=torch_dtype(cfg))
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        for layer in self.enc_layers:
            x, _ = layer(x, positions=positions, causal=False)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _decoder_audio(self, x, enc_out, positions, caches=None):
        """Whisper's decoder: per layer, causal self-attention (no MLP), then
        cross-attention over ``enc_out`` (with the MLP)."""
        decode = caches is not None
        new = []
        for i, layer in enumerate(self.dec_layers):
            def run_layer(x, i=i, layer=layer):
                lc = caches["dec_layers"][i] if decode else {"self": None, "cross": None}
                x, self_nc = layer["self"](x, positions=positions, causal=True, cache=lc["self"])
                x, cross_nc = layer["cross"](x, positions=positions, causal=False, cache=lc["cross"],
                                             kv_override=(enc_out, enc_out))
                return x, {"self": self_nc, "cross": cross_nc}
            x, nc = self._block(run_layer, x, decode)
            new.append(nc)
        return x, ({"dec_layers": new} if decode else None)

    def _embed(self, tokens):
        """The token embeddings. On a DTensor table (the sharded step) the
        lookup runs through ``local_map`` on each rank's rows of the batch:
        DTensor's own strategies for the lookup differ from release to
        release. Vocab-parallel, as the reference's rule for the table
        (vocabulary over the model axis): where the model axis divides V,
        each rank of it keeps its V / |model| rows of the table (gathered
        over the data axes only), looks up the ids in its range and gives 0
        for the rest; the sum over the model axis is the lookup (an
        all-reduce, or under sequence parallelism a reduce-scatter to the
        activations' placements). The table's gradient is then sharded like
        the table and a partial sum over the batch axes. Where the model
        axis does not divide V the table is gathered over it too, and its
        range is the whole vocabulary."""
        from ..parallel.sharding import is_dtensor

        if not is_dtensor(self.embed):
            return self.embed[tokens]
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from ..parallel.sharding import head_placements, local_call, mesh_axes

        mesh = self.embed.device_mesh
        V = self.embed.shape[0]
        n_m = mesh_axes(mesh).get("model", 1)
        vp = n_m > 1 and V % n_m == 0
        model = mesh.mesh_dim_names.index("model") if vp else -1
        lo = mesh.get_local_rank("model") * (V // n_m) if vp else 0
        if not isinstance(tokens, DTensor):
            tokens = DTensor.from_local(tokens, mesh, tuple(Replicate() for _ in range(mesh.ndim)), run_check=False)
        rows = head_placements(mesh, tokens.shape[0], 1)

        def lookup(e, t):
            t = t - lo
            mine = (t >= 0) & (t < e.shape[0])
            return torch.where(mine[..., None], e[torch.where(mine, t, 0)], 0)

        def on_model(p_model, p_other, i):
            return p_model if i == model else p_other

        table = tuple(on_model(Shard(0), Replicate(), i) for i in range(mesh.ndim))
        table_grad = tuple(on_model(Shard(0), Partial() if isinstance(p, Shard) else Replicate(), i)
                           for i, p in enumerate(rows))
        out = tuple(on_model(Partial(), p, i) for i, p in enumerate(rows))
        x = local_call(lookup, (table, rows), out, self.embed, tokens, grad_placements=(table_grad, rows))
        return x.redistribute(mesh, self._constrain_placements(x) or rows)

    def _logits(self, x):
        """The float32 logits. On DTensors their rows go over the batch axes
        and their vocabulary stays as the product sharded it: a head whose
        d_model is sharded (the tied table's) leaves partial sums, which are
        reduce-scattered over the batch, as the activations are."""
        from ..parallel.sharding import head_placements, is_dtensor

        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        z = dense(x, head).float()
        if not is_dtensor(z):
            return z
        from torch.distributed.tensor import Shard

        vocab = Shard(z.ndim - 1)
        rows = head_placements(z.device_mesh, z.shape[0], 1)
        return z.redistribute(z.device_mesh, tuple(p if p == vocab else r for p, r in zip(z.placements, rows)))

    def apply(self, batch: dict) -> dict:
        """Full-sequence forward: {"tokens": (B, S) int, ...} → {"logits": (B, S, V)
        float32} and, for the moe family, ``aux_loss`` and ``expert_load``.

        The other inputs: ``frames`` (B, S_enc, D) for audio; for vlm the
        optional ``patch_embeds`` (B, n_patch, D), which overwrite the first
        n_patch positions, and ``positions`` (B, S, 3), which default to three
        equal ``arange`` streams."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        x = self._embed(tokens)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            n_patch = min(batch["patch_embeds"].shape[1], S)
            pe = batch["patch_embeds"][:, :n_patch].to(device=self.device, dtype=x.dtype)
            x = torch.cat([pe, x[:, n_patch:]], dim=1)
        if cfg.mrope_sections:
            positions = batch.get("positions")
            if positions is None:
                positions = torch.arange(S, device=self.device)[None, :, None].expand(B, S, len(cfg.mrope_sections))
            positions = positions.to(self.device)
        else:
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
        if cfg.family == "audio":
            x, _ = self._decoder_audio(x, self.encode(batch["frames"]), positions)
            stats = {}
        else:
            x, _, stats = self._backbone(x, positions)
        return {"logits": self._logits(x), **stats}

    forward = apply

    # -------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int, enc_out: torch.Tensor | None = None) -> dict:
        """Fresh decode caches; the audio family needs the encoder's output
        ``enc_out`` (B, S_enc, D), which the cache keeps."""
        return init_cache(self.cfg, batch_size, max_len, enc_out=enc_out, device=self.device)

    def decode_step(self, caches: dict, token: torch.Tensor):
        """token: (B, 1) int → (logits (B, 1, V) float32, new caches)."""
        x = self._embed(token.to(self.device))
        if self.cfg.family == "audio":
            enc_out = caches["enc_out"]
            x, new_caches = self._decoder_audio(x, enc_out, None, caches=caches)
            new_caches["enc_out"] = enc_out
        else:
            x, new_caches, _ = self._backbone(x, None, caches=caches)
        return self._logits(x), new_caches

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
