"""Sharding rules as DTensor placements (``repro.parallel.sharding``).

The rules are the reference's: TP + FSDP for parameters and optimizer
moments, DP for the batch.

  * 2-D weights (d_model, flat_out) → ("data", "model"): tensor parallelism
    over the flattened output dim, FSDP over the d_model dim.
  * transposed weights (flat_in, d_model) → ("model", "data").
  * expert weights (E, d, f) → ("model", "data", None): expert parallelism
    over the model axis.
  * embed (V, D) → ("model", "data") (vocab-parallel).
  * 1-D parameters → replicated.
  * every rule is checked against the mesh: a dim its mesh axes do not
    divide is replicated (never an error).

Two forms of a spec. ``param_pspec`` and friends give the reference's
form, one entry per **tensor** dim: None, an axis name or a tuple of axis
names. ``placements`` turns it into DTensor's form, one entry per **mesh**
dim: a tensor dim sharded over ("pod", "data") is ``Shard(d)`` on both
mesh dims, in that order. The port's layers are per-layer tensors (an
``nn.ModuleList``), not the reference's stacked arrays, so the reference's
leading None of the stack dim does not appear; a rule is found by the last
component of the state name (``periods.0.1.wq`` → ``wq``).

A mesh is a ``DeviceMesh`` with named dims, or anything whose ``shape`` is a
dict of axis sizes (as a JAX ``Mesh``'s is).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

_TP, _FSDP = "model", "data"
_RULES: dict[str, tuple] = {
    "embed": (_TP, _FSDP),
    "lm_head": (_FSDP, _TP),
    "wq": (_FSDP, _TP),
    "wk": (_FSDP, _TP),
    "wv": (_FSDP, _TP),
    "wo": (_TP, _FSDP),
    "wi_gate": (_FSDP, _TP),
    "wi_up": (_FSDP, _TP),
    "wdown": (_TP, _FSDP),
    "router": (_FSDP, None),
    "we_gate": (_TP, _FSDP, None),
    "we_up": (_TP, _FSDP, None),
    "we_down": (_TP, None, _FSDP),
    "ws_gate": (_FSDP, _TP),
    "ws_up": (_FSDP, _TP),
    "ws_down": (_TP, _FSDP),
    "w_xz": (_FSDP, _TP),
    "w_bc": (_FSDP, _TP),
    "w_dt": (_FSDP, _TP),
    "conv_w": (None, _TP),
    "w_out": (_TP, _FSDP),
}

Spec = tuple  # per tensor dim: None, an axis name, or a tuple of axis names


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name → size, in the mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(axes: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(axes[a] for a in axis)
    return axes[axis]


def _fit(spec: tuple, shape: tuple, axes: dict[str, int]) -> Spec:
    """Divisibility-checked spec: non-divisible dims are replicated."""
    return tuple(ax if ax is not None and ax in axes and dim % _axis_size(axes, ax) == 0 else None
                 for dim, ax in zip(shape, spec))


def _rule_name(name: str) -> str:
    return name.rsplit(".", 1)[-1].rsplit("/", 1)[-1]


def param_pspec(name: str, shape, mesh, mode: str = "tp_fsdp") -> Spec:
    """The spec of parameter ``name`` (a state name) of ``shape``: one entry
    per tensor dim, the reference's ``param_pspec`` without its stack dims."""
    shape = tuple(shape)
    rule = _RULES.get(_rule_name(name))
    if rule is None or len(shape) < len(rule):
        return (None,) * len(shape)  # replicate (norms, biases, scalars)
    if mode == "tp_only":  # replicate along data (no FSDP): a perf knob
        rule = tuple(None if ax == _FSDP else ax for ax in rule)
    elif mode != "tp_fsdp":
        raise ValueError(f"unknown sharding mode {mode!r}")
    lead = len(shape) - len(rule)
    return _fit((None,) * lead + tuple(rule), shape, mesh_axes(mesh))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a per-tensor-dim spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two tensor dims in {spec}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a per-tensor-dim spec: what ``distribute`` places a tensor by."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _map(tree, fn, prefix: str = ""):
    """``fn(name, leaf)`` over a tree of dicts/lists of tensors; leaves that
    are not tensors (the cache's ``pos``) map to None."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(prefix[:-1], tree)
    return None


def param_shardings(params: dict, mesh, mode: str = "tp_fsdp") -> dict:
    """``NamedSharding`` per parameter; an optimizer state ({"mu", "nu",
    "step"}) maps its moments like the parameters and its step replicated."""
    return _map(params, lambda name, t: NamedSharding(mesh, param_pspec(name, t.shape, mesh, mode)))


def batch_axes(mesh) -> tuple:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def batch_spec(shape, mesh) -> Spec:
    """Batch inputs: dim 0 over ("pod", "data") when they divide it."""
    axes = batch_axes(mesh)
    bsz = _axis_size(mesh_axes(mesh), axes)
    shape = tuple(shape)
    if not shape:
        return ()
    return (axes if shape[0] % bsz == 0 else None,) + (None,) * (len(shape) - 1)


def batch_shardings(batch: dict, mesh) -> dict:
    return _map(batch, lambda name, t: NamedSharding(mesh, batch_spec(t.shape, mesh)))


def cache_pspec(name: str, shape, mesh) -> Spec:
    """Decode caches: batch → (pod, data); heads → model if divisible, else
    sequence → model (flash-decode style); SSD state dims likewise."""
    ax = mesh_axes(mesh)
    axes = batch_axes(mesh)
    bsz = _axis_size(ax, axes)
    tp = _axis_size(ax, _TP if _TP in ax else None)
    shape = tuple(shape)
    name = _rule_name(name)
    nd = len(shape)

    def bax(b):
        return axes if b % bsz == 0 and bsz > 1 else None

    if name in ("k", "v") and nd >= 4:
        lead = (None,) * (nd - 4)
        B, H, S, _ = shape[-4:]
        if H % tp == 0:
            return lead + (bax(B), _TP, None, None)
        if S % tp == 0:
            return lead + (bax(B), None, _TP, None)
        return lead + (bax(B), None, None, None)
    if name == "ssm" and nd >= 3:
        return (None,) * (nd - 3) + (_TP if shape[-3] % tp == 0 else None, None, None)
    if name == "conv" and nd >= 3:
        B, _, C = shape[-3:]
        return (None,) * (nd - 3) + (bax(B), None, _TP if C % tp == 0 else None)
    if name == "enc_out" and nd == 3:
        return (bax(shape[0]), None, None)
    return (None,) * nd


def cache_shardings(cache: dict, mesh) -> dict:
    return _map(cache, lambda name, t: NamedSharding(mesh, cache_pspec(name, t.shape, mesh)))


def default_act_pspec(mesh) -> Spec:
    """Activation constraint between blocks: batch over (pod, data),
    sequence over model (Megatron-style sequence parallelism)."""
    return (batch_axes(mesh), _TP, None)


def fit_placements(spec: Spec, shape, mesh) -> tuple:
    """``placements`` of ``spec`` (entries may be tuples of axes, as the
    batch's ("pod", "data")) with the dims its axes do not divide
    replicated: the reference's ``with_sharding_constraint`` of the
    activations, which shards the batch."""
    axes = mesh_axes(mesh)

    def fits(dim, ax):
        names = ax if isinstance(ax, tuple) else (ax,)
        return ax is not None and all(a in axes for a in names) and dim % _axis_size(axes, ax) == 0

    return placements(tuple(ax if fits(dim, ax) else None for dim, ax in zip(tuple(shape), spec)), mesh)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``sharding``; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def distribute_tree(tree, shardings):
    """``distribute`` over matching trees of tensors and shardings; other
    leaves (an optimizer's host ``step``) pass through."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k] if shardings is not None else None) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s) for v, s in zip(tree, shardings))
    if isinstance(shardings, NamedSharding) and isinstance(tree, torch.Tensor):
        return distribute(tree, shardings)
    return tree


# ---------------------------------------------------------------------------
# The sharded step's local pieces: the kernels and the MoE dispatch run on
# each rank's shard through ``local_map``.
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def head_placements(mesh, batch: int, heads: int, head_dim: int = 1) -> tuple:
    """Tensors of a per-(row, head) kernel, batch at dim 0 and heads at
    ``head_dim``: batch over ("pod", "data") when they divide B, heads over
    model when it divides H, the rest replicated. With ``heads`` = 1 a
    (B·H, ...) tensor folded batch-major is placed like its (B, H, ...) form."""
    from torch.distributed.tensor import Replicate, Shard

    axes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    b_ok = batch % _axis_size(axes, baxes) == 0
    h_ok = _TP in axes and heads % axes[_TP] == 0 and heads > 1
    return tuple(Shard(0) if (a in baxes and b_ok) else Shard(head_dim) if (a == _TP and h_ok) else Replicate()
                 for a in axes)


def gqa_placements(mesh, batch: int, hq: int, hkv: int):
    """Placements of a GQA kernel's q (B, Hq, ...) and k/v (B, Hkv, ...) →
    (q's, k's and v's, their gradients', this rank's KV heads (lo, hi) or
    None). The batch goes over the data axes and the heads over the model
    axis as ``head_placements`` puts them. Where the model axis divides Hq
    but not Hkv, q stays sharded (Hq / |model| query heads a rank) and k, v
    come in replicated over the axis: a rank's query heads fill whole KV
    groups or lie inside one (Hq / |model| and the group size Hq / Hkv
    divide one another), so it needs only KV heads [lo, hi), and their
    gradients are partial sums over the axis. Where the model axis divides
    neither head count (qwen2-vl's 12:2 or whisper's 6:6 on a 16-wide axis),
    or the two quotients do not divide one another, q is gathered with k
    and v."""
    from torch.distributed.tensor import Partial

    pl_q, pl_kv = head_placements(mesh, batch, hq), head_placements(mesh, batch, hkv)
    if pl_q == pl_kv:
        return pl_q, pl_kv, pl_kv, None
    r, group = hq // mesh_axes(mesh)[_TP], hq // hkv
    if r % group and group % r:
        return pl_kv, pl_kv, pl_kv, None
    j = mesh.get_local_rank(_TP)
    grad = tuple(Partial() if a == _TP else p for a, p in zip(mesh_axes(mesh), pl_kv))
    return pl_q, pl_kv, grad, (j * r // group, ((j + 1) * r - 1) // group + 1)


def fit_heads(x, n_heads: int, dim: int = -1):
    """``x`` with the shards of dim ``dim`` (by default the last, H·dh) that
    would split one of its ``n_heads`` outer groups gathered: the rules
    divide H·dh, a split into (H, dh) needs H divided."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    d = dim % x.ndim
    pl, ways = [], 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == d:
            if n_heads % (ways * mesh.size(i)):
                p = Replicate()
            else:
                ways *= mesh.size(i)
        pl.append(p)
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh, pl)


class _MapGrad(torch.autograd.Function):
    """Identity whose backward passes the gradient through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def scale_grad(x, c: float):
    """``x`` as it is, its gradient times ``c``."""
    return _MapGrad.apply(x, lambda g: g * c)


def fit_heads_grad(x, n_heads: int):
    """``x`` (B, S, H·dh) as it is, its gradient passed through ``fit_heads``:
    the backward of a merge of heads meets the same split."""
    return _MapGrad.apply(x, lambda g: fit_heads(g, n_heads))


def gather_inner_grad(y):
    """``y`` as it is, its gradient passed through ``gather_inner``."""
    return _MapGrad.apply(y, gather_inner)


def gather_inner(x):
    """``x`` with every shard of a middle dim (the sequence) gathered: the
    all-gather a sequence-parallel block does before its first product, so
    a flatten of (B, S, D) never meets a sequence shard."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def local_call(fn, placements_in: tuple, placements_out, *tensors, grad_placements: tuple | None = None):
    """``fn`` on each rank's local shards of ``tensors`` (DTensors, first
    redistributed to ``placements_in``), its outputs wrapped as DTensors
    with ``placements_out`` (``local_map``). ``grad_placements`` are the
    placements of the inputs' gradients (default: their own)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = tensors[0].device_mesh
    args = [t.redistribute(mesh, pl) for t, pl in zip(tensors, placements_in)]
    # local_map reads a list as one output's placements, a tuple as one entry per output.
    outs = [*placements_out] if _is_placements(placements_out) else tuple(map(list, placements_out))
    return local_map(fn, out_placements=outs, in_placements=tuple(map(list, placements_in)),
                     in_grad_placements=None if grad_placements is None else tuple(map(list, grad_placements)),
                     device_mesh=mesh)(*args)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return all(isinstance(p, Placement) for p in x)
