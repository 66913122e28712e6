"""Train and serve step builders, single device and sharded (``repro.parallel.steps``).

The single-device steps (``make_train_step``, ``make_serve_step``) are what
the trainer and the serving engine run. The sharded ones run the same
functions on DTensors placed by ``parallel.sharding``: DTensor's sharding
propagation takes the place of GSPMD, the kernels run on each rank's
shards through ``local_map`` (``kernels/flash_attention/ops.py::mha``,
``models/blocks.py::_ssd_heads``), the activations are constrained between
blocks (``LM._constrain``, the reference's ``with_sharding_constraint``)
and the MoE dispatch, for which DTensor has no strategy, runs on gathered
expert weights (``MoE._forward_sharded``). ``trace_cell`` is the
counterpart of the reference's ``lower_cell``: one step on a fake process
group under ``FakeTensorMode``, recorded by ``analysis.collectives``.
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..models.lm import LM
from ..train.optimizer import AdamW, global_norm, warmup_stable_decay


def make_optimizer(total_steps: int = 10_000, peak_lr: float = 3e-4) -> AdamW:
    return AdamW(schedule=warmup_stable_decay(peak_lr, total_steps))


def loss_and_grads(model: LM, params: dict, batch: dict):
    """(loss, metrics, grads) of ``model.loss`` at ``params``, the first half
    of a train step: the forward and the backward, both inside
    ``model.bound`` (``remat`` recomputes there)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad(), model.bound(leaves):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


def make_train_step(model: LM, optimizer: AdamW):
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``params`` is a dict of the model's state names (``model.init(seed)``);
    the step computes with it through ``model.bound`` and returns new
    tensors, leaving its inputs as they are. Metrics: ``loss``,
    ``grad_norm``, ``lr`` and, when the model reports it, ``expert_load``;
    device tensors, read by the caller when it needs them.
    """

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        gn = global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params, grad_norm=gn)
        out = {"loss": loss, "grad_norm": gn, "lr": optimizer.schedule(new_opt["step"])}
        if "expert_load" in metrics:
            out["expert_load"] = metrics["expert_load"]
        return new_params, new_opt, out

    return train_step


def make_serve_step(model: LM):
    """(params, cache, tokens (B, 1)) → (next tokens (B, 1) int32, cache)."""

    def serve_step(params, cache, tokens):
        with torch.no_grad(), model.bound(params):
            logits, cache = model.decode_step(cache, tokens)
        return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32), cache

    return serve_step


# ---------------------------------------------------------------------------
# Sharded steps.
# ---------------------------------------------------------------------------

def make_model_for_cell(cfg: ModelConfig, mesh, *, remat: bool = True, sp: bool = True, device=None,
                        seed: int = 0) -> LM:
    """The model wired for a sharded step: ``remat`` checkpoints each scanned
    block, ``sp`` constrains the activations between blocks to batch over
    ("pod", "data") and sequence over model (``default_act_pspec``)."""
    from ..models.registry import build_model
    from .sharding import default_act_pspec

    act = default_act_pspec(mesh) if (mesh is not None and sp) else None
    return build_model(cfg, device=device, seed=seed, remat=remat, act_pspec=act)


def state_shardings(params: dict, mesh, shard_mode: str = "tp_fsdp") -> tuple[dict, dict]:
    """(parameter shardings, moment shardings). ``zero1`` keeps the
    parameters ``tp_only`` (no FSDP gathers) and the moments ``tp_fsdp``, as
    the reference's ``lower_cell`` does."""
    from .sharding import param_shardings

    p_mode = "tp_only" if shard_mode == "zero1" else shard_mode
    o_mode = "tp_fsdp" if shard_mode == "zero1" else shard_mode
    return param_shardings(params, mesh, p_mode), param_shardings(params, mesh, o_mode)


def shard_state(params: dict, opt_state: dict | None, batch: dict | None, mesh, shard_mode: str = "tp_fsdp"):
    """Full tensors (the same on every rank) → DTensors: the parameters and
    the AdamW moments by ``state_shardings``, the batch by
    ``batch_shardings``; the optimizer's host ``step`` stays as it is."""
    from .sharding import batch_shardings, distribute_tree

    p_shard, o_shard = state_shardings(params, mesh, shard_mode)
    params_s = distribute_tree(params, p_shard)
    opt_s = None
    if opt_state is not None:
        opt_s = {"mu": distribute_tree(opt_state["mu"], o_shard), "nu": distribute_tree(opt_state["nu"], o_shard),
                 "step": opt_state["step"]}
    batch_s = None if batch is None else distribute_tree(batch, batch_shardings(batch, mesh))
    return params_s, opt_s, batch_s


def make_sharded_train_step(model: LM, optimizer: AdamW, mesh, shard_mode: str = "tp_fsdp"):
    """(params, opt_state, batch) → (params, opt_state, metrics) on DTensors
    placed by ``shard_state``: the single-device step's numbers on a mesh.

    Plain tensors the model makes (positions, masks) count as replicated.
    The gradients are redistributed to the moments' placements before the
    update (with ``tp_fsdp`` they are the parameters' own), and the new
    parameters to the parameters' (the reference's ``out_shardings``). The
    metrics are full tensors on every rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def train_step(params, opt_state, batch):
        with implicit_replication():
            loss, metrics, grads = loss_and_grads(model, params, batch)
            grads = {k: g.redistribute(g.device_mesh, opt_state["mu"][k].placements) for k, g in grads.items()}
            gn = global_norm(grads)
            new_params, new_opt = optimizer.update(grads, opt_state, params, grad_norm=gn)
            new_params = {k: p.redistribute(p.device_mesh, params[k].placements) for k, p in new_params.items()}

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        out = {"loss": full(loss), "grad_norm": full(gn), "lr": optimizer.schedule(new_opt["step"])}
        if "expert_load" in metrics:
            out["expert_load"] = full(metrics["expert_load"])
        return new_params, new_opt, out

    return train_step


def make_sharded_prefill_step(model: LM):
    """(params, batch) → logits, the forward alone (inference prefill)."""
    from torch.distributed.tensor.experimental import implicit_replication

    def prefill_step(params, batch):
        with torch.no_grad(), implicit_replication(), model.bound(params):
            return model.apply(batch)["logits"]

    return prefill_step


def make_sharded_serve_step(model: LM):
    """(params, cache, tokens (B, 1)) → (next tokens, cache) on DTensors. The
    last position's logits are gathered over the vocabulary before the
    argmax."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    def serve_step(params, cache, tokens):
        with torch.no_grad(), implicit_replication(), model.bound(params):
            logits, cache = model.decode_step(cache, tokens)
            last = logits[:, -1]
            last = last.redistribute(last.device_mesh, [Replicate()] * last.device_mesh.ndim)
            return last.argmax(dim=-1)[:, None].to(torch.int32), cache

    return serve_step


# ---------------------------------------------------------------------------
# The dry run's trace (the reference's ``lower_cell``).
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _strided_shard_sizes_outside_fake():
    """DTensor sizes a strided shard (a flattened (B, S, ·) sharded over two
    mesh dims) with a small real tensor and ``tolist()``, which fails under
    ``FakeTensorMode``; run that helper with the fake mode set aside."""
    import inspect

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    raw = inspect.getattr_static(cls, name, None) if cls is not None else None
    if raw is None:
        yield
        return
    fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw

    def outside(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)

    setattr(cls, name, type(raw)(outside) if isinstance(raw, (staticmethod, classmethod)) else outside)
    try:
        yield
    finally:
        setattr(cls, name, raw)


def _saved_bytes(counter: dict):
    """Count the local bytes autograd saves during the forward (each tensor
    once; a remat'd block keeps its own and is not seen)."""
    from torch.distributed.tensor import DTensor

    seen = set()

    def pack(t):
        local = t._local_tensor if isinstance(t, DTensor) else t
        if torch._C._current_graph_task_id() == -1 and id(local) not in seen:
            seen.add(id(local))
            counter["saved"] += local.numel() * local.element_size()
        return t

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree._local_tensor
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def trace_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *, remat: bool = True, sp: bool = True,
               donate: bool = True, unroll: bool = False, shard_mode: str = "tp_fsdp", ssd_impl: str = "chunked"):
    """Run the cell's step once on ``mesh`` under ``FakeTensorMode`` (CPU fake
    tensors: the plain versions of the kernels trace) and count one rank's
    work → (trace record, {"kind", "n_params"}).

    train → the sharded train step over parameters, AdamW moments and batch;
    prefill → the forward; decode → the serve step over the caches. The mesh
    lives on a process group (the dry run's is ``fake``). The record holds the
    local ``flops`` and ``bytes``, the collectives' ``wire`` bytes and
    ``collectives`` (``analysis.collectives``), and ``resident``: the local
    bytes of parameters, moments, batch and caches, and of what autograd
    saved for the backward (the activations the trace shows). ``donate`` and
    ``unroll`` are the reference's knobs and change nothing here: an eager
    step reuses no input buffer and runs every layer. The port has one SSD
    (``ssd_impl="chunked"``).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..analysis.collectives import LocalCounter
    from ..models.registry import cache_specs, input_specs
    from .sharding import cache_shardings, distribute_tree

    if ssd_impl != "chunked":
        raise ValueError(f"the port has one SSD implementation, 'chunked'; got {ssd_impl!r}")
    counter = LocalCounter()
    with FakeTensorMode(), _strided_shard_sizes_outside_fake():
        model = make_model_for_cell(cfg, mesh, remat=remat, sp=sp, device="cpu")
        params = dict(model.state_dict())
        n_params = sum(p.numel() for p in params.values())
        specs = input_specs(cfg, shape)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}
        saved = {"saved": 0}
        if shape.kind == "train":
            opt = make_optimizer()
            ps, os_, bs = shard_state(params, opt.init(params), batch, mesh, shard_mode)
            resident = _local_bytes(ps) + _local_bytes({"mu": os_["mu"], "nu": os_["nu"]}) + _local_bytes(bs)
            step = make_sharded_train_step(model, opt, mesh, shard_mode)
            with counter, _saved_bytes(saved):
                step(ps, os_, bs)
        elif shape.kind == "prefill":
            ps, _, bs = shard_state(params, None, batch, mesh, shard_mode)
            resident = _local_bytes(ps) + _local_bytes(bs)
            with counter:
                make_sharded_prefill_step(model)(ps, bs)
        else:
            ps, _, bs = shard_state(params, None, batch, mesh, shard_mode)
            cspec = cache_specs(cfg, shape)
            cache = distribute_tree(_materialize(cspec), cache_shardings(cspec, mesh))
            resident = _local_bytes(ps) + _local_bytes(bs) + _local_bytes(cache)
            with counter:
                make_sharded_serve_step(model)(ps, cache, bs["tokens"])
    record = counter.record()
    record["resident"] = {"state_and_inputs": resident, "saved_for_backward": saved["saved"]}
    return record, {"kind": shape.kind, "n_params": n_params}


def _materialize(tree):
    """``meta`` specs → zero tensors on the CPU (fake under ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    return tree
