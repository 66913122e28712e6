"""The port's sharded steps on a CPU mesh: one spawn of 8 gloo processes.

The counterpart of ``tests/test_distributed.py``, whose three tests the
reference itself fails; the port is held to its own single-device step
(itself held to ``jax.value_and_grad`` in ``tests/test_torch_train.py``):
  * granite-3-8b ``reduced()`` on a 4 × 2 (data × model) mesh: one sharded
    train step equals the single-device step;
  * the token embedding of that step is vocab-parallel (granite ties its
    head to the table): a rank gathers its half of the vocabulary only;
  * deepseek-moe-16b ``reduced()`` on 2 × 4 (expert parallel over the model
    axis): the step's traced collectives include all-to-all, all-gather or
    all-reduce; the step equals the single-device one; each rank runs E / 4
    experts, a quarter of the expert ``bmm`` FLOPs of the gathered block;
  * a sharded decode over a cache sharded over its sequence (granite's one
    KV head is not divided by the model axis) equals the unsharded decode
    and never gathers the cache;
  * the elastic restore: the 4 × 2 state saved, restored onto
    ``largest_mesh(6, prefer_model=2)`` = (3, 2) and trained one more step.
"""

import json
import math
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 8
# Measured on the CPU (torch 2.13): the loss agrees to 1.6e-7 relative and
# every gradient tensor to 2.7e-6 of its largest entry; the sums run
# in another order on the shards. After one AdamW step at lr 1e-2 the
# parameters agree to 1.7e-3: the first step moves an entry by about
# lr·sign(g), so an entry whose gradient is ~0 may move either way. They are
# held to the reference test's 5e-3.
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_ATOL = 5e-3


def _worker(rank: int, port: int, out_dir: str) -> None:
    sys.path.insert(0, str(SRC))
    import logging

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    torch.set_num_threads(1)
    for name in ("torch.distributed.tensor._redistribute", "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
    from repro_torch.analysis.collectives import LocalCounter
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    from repro_torch.models.registry import build_model, concrete_inputs
    from repro_torch.parallel.steps import (loss_and_grads, make_model_for_cell, make_optimizer,
                                            make_sharded_train_step, make_train_step, shard_state,
                                            state_shardings)
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.fault_tolerance import largest_mesh

    out = {}
    shape = ShapeCfg("t", 32, 8, "train")

    # 1. The sharded step on 4 × 2 against the single-device step.
    cfg = get_arch("granite-3-8b").reduced()
    batch = concrete_inputs(cfg, shape, device="cpu")
    model = build_model(cfg, device="cpu")
    opt = make_optimizer(total_steps=10, peak_lr=1e-2)  # a step of lr 1e-3: updates that show
    params = model.init(0)
    opt_state = opt.init(params)
    p1, _, m1 = make_train_step(model, opt)(params, opt_state, batch)
    mesh8 = make_debug_mesh(WORLD, model=2)
    smodel = make_model_for_cell(cfg, mesh8, device="cpu")
    ps, os_, bs = shard_state(params, opt_state, batch, mesh8)
    step8 = make_sharded_train_step(smodel, opt, mesh8)
    p2, o2, m2 = step8(ps, os_, bs)
    full = {k: v.full_tensor() for k, v in p2.items()}
    _, _, g1 = loss_and_grads(model, params, batch)
    with implicit_replication():
        _, _, g2 = loss_and_grads(smodel, ps, bs)
    out["grad_diff"] = max(float((g2[k].full_tensor() - g1[k]).abs().max() / g1[k].abs().max().clamp(min=1e-30))
                           for k in g1)
    out["loss"] = [float(m1["loss"]), float(m2["loss"])]
    out["param_diff"] = max(float((full[k] - p1[k]).abs().max()) for k in p1)
    out["update"] = max(float((p1[k] - params[k]).abs().max()) for k in p1)
    out["placements_kept"] = all(p2[k].placements == ps[k].placements for k in ps)
    out["wq_placements"] = [[type(p).__name__, p.dim] for p in ps["periods.0.0.wq"].placements]
    counter = LocalCounter()
    no_sp = make_model_for_cell(cfg, mesh8, sp=False, device="cpu")  # the lookup's own collectives only
    with implicit_replication(), no_sp.bound(ps), counter:
        no_sp._embed(bs["tokens"])
    out["embed_gathers"] = [dict(counter.collectives.ops).get("all-gather", 0),
                            counter.collectives.operand_bytes.get("all-gather", 0)]
    out["embed_shape"] = [cfg.vocab_size, cfg.d_model, cfg.tie_embeddings]

    # 1b. Decode over a sequence-sharded cache (one KV head, model axis 2).
    import repro_torch.models.blocks as blocks
    from repro_torch.parallel.sharding import cache_shardings, distribute_tree

    slot_calls = [0]
    slots = blocks._decode_attention_slots

    def counted_slots(*a):
        slot_calls[0] += 1
        return slots(*a)

    blocks._decode_attention_slots = counted_slots
    dtok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 6)))
    c1 = model.init_cache(4, 16)
    c2 = distribute_tree(model.init_cache(4, 16), cache_shardings(model.init_cache(4, 16), mesh8))
    diffs = []
    with torch.no_grad(), implicit_replication():
        for t in range(dtok.shape[1]):
            with model.bound(params):
                l1, c1 = model.decode_step(c1, dtok[:, t:t + 1])
            with smodel.bound(ps):
                l2, c2 = smodel.decode_step(c2, dtok[:, t:t + 1])
            diffs.append(float((l2.full_tensor() - l1).abs().max() / l1.abs().max()))
    blocks._decode_attention_slots = slots
    k2 = c2["periods"][0][0]["k"]
    out["decode"] = {"diff": max(diffs), "slot_calls": slot_calls[0], "layers": cfg.num_layers,
                     "steps": dtok.shape[1], "k_local": list(k2.to_local().shape),
                     "k_placements": [[type(p).__name__, getattr(p, "dim", None)] for p in k2.placements],
                     "cache_diff": float((k2.full_tensor() - c1["periods"][0][0]["k"]).abs().max()
                                         / c1["periods"][0][0]["k"].abs().max())}

    # 2. deepseek-moe on 2 × 4: expert parallel over the model axis.
    mcfg = get_arch("deepseek-moe-16b").reduced()
    mbatch = concrete_inputs(mcfg, shape, device="cpu")
    mmodel = build_model(mcfg, device="cpu")
    mparams = mmodel.init(0)
    mesh_ep = make_debug_mesh(WORLD, model=4)
    mps, mos, mbs = shard_state(mparams, opt.init(mparams), mbatch, mesh_ep)
    counter = LocalCounter()
    with counter:
        _, _, mm = make_sharded_train_step(make_model_for_cell(mcfg, mesh_ep, device="cpu"), opt, mesh_ep)(
            mps, mos, mbs)
    _, _, mm1 = make_train_step(mmodel, opt)(mparams, opt.init(mparams), mbatch)
    out["moe_collectives"] = dict(counter.collectives.ops)
    out["moe_loss"] = [float(mm1["loss"]), float(mm["loss"])]
    out["moe_load"] = [mm1["expert_load"].tolist(), mm["expert_load"].tolist()]
    msmodel = make_model_for_cell(mcfg, mesh_ep, device="cpu")
    seen = []
    ffn = blocks.moe_ffn

    def recorded_ffn(p, x, m, first=0):
        seen.append(p.we_gate.shape[0])
        return ffn(p, x, m, first)

    blocks.moe_ffn = recorded_ffn
    _, _, mg1 = loss_and_grads(mmodel, mparams, mbatch)
    del seen[:]
    with implicit_replication():
        _, _, mg2 = loss_and_grads(msmodel, mps, mbs)
    we = "periods.0.0.moe.we_gate"
    out["moe_grad_diff"] = max(float((mg2[k].full_tensor() - mg1[k]).abs().max() / mg1[k].abs().max().clamp(min=1e-30))
                               for k in mg1)
    out["moe_experts_run"] = sorted(set(seen))  # the sharded step's calls
    out["moe_expert_grad"] = [list(mg2[we].to_local().shape),
                              [[type(p).__name__, getattr(p, "dim", None)] for p in mg2[we].placements]]
    blocks.moe_ffn = ffn
    # The block alone: the expert products of one rank against the whole block's.
    xb = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 32, mcfg.d_model), dtype=np.float32))
    whole, mine = LocalCounter(), LocalCounter()
    with mmodel.bound(mparams), whole:
        y1, _ = mmodel.periods[0][0]["moe"](xb)
    from torch.distributed.tensor import Shard, distribute_tensor

    with implicit_replication(), msmodel.bound(mps), mine:
        y2, _ = msmodel.periods[0][0]["moe"](distribute_tensor(xb, mesh_ep, [Shard(0), Shard(1)]))
    out["moe_block"] = {"bmm": [whole.flops_by_op["bmm"], mine.flops_by_op["bmm"]],
                        "diff": float((y2.full_tensor() - y1).abs().max() / y1.abs().max())}

    # 3. Elastic restore: save on 4 × 2, two ranks die, resume on (3, 2).
    ckpt = os.path.join(out_dir, "ckpt")
    save_checkpoint(ckpt, 1, {"params": p2, "opt": o2}, extra={"step": 1})
    grid = largest_mesh(6, prefer_model=2)
    out["grid"] = list(grid)
    mesh6 = make_mesh(grid, ("data", "model"))  # every rank builds it; ranks 6 and 7 sit out
    if rank < 6:
        p_sh, o_sh = state_shardings(params, mesh6)
        shard6 = {"params": p_sh, "opt": {"mu": o_sh, "nu": o_sh, "step": None}}
        restored, extra = restore_checkpoint(ckpt, {"params": p2, "opt": o2}, shardings=shard6)
        out["extra_step"] = extra["step"]
        out["restored_equal"] = all(bool(torch.equal(restored["params"][k].full_tensor(), full[k])) for k in full)
        out["restored_mesh"] = list(restored["params"]["embed"].device_mesh.shape)
        _, _, b6 = shard_state(params, None, {"tokens": batch["tokens"][:6]}, mesh6)
        step6 = make_sharded_train_step(make_model_for_cell(cfg, mesh6, device="cpu"), opt, mesh6)
        _, o3, m3 = step6(restored["params"], restored["opt"], b6)
        out["loss6"] = float(m3["loss"])
        out["step6"] = int(o3["step"])
    if rank == 0:
        Path(out_dir, "result.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    import torch.multiprocessing as mp

    out_dir = str(tmp_path_factory.mktemp("dist"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out_dir), nprocs=WORLD)
    return json.loads(Path(out_dir, "result.json").read_text())


def test_sharded_train_step_matches_single_device(result):
    single, sharded = result["loss"]
    assert abs(single - sharded) <= LOSS_RTOL * abs(single), result["loss"]
    assert result["update"] > 1e-4  # the step moved the parameters
    assert result["grad_diff"] <= GRAD_RTOL, result["grad_diff"]
    assert result["param_diff"] <= PARAM_ATOL, result["param_diff"]
    assert result["placements_kept"]
    assert result["wq_placements"] == [["Shard", 0], ["Shard", 1]]  # FSDP over data, TP over model


def test_moe_expert_parallel_collectives(result):
    ops = result["moe_collectives"]
    assert ops.get("all-to-all", 0) + ops.get("all-gather", 0) + ops.get("all-reduce", 0) > 0, ops
    single, sharded = result["moe_loss"]
    assert abs(single - sharded) <= LOSS_RTOL * abs(single), result["moe_loss"]
    assert result["moe_load"][0] == result["moe_load"][1]


def test_moe_step_runs_a_quarter_of_the_experts_on_each_rank(result):
    """Expert parallelism over the model axis of 2 × 4: each rank's block
    runs E / 4 = 2 of deepseek-moe's 8 reduced experts, its gradients equal
    the single-device step's, the expert weights' gradients stay sharded
    over the model axis, and the block's expert ``bmm`` FLOPs on a rank are
    a quarter of the gathered block's (the whole block's over the 2 data
    ranks)."""
    assert result["moe_experts_run"] == [2], result["moe_experts_run"]
    assert result["moe_grad_diff"] <= GRAD_RTOL, result["moe_grad_diff"]
    shape, placements = result["moe_expert_grad"]
    assert shape[0] == 2 and ["Shard", 0] == placements[1], result["moe_expert_grad"]
    whole, mine = result["moe_block"]["bmm"]
    assert whole > 0 and mine * 4 == whole // 2, result["moe_block"]
    assert result["moe_block"]["diff"] <= GRAD_RTOL, result["moe_block"]


def test_embedding_is_vocab_parallel(result):
    """The tied table of the 4 × 2 step: the lookup gathers a rank's half of
    the vocabulary over the data axis, once, and no more (the gathered
    lookup took the whole table over both axes)."""
    V, D, tied = result["embed_shape"]
    assert tied
    assert result["embed_gathers"] == [1, V // 2 * D * 4], result["embed_gathers"]


def test_decode_over_a_sequence_sharded_cache_equals_unsharded(result):
    """Flash-decode: every attention layer of every step ran on the ranks'
    slots of the cache, which stays sharded over its sequence, and the
    logits and the written cache equal the unsharded decode's to 1e-5 of
    their largest (the products sum in another order on the shards)."""
    d = result["decode"]
    assert d["slot_calls"] == d["layers"] * d["steps"], d
    assert d["k_placements"][1] == ["Shard", 2] and d["k_local"][2] == 8, d
    assert d["cache_diff"] <= GRAD_RTOL and d["diff"] <= GRAD_RTOL, d


def test_elastic_restore_to_smaller_mesh(result):
    assert result["grid"] == [3, 2]
    assert result["extra_step"] == 1
    assert result["restored_equal"]
    assert result["restored_mesh"] == [3, 2]
    assert result["step6"] == 2
    assert math.isfinite(result["loss6"])
