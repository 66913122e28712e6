"""Train and serve step builders, single device (``repro.parallel.steps``).

The sharded cell lowering (``lower_cell``) and the sharding rules wait for
the port's ``parallel/`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

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
