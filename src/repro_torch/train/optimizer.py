"""Optimizer and learning-rate schedules, computed as ``repro.train.optimizer``.

AdamW with decoupled weight decay and global-norm clipping; schedules WSD
(warmup–stable–decay, the MiniCPM schedule) and cosine. Parameters are a
dict of tensors (the port's state names); the moments are float32 whatever
the parameters' type, the clipped gradients are float32, and each update is
formed in float32 and cast to its parameter's type, as in the reference
(``torch.optim.AdamW`` keeps its moments in the parameters' type and clips
elsewhere, so it computes something else).

The step counter is a 0-d int32 tensor on the host: the step's constants
(learning rate, bias corrections) are formed there in float32 and enter the
device's update as scalars, with no read from the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

Params = dict[str, torch.Tensor]

# Leaves are updated in groups of about this many elements, so the float32
# temporaries of one update stay a fraction of the moments' size.
_GROUP_NUMEL = 1 << 27


def warmup_stable_decay(peak_lr: float, total_steps: int, warmup: float = 0.01, decay: float = 0.1,
                        floor: float = 0.1) -> Callable:
    """WSD: linear warmup → constant → linear decay to floor·peak."""
    w = max(int(total_steps * warmup), 1)
    d = max(int(total_steps * decay), 1)

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / w, max=1.0)
        decay_start = total_steps - d
        frac = torch.clamp((step - decay_start) / d, 0.0, 1.0)
        return torch.where(step < decay_start, warm, peak_lr * (1.0 - (1.0 - floor) * frac))

    return lr


def cosine_schedule(peak_lr: float, total_steps: int, warmup: float = 0.01, floor: float = 0.1) -> Callable:
    w = max(int(total_steps * warmup), 1)

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / w, max=1.0)
        t = torch.clamp((step - w) / max(total_steps - w, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < w, warm, peak_lr * cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    """√(Σ ‖g‖²) over the leaves (a dict or a list of tensors), in float32."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def _groups(names: list[str], params: Params):
    group, size = [], 0
    for name in names:
        group.append(name)
        size += params[name].numel()
        if size >= _GROUP_NUMEL:
            yield group
            group, size = [], 0
    if group:
        yield group


@dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params: Params) -> dict:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}

        # A literal, so under FakeTensorMode (the dry run) it stays a known constant.
        return {"mu": zeros(), "nu": zeros(), "step": torch.tensor(0, dtype=torch.int32)}

    def update(self, grads: Params, state: dict, params: Params,
               grad_norm: torch.Tensor | None = None) -> tuple[Params, dict]:
        """→ (new params, new state); the inputs are left as they are.
        ``grad_norm``, when given, is ``global_norm(grads)`` already formed."""
        step = state["step"] + 1
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        b1, b2 = self.b1, self.b2
        lr = float(self.schedule(step))
        c1 = float(1 - b1 ** step.to(torch.float32))
        c2 = float(1 - b2 ** step.to(torch.float32))
        new_params, mu, nu = {}, {}, {}
        for names in _groups(list(params), params):
            g = [grads[k].float() for k in names]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            m = torch._foreach_mul([state["mu"][k] for k in names], b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            v = torch._foreach_mul([state["nu"][k] for k in names], b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            del g
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(torch._foreach_div(m, c1), denom)
            del denom
            p32 = [params[k].float() for k in names]
            torch._foreach_add_(u, torch._foreach_mul(p32, self.weight_decay))
            torch._foreach_mul_(u, lr)
            new = torch._foreach_sub(p32, u)
            for k, p, m_k, v_k in zip(names, new, m, v):
                new_params[k] = p.to(params[k].dtype)
                mu[k], nu[k] = m_k, v_k
        return new_params, {"mu": mu, "nu": nu, "step": step}
