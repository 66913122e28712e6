"""Fault-tolerant training loop with the OCS controller tick (``repro.train.loop``).

  * checkpoint/restart: restores (params, opt state, step); the data
    pipeline is stateless-resumable, so a crash + restore replays the exact
    remaining schedule (bit-identical on the CPU in float32; the GPU's
    embedding backward sums with atomics, so there only to rounding).
  * failure injection: any callable raising ``SimulatedFailure`` at chosen
    steps; the loop drops its in-flight state, re-initialises from the seed,
    restores the last committed checkpoint and continues, counting restarts
    (a restart budget guards infinite crash loops).
  * straggler watchdog: per-step wall-time EMA + z-score detection; slow
    steps fire a remap hook. A step is timed up to ``loss.item()``, the
    point where the reference blocks on its loss, so the watchdog times the
    device's work and not the launch.
  * OCS integration: every ``ocs_every`` steps the loop builds the
    rack-level demand matrix of its parallelism plan (or of measured MoE
    expert loads) and schedules it with SPECTRA on the configured fabric,
    logging the CCT the optical core would need (the controller loop of
    Fig. 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..data.pipeline import TokenStream
from ..fabric.ocs import OCSFabric
from ..kernels.backend import resolve_device
from ..traffic.collectives import Placement, TrafficModel
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import AdamW


class SimulatedFailure(RuntimeError):
    """Raised by failure injectors to simulate a node crash."""


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    max_restarts: int = 8
    straggler_zscore: float = 4.0
    straggler_warmup: int = 5  # ignore compile-dominated early steps
    ocs_every: int = 0  # 0 → disabled
    ocs_num_racks: int = 8


@dataclass
class LoopState:
    params: Any
    opt_state: Any
    step: int = 0
    restarts: int = 0
    stragglers: int = 0
    history: list = field(default_factory=list)
    cct_log: list = field(default_factory=list)


def _demand_from_stats(num_racks: int, metrics: dict, step: int) -> np.ndarray | None:
    """Rack demand from measured expert loads (MoE) or DP-ring defaults."""
    tm = TrafficModel(Placement(num_racks, 1))
    load = metrics.get("expert_load")
    if load is not None:
        load = np.asarray(torch.as_tensor(load).cpu(), dtype=np.float64)  # one host read a tick
        if load.sum() <= 0:
            return None
        # Experts → racks round-robin; tokens to expert e land on its rack.
        per_rack = np.zeros(num_racks)
        for e, cnt in enumerate(load):
            per_rack[e % num_racks] += float(cnt)
        # All-to-all: every source rack sends proportionally to expert racks.
        D = np.outer(np.full(num_racks, 1.0 / num_racks), per_rack)
        np.fill_diagonal(D, 0.0)
        return D
    # Dense model: DP gradient ring across racks.
    tm.ring_allreduce(list(range(num_racks)), 1.0)
    return tm.demand_bytes


class Trainer:
    """The loop over ``train_step`` (``parallel.steps.make_train_step``).

    ``device=None`` means CUDA and raises without a GPU; the CPU runs only
    when named, and the model must lie on the same device. The model adopts
    the state's parameters (``LM.adopt``) whenever they change, so it holds
    no second copy of the weights and ends holding the trained ones.
    """

    def __init__(
        self,
        model,
        optimizer: AdamW,
        stream: TokenStream,
        train_step: Callable,
        cfg: LoopConfig,
        *,
        fabric: OCSFabric | None = None,
        failure_injector: Callable[[int], None] | None = None,
        remap_hook: Callable[[int, float], None] | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device.type != self.device.type or stream.device.type != self.device.type:
            raise ValueError(f"model on {model.device} and stream on {stream.device}, trainer on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.stream = stream
        self.train_step = train_step
        self.cfg = cfg
        self.fabric = fabric
        self.failure_injector = failure_injector
        self.remap_hook = remap_hook

    # -------------------------------------------------------------- state
    def init_state(self, seed: int) -> LoopState:
        params = self.model.init(seed)
        self.model.adopt(params)
        opt_state = self.optimizer.init(params)
        return LoopState(params=params, opt_state=opt_state)

    def _try_restore(self, state: LoopState) -> LoopState:
        if not self.cfg.ckpt_dir or latest_step(self.cfg.ckpt_dir) is None:
            return state
        tree = {"params": state.params, "opt": state.opt_state}
        restored, extra = restore_checkpoint(self.cfg.ckpt_dir, tree)
        state.params = restored["params"]
        state.opt_state = restored["opt"]
        self.model.adopt(state.params)
        state.step = int(extra["step"])
        return state

    def _save(self, state: LoopState, async_: bool = False):
        if not self.cfg.ckpt_dir:
            return
        save_checkpoint(
            self.cfg.ckpt_dir,
            state.step,
            {"params": state.params, "opt": state.opt_state},
            extra={"step": state.step, "data": self.stream.state(state.step)},
            keep=self.cfg.ckpt_keep,
            async_=async_,
        )

    # ---------------------------------------------------------------- run
    def run(self, seed: int) -> LoopState:
        state = self._try_restore(self.init_state(seed))
        ema_t, ema_v = None, 0.0
        while state.step < self.cfg.total_steps:
            step = state.step
            batch = self.stream.next_batch(step)
            t0 = time.perf_counter()
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                params, opt_state, metrics = self.train_step(state.params, state.opt_state, batch)
                loss = metrics["loss"].item()  # waits for the step's device work
            except SimulatedFailure:
                state.restarts += 1
                if state.restarts > self.cfg.max_restarts:
                    raise
                # Crash: lose in-flight state, restore last committed ckpt.
                state.params = state.opt_state = params = opt_state = metrics = None
                fresh = self.init_state(seed)
                state_r = self._try_restore(fresh)
                state_r.restarts = state.restarts
                state_r.stragglers = state.stragglers
                state_r.history = state.history
                state_r.cct_log = state.cct_log
                state = state_r
                continue
            dt = time.perf_counter() - t0
            # Straggler watchdog (EMA + variance z-score), after a warmup
            # window so first-step outliers don't inflate the baseline.
            if step < self.cfg.straggler_warmup:
                pass
            elif ema_t is None:
                ema_t, ema_v = dt, 0.0
            else:
                # Variance floor of 0.25·ema: a straggler must be ≥ ~2× the
                # typical step before variance statistics are established.
                z = (dt - ema_t) / max(np.sqrt(ema_v), 0.25 * ema_t, 1e-9)
                if z > self.cfg.straggler_zscore:
                    state.stragglers += 1
                    if self.remap_hook:
                        self.remap_hook(step, dt)
                ema_v = 0.9 * ema_v + 0.1 * (dt - ema_t) ** 2
                ema_t = 0.9 * ema_t + 0.1 * dt
            state.params, state.opt_state = params, opt_state
            self.model.adopt(params)
            state.step = step + 1
            if step % self.cfg.log_every == 0 or state.step == self.cfg.total_steps:
                state.history.append({"step": step, "loss": loss, "time_s": dt})
            # OCS controller tick: schedule this period's demand matrix.
            if self.fabric is not None and self.cfg.ocs_every and state.step % self.cfg.ocs_every == 0:
                D = _demand_from_stats(self.cfg.ocs_num_racks, metrics, step)
                if D is not None and D.max() > 0:
                    res, cct = self.fabric.schedule_bytes(D * 1e9)
                    state.cct_log.append({
                        "step": step,
                        "cct_s": cct,
                        "makespan": res.makespan,
                        "lb": res.lower_bound,
                        "configs": res.schedule.num_configs(),
                    })
            if self.cfg.ckpt_dir and state.step % self.cfg.ckpt_every == 0:
                self._save(state)
        if self.cfg.ckpt_dir:
            self._save(state)
        return state
