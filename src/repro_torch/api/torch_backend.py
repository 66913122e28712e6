"""PyTorch backend for the solver API: the whole pipeline on one device.

Counterpart of ``repro.api.jax_backend``. DECOMPOSE, LPT, EQUALIZE and the
§IV bound run for a whole stack of demand matrices in one
``spectra_torch_e2e_many`` call; reports come back with device-computed
makespans and lazy host schedules, built only when something touches them.

``SolveOptions.extra`` knobs: ``device`` (``None`` → CUDA, which raises
without a GPU; ``"cpu"`` runs the plain PyTorch path), ``equalize``
(default True), ``merge_aware``, ``extra_slots`` (EQUALIZE split headroom,
default 64), ``matcher`` (unset → ``matching.default_matcher`` per shape
bucket) and ``repair_rounds`` (default 0).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.decompose import Decomposition
from ..core.equalize import equalize
from ..core.schedule_ir import DeviceSchedule, LazySchedule, ir_to_schedule
from ..core.torchopt.e2e import E2EResult, spectra_torch_e2e_many
from ..core.torchopt.matching import default_matcher
from ..kernels.backend import resolve_device
from ..obs.trace import get_tracer
from .problem import Problem, SolveOptions, SolveReport, finish_report


def _e2e_kwargs(options: SolveOptions, n: int) -> dict:
    return dict(
        device=resolve_device(options.extra.get("device")),
        do_equalize=bool(options.extra.get("equalize", True)),
        merge_aware=bool(options.extra.get("merge_aware", False)),
        extra_slots=int(options.extra.get("extra_slots", 64)),
        # Every instance of a dispatch shares n: the bucket is the unit the
        # matcher is chosen for.
        matcher=str(options.extra.get("matcher") or default_matcher(n)),
        repair_rounds=int(options.extra.get("repair_rounds", 0)),
    )


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    out = t.detach().cpu().numpy()
    return out if dtype is None else out.astype(dtype)


class _LazyDecomposition(Decomposition):
    """A ``Decomposition`` whose Python lists are built on first access."""

    def __init__(self, perms_arr: np.ndarray, alphas_arr: np.ndarray):
        self._perms_arr = perms_arr
        self._alphas_arr = alphas_arr
        self._inner: Decomposition | None = None

    def _force(self) -> Decomposition:
        if self._inner is None:
            self._inner = Decomposition(
                perms=[p.astype(np.int64) for p in self._perms_arr],
                alphas=[float(a) for a in self._alphas_arr],
            )
        return self._inner

    @property
    def perms(self):  # type: ignore[override]
        return self._force().perms

    @property
    def alphas(self):  # type: ignore[override]
        return self._force().alphas


class _HostBatch:
    """One device→host copy of a whole fused batch, shared by B reports."""

    def __init__(
        self,
        res: E2EResult,
        deltas: np.ndarray,
        *,
        device: torch.device,
        merge_aware: bool = False,
        matcher: str = "auction",
        repair_rounds: int = 0,
        **_ignored,
    ):
        sched = res.schedule
        self.device = str(device)
        self.merge_aware = merge_aware
        self.matcher = matcher
        self.repair_rounds = repair_rounds
        self.perms = _host(sched.perms)
        self.alphas = _host(sched.alphas, np.float64)
        self.switch = _host(sched.switch)
        self.makespans = _host(res.makespan, np.float64)
        self.lpt_makespans = _host(res.lpt_makespan, np.float64)
        self.dec_perms = _host(res.dec.perms)
        self.dec_alphas = _host(res.dec.alphas, np.float64)
        self.k = _host(res.dec.k)
        self.converged = _host(res.dec.converged)
        self.rounds = _host(res.dec.rounds)
        self.eq_exhausted = _host(res.eq_exhausted)
        self.lbs = _host(res.lb, np.float64)
        B = self.makespans.shape[0]
        self.deltas = np.broadcast_to(np.asarray(deltas, dtype=np.float64), (B,))

    def decomposition(self, b: int) -> Decomposition:
        """Host Decomposition of instance b (pre-EQUALIZE weights), built
        lazily from per-instance copies so it does not pin the batch."""
        k = int(self.k[b])
        return _LazyDecomposition(
            self.dec_perms[b][:k].copy(), self.dec_alphas[b][:k].copy()
        )

    def schedule_thunk(self, b: int, s: int):
        perms = self.perms[b].copy()
        alphas = self.alphas[b].copy()
        switch = self.switch[b].copy()
        delta = float(self.deltas[b])
        exhausted = bool(self.eq_exhausted[b])
        merge_aware = self.merge_aware

        def build():
            sched = ir_to_schedule(DeviceSchedule(perms, alphas, switch, delta), s)
            if exhausted:
                # Device EQUALIZE ran out of split headroom; host EQUALIZE
                # picks up where it stopped.
                sched = equalize(sched, merge_aware=merge_aware)
            return sched

        return build

    def report(
        self,
        b: int,
        problem: Problem,
        options: SolveOptions,
        runtime_s: float,
        *,
        extras: dict | None = None,
        device_lb: bool = True,
    ) -> SolveReport:
        lazy = LazySchedule(self.schedule_thunk(b, problem.s), float(self.deltas[b]))
        device_makespan = float(self.makespans[b])
        exhausted = bool(self.eq_exhausted[b])
        converged = bool(self.converged[b])
        warnings: list[str] = []
        if not converged:
            warnings.append(
                f"device matcher {self.matcher!r} exhausted its iteration "
                "budget (TorchDecomposition.converged=False); the matching — "
                "and the decomposition built on it — may be suboptimal"
            )
        if exhausted:
            warnings.append(
                "device EQUALIZE ran out of split headroom (raise "
                "options.extra['extra_slots']); host EQUALIZE finished the "
                "schedule at materialization"
            )
        all_extras = {
            "k": int(self.k[b]),
            "converged": converged,
            "matcher": self.matcher,
            "device": self.device,
            "repair_rounds": self.repair_rounds,
            "bidding_rounds": int(self.rounds[b]),
            "device_makespan": device_makespan,
            "device_lpt_makespan": float(self.lpt_makespans[b]),
            "eq_exhausted": exhausted,
            "warnings": warnings,
        }
        all_extras.update(extras or {})
        return finish_report(
            solver="spectra_torch",
            backend="torch",
            schedule=lazy,
            problem=problem,
            options=options,
            runtime_s=runtime_s,
            decomposition=self.decomposition(b),
            # An exhausted instance is finished on the host, so its metrics
            # come from the materialized schedule.
            makespan=None if exhausted else device_makespan,
            num_configs=None if exhausted else int((self.switch[b] >= 0).sum()),
            # Batched: the float32 device bound. A single solve keeps the
            # exact float64 host bound (device_lb=False).
            lower_bound=float(self.lbs[b]) if device_lb else None,
            extras=all_extras,
        )


def solve_spectra_torch(problem: Problem, options: SolveOptions) -> SolveReport:
    """Registry entry: one instance, the whole pipeline on the device."""
    kwargs = _e2e_kwargs(options, problem.n)
    t0 = time.perf_counter()
    res = spectra_torch_e2e_many(
        np.asarray(problem.D, dtype=np.float32)[None], problem.s,
        np.float32(problem.delta), **kwargs,
    )
    batch = _HostBatch(res, np.array([problem.delta]), **kwargs)
    runtime_s = time.perf_counter() - t0
    return batch.report(0, problem, options, runtime_s, device_lb=False)


class PendingBatch:
    """A dispatched batch whose reports have not been built yet.

    The round loops read one flag from the device per round, so most of a
    dispatch runs before ``dispatch_many_torch`` returns; the tail (LPT,
    EQUALIZE's last iteration, the bounds) may still be in flight. ``ready``
    probes a CUDA event recorded after the dispatch, without blocking;
    ``collect()`` is the one place that waits for it, by copying the
    results to the host.
    """

    def __init__(self, res, mats, s, deltas, options, kwargs, t0, event):
        self._res = res
        self._mats = mats
        self._s = s
        self._deltas = deltas
        self._options = options
        self._kwargs = kwargs
        self._t0 = t0
        self._event = event
        self._reports: list[SolveReport] | None = None

    def __len__(self) -> int:
        return int(self._mats.shape[0])

    @property
    def ready(self) -> bool:
        """Non-blocking readiness probe of the device computation."""
        return True if self._event is None else bool(self._event.query())

    def collect(self) -> list[SolveReport]:
        """Wait for the device results and build the reports, inside a
        ``torch.collect`` span. Idempotent: repeated calls return the same
        list."""
        if self._reports is None:
            tracer = get_tracer()
            with tracer.span("torch.collect", {"B": len(self)} if tracer.enabled else None,
                             device=self._kwargs["device"]):
                batch = _HostBatch(self._res, self._deltas, **self._kwargs)
                device_s = time.perf_counter() - self._t0
                B = len(self)
                self._reports = [
                    batch.report(
                        b,
                        Problem(self._mats[b], self._s, float(self._deltas[b])),
                        self._options,
                        device_s / B,
                        extras={"batched": True, "batch_size": B, "fused": True},
                    )
                    for b in range(B)
                ]
        return self._reports


def dispatch_many_torch(Ds, s: int, delta, options: SolveOptions) -> PendingBatch:
    """Run one fused batched solve and return before copying results back.

    Only the device input is float32; reports validate against the caller's
    float64 matrices. ``delta`` is a scalar or a (B,) vector. The call runs
    inside a ``torch.dispatch`` span, which on CUDA counts its host reads;
    with the tracer's ``device_sync`` it synchronises the device inside that
    span, so the device time lands there.
    """
    mats = np.asarray(Ds, dtype=np.float64)
    B = mats.shape[0]
    deltas = np.broadcast_to(np.asarray(delta, dtype=np.float64), (B,))
    kwargs = _e2e_kwargs(options, int(mats.shape[-1]))
    tracer = get_tracer()
    t0 = time.perf_counter()
    with tracer.span(
        "torch.dispatch", {"B": B, "n": int(mats.shape[-1]), "s": int(s)} if tracer.enabled else None,
        device=kwargs["device"],
    ):
        res = spectra_torch_e2e_many(
            mats.astype(np.float32), s, deltas.astype(np.float32), **kwargs
        )
        on_cuda = kwargs["device"].type == "cuda"
        if on_cuda and tracer.enabled and tracer.device_sync:
            torch.cuda.synchronize(kwargs["device"])
    event = None
    if on_cuda:
        event = torch.cuda.Event()
        event.record()
    return PendingBatch(res, mats, s, deltas, options, kwargs, t0, event)


def solve_many_torch(Ds, s: int, delta, options: SolveOptions) -> list[SolveReport]:
    """Batched path for ``solve_many``: dispatch, then collect."""
    return dispatch_many_torch(Ds, s, delta, options).collect()
