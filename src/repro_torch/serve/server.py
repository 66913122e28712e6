"""Always-on schedule server: double-buffered dispatch + install (the port's
counterpart of ``repro.serve.server``).

The serving loop a fabric controller runs is a pipeline with two stations:
*solve* period t+1 (device) and *install* period t (program the OCSes and
wait for the switch ACK, ``install_latency_s``, modeled as a sleep since it
is pure I/O from the host's side). A synchronous controller pays solve +
install every cycle; this server overlaps them:

    dispatch(batch t+1)      # hand the fused device solve to the worker
    install(batch t)         # wait for t's reports, program switches; the
                             # install wait runs beside t+1's solve
    inflight = batch t+1

so the steady-state cycle costs max(solve, install) instead of their sum.

The reference gets the overlap from JAX's asynchronous dispatch. The port's
``dispatch_many_torch`` does not return early: its round loops read a flag
from the device every round, so most of the solve runs before the call
returns. So in ``mode="async"`` the server owns **one worker thread** (a
single-worker ``ThreadPoolExecutor``, created at the first device batch and
stopped by ``drain()`` / ``close()``). The worker runs
``dispatch_many_torch(...)`` and ``PendingBatch.collect()`` on the options'
device and on the stream that was current on the caller's thread at
dispatch, so the launches, the recorded event and the copy back share one
stream; ``_install`` waits on its future. The install sleep releases the
GIL, so the worker's launches and host reads proceed underneath it. At most
one batch is in flight beside the one being installed (the reference's
double buffer, not a pool), and an exception in the worker re-raises from
``_install`` (so from ``step`` and ``drain``). ``mode="sync"`` dispatches
and collects on the caller's thread back to back (identical results,
serial timing).

Only ``spectra_torch`` has the dispatch/collect split: any other solver
runs in ``mode="sync"``, as in the reference. ``spectra_torch`` resolves
its device when the server is built (``options.extra["device"]``, None
meaning CUDA): without a GPU that raises, it never falls back to ``sync``.

Cache lookup and insert, admission and the per-request records stay on the
caller's thread; only the device call moves to the worker. Tracing: the
``serve.dispatch`` span covers the handoff only, and the worker's
``torch.dispatch`` / ``torch.collect`` spans land on the worker's thread id
(the tracer keeps a span stack per thread). ``device`` time in the metrics
runs from just before the device call is handed off (or made, in ``sync``)
to the reports' arrival on the caller's thread.

Before dispatching, each admitted request consults the host
``ScheduleCache``: phase-cycling traffic is served from the cache without
occupying the device. DEGRADED requests (over-rate tenants, see
``admission``) are grouped into their own dispatches and solved without
EQUALIZE; their schedules are *not* inserted into the cache. The queue
drains round-robin across tenants.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..api import SolveOptions, SolveReport, solve_many
from ..api.torch_backend import PendingBatch, dispatch_many_torch
from ..kernels.backend import resolve_device
from ..obs.metrics import ServeMetrics
from ..obs.trace import get_tracer
from .admission import ADMIT, SHED, AdmissionController
from .cache import CacheResult, ScheduleCache


@dataclass
class _Request:
    ticket: int
    tenant: str
    D: np.ndarray
    submit_t: float
    degraded: bool


@dataclass
class _Inflight:
    """One dispatched batch: device work plus its cache-served siblings."""

    device_reqs: list[_Request]
    # The device solve: a PendingBatch (sync), the worker's future (async),
    # or None (a host solver, solved at install).
    pending: PendingBatch | Future | None
    cached: list[tuple[_Request, CacheResult]]
    degraded: bool
    dispatch_t: float


@dataclass
class ServeResult:
    """What a client gets back for one ticket."""

    ticket: int
    tenant: str
    source: str  # "device" | "cache:exact" | "cache:support"
    makespan: float
    num_configs: int
    degraded: bool
    report: SolveReport | None
    timings: dict[str, float] = field(default_factory=dict)


class ScheduleServer:
    """Multi-tenant scheduling service with admission, cache, and SLOs.

    ``submit`` returns ``(ticket, verdict)`` — SHED tickets are dropped
    (the client keeps its previous schedule); everything else lands in a
    per-tenant queue. ``step`` runs one double-buffer cycle; ``drain``
    runs until idle and stops the device worker. Completed work appears in
    ``results[ticket]``. Usable as a context manager (``close`` on exit).
    """

    def __init__(
        self,
        s: int,
        delta: float,
        *,
        mode: str = "async",
        solver: str = "spectra_torch",
        options: SolveOptions | None = None,
        install_latency_s: float = 0.0,
        max_batch: int = 8,
        admission: AdmissionController | None = None,
        cache: ScheduleCache | None = None,
        metrics: ServeMetrics | None = None,
    ) -> None:
        if mode not in ("async", "sync"):
            raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
        self.s = int(s)
        self.delta = float(delta)
        self.solver = solver
        self.options = options or SolveOptions()
        self.install_latency_s = float(install_latency_s)
        self.max_batch = int(max_batch)
        self.admission = admission
        self.cache = cache
        self.metrics = metrics or ServeMetrics()
        use_device = solver == "spectra_torch"
        # Only the device solver splits dispatch from collection; other
        # solvers take the deterministic synchronous path.
        self.mode = mode if use_device else "sync"
        self.device = (
            resolve_device(self.options.extra.get("device")) if use_device else None
        )
        self._worker: ThreadPoolExecutor | None = None
        self._queues: "OrderedDict[str, deque[_Request]]" = OrderedDict()
        self._rr = 0
        self._inflight: _Inflight | None = None
        self._next_ticket = 0
        self.results: dict[int, ServeResult] = {}
        self.shed_tickets: list[int] = []
        self._degraded_options = SolveOptions(
            validate=self.options.validate,
            validate_tol=self.options.validate_tol,
            compute_lb=self.options.compute_lb,
            extra={**self.options.extra, "equalize": False},
        )

    # ------------------------------------------------------------- intake
    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def inflight(self) -> bool:
        return self._inflight is not None

    def has_work(self) -> bool:
        return len(self) > 0 or self.inflight

    def submit(
        self, tenant: str, D: np.ndarray, now: float | None = None
    ) -> tuple[int, str]:
        """Admit one demand matrix; returns (ticket, verdict)."""
        D = np.asarray(D, dtype=np.float64)
        if D.ndim != 2 or D.shape[0] != D.shape[1]:
            raise ValueError(f"demand matrix must be square, got {D.shape}")
        ticket = self._next_ticket
        self._next_ticket += 1
        if now is None:
            now = time.perf_counter()
        verdict = (
            self.admission.admit(tenant, len(self), now)
            if self.admission is not None
            else ADMIT
        )
        self.metrics.count_verdict(verdict)
        if verdict == SHED:
            self.shed_tickets.append(ticket)
            return ticket, verdict
        self._queues.setdefault(tenant, deque()).append(
            _Request(
                ticket=ticket,
                tenant=tenant,
                D=D,
                submit_t=time.perf_counter(),
                degraded=verdict != ADMIT,
            )
        )
        return ticket, verdict

    # ------------------------------------------------------------ serving
    def _next_batch(self) -> list[_Request]:
        """Round-robin across tenants; one (shape, degraded) group/batch.

        Only a tenant's *head* request can join (per-tenant FIFO); the
        first head taken defines the group, and one full rotation collects
        matching heads up to ``max_batch``.
        """
        tenants = list(self._queues.keys())
        k = len(tenants)
        batch: list[_Request] = []
        group: tuple[tuple[int, ...], bool] | None = None
        progress = True
        # One head per tenant per rotation — a chatty tenant's backlog
        # can top a batch up, but never before every tenant's head.
        while progress and len(batch) < self.max_batch:
            progress = False
            for i in range(k):
                if len(batch) >= self.max_batch:
                    break
                t = tenants[(self._rr + i) % k]
                q = self._queues[t]
                if not q:
                    continue
                head = q[0]
                sig = (head.D.shape, head.degraded)
                if group is None:
                    group = sig
                if sig != group:
                    continue
                batch.append(q.popleft())
                progress = True
        if k:
            self._rr = (self._rr + 1) % k
        for t in tenants:
            if not self._queues[t]:
                del self._queues[t]
        return batch

    def _solve_batch(self, mats: np.ndarray, options: SolveOptions, stream) -> list[SolveReport]:
        """The worker's body: the fused device solve and its collection, on
        the server's device and the caller's stream."""
        on_cuda = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if on_cuda else contextlib.nullcontext()), \
                (torch.cuda.stream(stream) if on_cuda else contextlib.nullcontext()):
            return dispatch_many_torch(mats, self.s, self.delta, options).collect()

    def _dispatch(self, batch: list[_Request]) -> _Inflight:
        tracer = get_tracer()
        dispatch_span = tracer.span(
            "serve.dispatch",
            {"batch": len(batch)} if tracer.enabled else None,
        )
        with dispatch_span:
            return self._dispatch_inner(batch)

    def _dispatch_inner(self, batch: list[_Request]) -> _Inflight:
        degraded = batch[0].degraded
        cached: list[tuple[_Request, CacheResult]] = []
        device: list[_Request] = []
        for req in batch:
            hit = None
            if self.cache is not None and not degraded:
                hit = self.cache.lookup(
                    req.D,
                    self.s,
                    self.delta,
                    do_equalize=bool(self.options.extra.get("equalize", True)),
                    merge_aware=bool(
                        self.options.extra.get("merge_aware", False)
                    ),
                )
                if hit is None:
                    self.metrics.cache_miss += 1
                elif hit.tier == "exact":
                    self.metrics.cache_hit_exact += 1
                else:
                    self.metrics.cache_hit_support += 1
            if hit is not None:
                cached.append((req, hit))
            else:
                device.append(req)
        options = self._degraded_options if degraded else self.options
        pending = None
        dispatch_t = time.perf_counter()
        if device and self.device is not None:
            mats = np.stack([r.D for r in device])
            if self.mode == "async":
                if self._worker is None:
                    self._worker = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="schedule-server"
                    )
                stream = (
                    torch.cuda.current_stream(self.device)
                    if self.device.type == "cuda"
                    else None
                )
                pending = self._worker.submit(self._solve_batch, mats, options, stream)
            else:
                pending = dispatch_many_torch(mats, self.s, self.delta, options)
        return _Inflight(
            device_reqs=device,
            pending=pending,
            cached=cached,
            degraded=degraded,
            dispatch_t=dispatch_t,
        )

    def _install(self, flight: _Inflight) -> None:
        """Collect the flight's results and program the switches.

        The install wait (OCS programming + ACK) is host-side I/O — the
        sleep releases the GIL, so in async mode the worker's solve of the
        *next* flight proceeds underneath it.
        """
        tracer = get_tracer()
        install_span = tracer.span(
            "serve.install",
            {"device": len(flight.device_reqs), "cached": len(flight.cached)}
            if tracer.enabled
            else None,
        )
        with install_span:
            self._install_inner(flight)

    def _install_inner(self, flight: _Inflight) -> None:
        reports: list[SolveReport] = []
        if isinstance(flight.pending, Future):
            reports = flight.pending.result()  # re-raises the worker's error
        elif flight.pending is not None:
            reports = flight.pending.collect()
        elif flight.device_reqs:
            options = (
                self._degraded_options if flight.degraded else self.options
            )
            reports = solve_many(
                [r.D for r in flight.device_reqs],
                self.s,
                self.delta,
                solver=self.solver,
                options=options,
            )
        collect_t = time.perf_counter()
        device_s = collect_t - flight.dispatch_t
        if self.install_latency_s > 0:
            time.sleep(self.install_latency_s)
        done_t = time.perf_counter()
        install_s = done_t - collect_t
        self.metrics.observe("install", install_s)
        self.metrics.batches += 1

        for req, rep in zip(flight.device_reqs, reports):
            if self.cache is not None and not flight.degraded:
                self.cache.insert(req.D, rep.schedule, rep.decomposition)
            self._record(
                req, done_t, device_s,
                source="device", makespan=rep.makespan,
                num_configs=rep.num_configs, report=rep,
            )
        for req, hit in flight.cached:
            self._record(
                req, done_t, device_s=0.0,
                source=f"cache:{hit.tier}", makespan=hit.makespan,
                num_configs=hit.num_configs, report=None,
            )

    def _record(
        self,
        req: _Request,
        done_t: float,
        device_s: float,
        *,
        source: str,
        makespan: float,
        num_configs: int,
        report: SolveReport | None,
    ) -> None:
        queue_wait = max(0.0, done_t - req.submit_t - device_s
                         - self.install_latency_s)
        timings = {
            "queue_wait_s": queue_wait,
            "device_s": device_s,
            "e2e_s": done_t - req.submit_t,
        }
        self.metrics.observe("queue_wait", queue_wait)
        self.metrics.observe("device", device_s)
        self.metrics.observe("e2e", timings["e2e_s"])
        self.metrics.schedules += 1
        self.results[req.ticket] = ServeResult(
            ticket=req.ticket,
            tenant=req.tenant,
            source=source,
            makespan=float(makespan),
            num_configs=int(num_configs),
            degraded=req.degraded,
            report=report,
            timings=timings,
        )

    def step(self) -> bool:
        """One serving cycle; returns False when there was nothing to do.

        Async: dispatch the next batch *first*, then install the previous
        one (its install wait overlaps the new batch's device solve).
        Sync: dispatch and install back-to-back.
        """
        batch = self._next_batch()
        if not batch and self._inflight is None:
            return False
        if self.mode == "sync":
            if batch:
                self._install(self._dispatch(batch))
            return True
        flight = self._dispatch(batch) if batch else None
        # The new flight is in flight before the previous one installs, so
        # an error re-raised by that install does not orphan it.
        previous, self._inflight = self._inflight, flight
        if previous is not None:
            self._install(previous)
        return True

    def drain(self) -> dict[int, ServeResult]:
        """Serve until queue and pipeline are empty, stop the device worker,
        and return all results. A worker's error re-raises from here."""
        try:
            while self.has_work():
                self.step()
        finally:
            self.close()
        return self.results

    def close(self) -> None:
        """Stop the device worker (waiting for a batch it still runs). The
        next async dispatch starts a new one."""
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    def __enter__(self) -> "ScheduleServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
