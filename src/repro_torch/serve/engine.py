"""Serving engines: batched LM decode and the batched OCS solver service
(the port's counterpart of ``repro.serve.engine``).

``DecodeEngine`` — a batch of same-length prompts is prefilled by cache
replay (one ``decode_step`` per prompt position), then decoded greedily or
by temperature sampling for ``max_new_tokens``. Steps run eagerly on the
model's device; the tokens stay there until the end of ``generate``, so a
step needs no host read. Temperature sampling draws from a
``torch.Generator`` seeded with ``seed``: it cannot reproduce the
reference's JAX random bits, only their distribution.

``SolverService`` — the scheduling half: clients submit demand matrices
(or a whole demand trace, one ticket a period), the service groups
same-shape instances and drains them through ``repro_torch.api.solve_many``
(on ``spectra_torch`` one fused device call per group). ``open_session``
switches to the stateful (online) mode: an ``OnlineSession`` carries the
switch configurations across calls, serves matching rounds δ-free and
warm-starts each decomposition from the previous period.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..api import SolveOptions, SolveReport, solve_many


@dataclass
class GenerationResult:
    tokens: np.ndarray       # (B, prompt + generated)
    prompt_len: int
    steps: int
    # With ``keep_logits``: (B, steps − 1, V) float32, the logits of every
    # decode step; entry t predicts token t + 1.
    logits: torch.Tensor | None = None


class DecodeEngine:
    def __init__(self, model, *, max_len: int = 512):
        self.model = model
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int, *, temperature: float = 0.0,
                 seed: int = 0, keep_logits: bool = False, enc_out: torch.Tensor | None = None) -> GenerationResult:
        """prompts: (B, S0) int, the same length per batch. ``enc_out`` is the
        encoder's output for an encoder–decoder model (``LM.encode``)."""
        B, S0 = prompts.shape
        total = S0 + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"{total} exceeds engine max_len {self.max_len}")
        dev = self.model.device
        cache = self.model.init_cache(B, self.max_len, enc_out=enc_out)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)
        kept = []
        logits = None
        for t in range(S0):  # prefill by replay
            logits, cache = self.model.decode_step(cache, toks[:, t:t + 1])
            kept.append(logits[:, -1])
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = [toks]
        nxt = None
        for _ in range(max_new_tokens):
            if nxt is not None:
                logits, cache = self.model.decode_step(cache, nxt)
                kept.append(logits[:, -1])
            lg = logits[:, -1]
            if temperature > 0:
                nxt = torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1, generator=gen)
            else:
                nxt = lg.argmax(dim=-1, keepdim=True)
            out.append(nxt)
        tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=tokens, prompt_len=S0, steps=total,
                                logits=torch.stack(kept, dim=1) if keep_logits else None)


@dataclass
class SolverService:
    """Queue-and-drain scheduling service over the unified solver API.

    ``submit`` enqueues a demand matrix and returns a ticket; ``flush``
    solves everything queued — batching same-shape matrices into one
    ``solve_many`` call each (on ``spectra_torch``: one fused
    decompose/schedule/equalize device call per group) — and returns
    ``{ticket: SolveReport}``.
    """

    s: int
    delta: float
    solver: str = "spectra"
    options: SolveOptions = field(default_factory=SolveOptions)
    processes: int | None = None

    def __post_init__(self) -> None:
        self._queue: list[tuple[int, np.ndarray]] = []
        self._next_ticket = 0

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, D: np.ndarray) -> int:
        D = np.asarray(D, dtype=np.float64)
        if D.ndim != 2 or D.shape[0] != D.shape[1]:
            raise ValueError(f"demand matrix must be square, got {D.shape}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, D))
        return ticket

    def submit_trace(self, trace) -> list[int]:
        """Enqueue a whole training run: one ticket per controller period.

        ``trace`` is a ``repro.scenarios.DemandTrace`` (or anything with a
        ``.demands`` stack, or a raw ``(T, n, n)`` array). All periods of a
        trace share one shape, so a subsequent ``flush`` drains them — plus
        anything else queued at that shape — through a single batched
        ``solve_many`` group (one fused device call on ``spectra_torch``).

        The service's ``delta`` is in demand-time units, so byte-denominated
        traces are rejected: normalize first (``trace.normalized()`` /
        ``run_scenario``) rather than mixing byte magnitudes with a
        units-denominated δ.
        """
        spec = getattr(trace, "spec", None)
        if spec is not None and getattr(spec, "units", "demand") == "bytes":
            raise ValueError(
                "trace is denominated in bytes; normalize it to demand units "
                "(DemandTrace.normalized or run_scenario) before submitting"
            )
        if getattr(trace, "varying_delta", False):
            # The service solves every ticket at its single scalar delta; a
            # per-period delta_schedule would be silently flattened to it.
            raise ValueError(
                "trace carries a per-period delta_schedule but the service "
                "solves at one delta; use repro_torch.scenarios.run_scenario (or "
                "solve_many with a per-instance delta vector) instead"
            )
        demands = np.asarray(getattr(trace, "demands", trace), dtype=np.float64)
        if demands.ndim != 3 or demands.shape[1] != demands.shape[2]:
            raise ValueError(
                f"trace must be a (T, n, n) demand stack, got {demands.shape}"
            )
        return [self.submit(D) for D in demands]

    def flush(self) -> dict[int, SolveReport]:
        if not self._queue:
            return {}
        pending, self._queue = self._queue, []
        try:
            # solve_many shape-buckets ragged submissions itself (one fused
            # device call per distinct shape on spectra_torch) and returns
            # reports in submission order.
            reports = solve_many(
                [D for _, D in pending],
                self.s,
                self.delta,
                solver=self.solver,
                options=self.options,
                processes=self.processes,
            )
        except Exception:
            # One bad matrix must not drop the other pods' requests. Nothing
            # from this flush has been delivered, so every submission goes
            # back on the queue to be re-solved by the next flush.
            self._queue = list(pending) + self._queue
            raise
        return {ticket: rep for (ticket, _), rep in zip(pending, reports)}

    def open_session(self, *, solver: str | None = None) -> "OnlineSession":
        """Open a *stateful* scheduling session (online cross-period mode).

        Unlike ``submit``/``flush`` — which treats every matrix as an
        independent instance — a session carries the switch state between
        calls: each ``step`` pays no δ for configurations left installed by
        the previous one, and warm-starts its decomposition from it. Periods
        are inherently sequential (state threads through), so a session
        solves per call rather than batching.

        ``solver`` defaults to the online variant of the service's solver
        (``spectra → spectra_online``, ``spectra_torch →
        spectra_online_torch``); any registered ``spectra_online*`` name is
        accepted.
        """
        if solver is None:
            solver = {
                "spectra": "spectra_online",
                "spectra_torch": "spectra_online_torch",
            }.get(self.solver, "spectra_online")
        return OnlineSession(
            s=self.s, delta=self.delta, solver=solver, options=self.options
        )


@dataclass
class OnlineSession:
    """A stateful solver session: one controller period per ``step``.

    Thin wrapper over the ``spectra_online[_torch]`` registry solvers that
    threads ``SolveOptions.extra["online"]`` automatically. ``reports``
    keeps the per-period history; ``total_delta_avoided`` totals the reuse
    credit earned so far.
    """

    s: int
    delta: float
    solver: str = "spectra_online"
    options: SolveOptions = field(default_factory=SolveOptions)

    def __post_init__(self) -> None:
        self._state = None
        self.reports: list[SolveReport] = []

    def __len__(self) -> int:
        return len(self.reports)

    @property
    def state(self):
        """The carried switch state (None before the first step)."""
        return self._state

    @property
    def total_delta_avoided(self) -> float:
        return float(
            sum(r.extras.get("delta_avoided", 0.0) for r in self.reports)
        )

    def step(self, D: np.ndarray) -> SolveReport:
        """Schedule one period against the carried state and advance it."""
        from ..api import Problem, solve

        D = np.asarray(D, dtype=np.float64)
        extra = dict(self.options.extra)
        extra["online"] = self._state
        options = SolveOptions(
            validate=self.options.validate,
            validate_tol=self.options.validate_tol,
            compute_lb=self.options.compute_lb,
            extra=extra,
        )
        report = solve(
            Problem(D, self.s, self.delta), solver=self.solver, options=options
        )
        self._state = report.extras["online_state"]
        self.reports.append(report)
        return report

    def run(self, trace) -> list[SolveReport]:
        """Step through a whole trace (``DemandTrace`` or (T, n, n) array).

        The session solves every period at its single scalar ``delta`` in
        demand units, so — exactly like ``SolverService.submit_trace`` —
        byte-denominated traces and per-period ``delta_schedule`` traces are
        rejected with a clear error rather than silently mis-priced.
        """
        spec = getattr(trace, "spec", None)
        if spec is not None and getattr(spec, "units", "demand") == "bytes":
            raise ValueError(
                "trace is denominated in bytes; normalize it to demand units "
                "(DemandTrace.normalized or run_scenario) before stepping a "
                "session through it"
            )
        if getattr(trace, "varying_delta", False):
            raise ValueError(
                "trace carries a per-period delta_schedule but the session "
                "solves at one delta; use repro_torch.scenarios.run_scenario(..., "
                "online=True) instead"
            )
        demands = np.asarray(
            getattr(trace, "demands", trace), dtype=np.float64
        )
        if demands.ndim != 3 or demands.shape[1] != demands.shape[2]:
            raise ValueError(
                f"trace must be a (T, n, n) demand stack, got {demands.shape}"
            )
        return [self.step(D) for D in demands]
