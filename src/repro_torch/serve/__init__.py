"""Serving: batched LM decode (``DecodeEngine``) and the scheduling control
plane (the port's counterpart of ``repro.serve``).

    from repro_torch.serve import ScheduleServer, ScheduleCache

    srv = ScheduleServer(s=4, delta=0.01, cache=ScheduleCache(64))
    ticket, verdict = srv.submit("job-a", D)
    srv.drain()
    print(srv.results[ticket].makespan, srv.metrics.export())

``ScheduleServer`` (``server``) double-buffers the device solve of
``spectra_torch`` against the switch install on a worker thread it owns;
``AdmissionController`` (``admission``) and ``ScheduleCache`` (``cache``)
sit in front of it; ``SolverService`` / ``OnlineSession`` (``engine``) and
``SessionManager`` (``sessions``) are the batch and stateful entry points;
``loadgen`` replays open-loop Poisson traffic against a server.
"""

from .admission import ADMIT, DEGRADED, SHED, AdmissionController, TokenBucket
from .cache import CacheResult, ScheduleCache
from .engine import DecodeEngine, GenerationResult, OnlineSession, SolverService
from .loadgen import (
    Arrival,
    TenantLoad,
    make_workload,
    mixed_profile,
    poisson_arrivals,
    run_open_loop,
    submit_all,
    tiny_profile,
)
from .metrics import STAGES, LatencyHistogram, ServeMetrics
from .server import ScheduleServer, ServeResult
from .sessions import SessionManager, TenantSession

__all__ = [
    "ADMIT", "DEGRADED", "SHED", "STAGES",
    "AdmissionController", "Arrival", "CacheResult", "DecodeEngine",
    "GenerationResult", "LatencyHistogram", "OnlineSession", "ScheduleCache",
    "ScheduleServer", "ServeMetrics", "ServeResult", "SessionManager",
    "SolverService", "TenantLoad", "TenantSession", "TokenBucket",
    "make_workload", "mixed_profile", "poisson_arrivals", "run_open_loop",
    "submit_all", "tiny_profile",
]
