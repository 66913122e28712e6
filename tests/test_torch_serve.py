"""The port's scheduling control plane (``repro_torch.serve``) against the
reference's ``repro.serve`` on the same seeded inputs.

``make_workload`` gives the reference's arrivals and matrices bit for bit;
admission verdicts and cache tiers and keys are the reference's; the
``ScheduleServer`` gives identical results in ``sync`` and ``async``, equal
to the reference's makespans with ``spectra`` and to ``spectra_jax``'s to
1e-4 with ``spectra_torch`` (the plain CPU path). The async server hands its
device call to a worker thread: ``_dispatch`` returns before the worker's
solve ends (shown with an event, not a clock), and a worker's error
re-raises from ``drain()``. Sessions decide as the reference's
``spectra_online_jax``.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.serve.admission as ref_adm  # noqa: E402
import repro.serve.cache as ref_cache  # noqa: E402
import repro.serve.loadgen as ref_lg  # noqa: E402
from repro.api import Problem as RefProblem  # noqa: E402
from repro.api import SolveOptions as RefOptions  # noqa: E402
from repro.api import solve as ref_solve  # noqa: E402
from repro.serve.engine import SolverService as RefService  # noqa: E402
from repro.serve.server import ScheduleServer as RefServer  # noqa: E402
from repro.serve.sessions import SessionManager as RefManager  # noqa: E402

import repro_torch.serve.server as server_mod  # noqa: E402
from repro_torch.api import Problem, SolveOptions, solve  # noqa: E402
from repro_torch.obs import get_tracer  # noqa: E402
from repro_torch.scenarios import make_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ADMIT,
    DEGRADED,
    SHED,
    AdmissionController,
    OnlineSession,
    ScheduleCache,
    ScheduleServer,
    SessionManager,
    SolverService,
    TenantSession,
    TokenBucket,
    make_workload,
    mixed_profile,
    poisson_arrivals,
    run_open_loop,
    submit_all,
    tiny_profile,
)
from repro_torch.serve.cache import exact_key, support_key  # noqa: E402

FAST = dict(validate=False, compute_lb=False)
CPU_FAST = SolveOptions(**FAST, extra={"device": "cpu"})
CPU = SolveOptions(extra={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perm_demand(n, rng, k=3):
    D = np.zeros((n, n))
    sigma = rng.permutation(n)
    for j in range(k):
        D[np.arange(n), np.roll(sigma, j)] = rng.random(n) + 0.2
    return D


# ----------------------------------------------------------------- loadgen


@pytest.mark.parametrize("profile, kw", [
    (tiny_profile, dict(n=8, rate=40.0)),
    (mixed_profile, dict(n_small=8, n_large=16, rate=30.0)),
    (mixed_profile, dict(n_small=32, n_large=64, rate=12.0)),
])
def test_make_workload_equals_reference_bit_for_bit(profile, kw):
    ref_profile = getattr(ref_lg, profile.__name__)
    assert [vars(t) for t in profile(**kw)] == [vars(t) for t in ref_profile(**kw)]
    got = make_workload(profile(**kw), duration=0.6, seed=3, s=4, delta=0.01)
    want = ref_lg.make_workload(ref_profile(**kw), duration=0.6, seed=3, s=4, delta=0.01)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.t, g.tenant) == (w.t, w.tenant)
        np.testing.assert_array_equal(g.D, w.D)


def test_poisson_arrivals_equal_reference():
    for rate, duration in ((100.0, 2.0), (3.0, 0.5), (0.0, 1.0), (5.0, 0.0)):
        got = poisson_arrivals(rate, duration, np.random.default_rng(9))
        want = ref_lg.poisson_arrivals(rate, duration, np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- admission


def test_token_bucket_and_admission_verdicts_equal_reference():
    for args in ((2.0, 3.0), (0.0, 1.0)):
        got, want = TokenBucket(*args), ref_adm.TokenBucket(*args)
        for now in (0.0, 0.1, 0.1, 0.1, 0.2, 1.5, 1.5, 1.6, 4.0):
            assert got.try_take(now) == want.try_take(now)
            assert got.tokens == want.tokens
    with pytest.raises(ValueError):
        TokenBucket(-1.0, 1.0)
    got = AdmissionController(rate=5.0, burst=2.0, max_queue=3)
    want = ref_adm.AdmissionController(rate=5.0, burst=2.0, max_queue=3)
    got.set_tenant_rate("vip", 100.0, 10.0)
    want.set_tenant_rate("vip", 100.0, 10.0)
    rng = np.random.default_rng(1)
    verdicts = []
    for i in range(60):
        tenant = ("a", "b", "vip")[int(rng.integers(3))]
        depth, now = int(rng.integers(5)), 0.05 * i
        v = got.admit(tenant, depth, now)
        assert v == want.admit(tenant, depth, now)
        verdicts.append(v)
    assert {ADMIT, DEGRADED, SHED} == set(verdicts)


# ------------------------------------------------------------------- cache


def test_cache_keys_tiers_and_stats_equal_reference():
    rng = np.random.default_rng(2)
    base = [_perm_demand(8, rng) for _ in range(3)]
    drift = [D * (1.0 + 0.05 * rng.random(D.shape)) * (D > 0) for D in base]
    for D in base + drift:
        assert support_key(D) == ref_cache.support_key(D)
        assert exact_key(D, 1e-3) == ref_cache.exact_key(D, 1e-3)
    got, want = ScheduleCache(capacity=2), ref_cache.ScheduleCache(capacity=2)
    assert got.lookup(base[0], 2, 0.01) is None and want.lookup(base[0], 2, 0.01) is None
    for D in base:
        rep = solve(Problem(D, 2, 0.01), solver="spectra", options=SolveOptions(**FAST))
        ref = ref_solve(RefProblem(D, 2, 0.01), solver="spectra", options=RefOptions(**FAST))
        got.insert(D, rep.schedule, rep.decomposition)
        want.insert(D, ref.schedule, ref.decomposition)
    got.insert(base[2], rep.schedule)  # decomposition from the schedule; in place
    want.insert(base[2], ref.schedule)
    for D in base + drift + [base[1] * 1.0000001]:
        g, w = got.lookup(D, 2, 0.01), want.lookup(D, 2, 0.01)
        assert (g is None) == (w is None)
        if g is not None:
            assert (g.tier, g.num_configs) == (w.tier, w.num_configs)
            assert g.makespan == pytest.approx(w.makespan, rel=1e-12)
    assert len(got) == len(want) == 2
    assert vars(got.stats) == vars(want.stats) and got.stats.hits_exact and got.stats.hits_support
    with pytest.raises(ValueError):
        ScheduleCache(capacity=0)


# ------------------------------------------------------------------ server


def _serve(srv, wl):
    submit_all(srv, wl)
    res = srv.drain()
    return sorted((r.ticket, r.source, r.makespan, r.num_configs, r.degraded) for r in res.values())


def test_server_host_solver_equals_reference_and_runs_sync():
    wl = make_workload(tiny_profile(n=8, rate=40.0), duration=0.4, seed=5, s=2, delta=0.01)
    kw = dict(max_batch=3, admission=None)
    srv = ScheduleServer(2, 0.01, mode="async", solver="spectra", options=SolveOptions(**FAST),
                         cache=ScheduleCache(8), **kw)
    ref = RefServer(2, 0.01, mode="async", solver="spectra", options=RefOptions(**FAST),
                    cache=ref_cache.ScheduleCache(8), **kw)
    assert srv.mode == ref.mode == "sync"
    got, want = _serve(srv, wl), _serve(ref, wl)
    assert got == want and len(got) == len(wl)
    assert any(src.startswith("cache") for _, src, *_ in got)
    with pytest.raises(ValueError):
        ScheduleServer(2, 0.01, mode="overlapped")
    with pytest.raises(ValueError):
        srv.submit("a", np.zeros((3, 4)))


def test_server_admission_shed_degraded_and_fairness_as_reference():
    rng = np.random.default_rng(3)
    mats = [_perm_demand(6, rng) for _ in range(8)]
    outs = []
    for Server, Adm, Opts in ((ScheduleServer, AdmissionController, SolveOptions),
                              (RefServer, ref_adm.AdmissionController, RefOptions)):
        srv = Server(2, 0.01, solver="spectra", options=Opts(**FAST), max_batch=2,
                     admission=Adm(rate=0.001, burst=2.0, max_queue=5))
        verdicts = [srv.submit(("chatty", "chatty", "quiet")[i % 3], D, now=0.0)[1] for i, D in enumerate(mats)]
        first = [r.tenant for r in srv._next_batch()]
        srv.drain()
        m = srv.metrics
        outs.append((verdicts, first, sorted(srv.results), srv.shed_tickets, (m.admitted, m.degraded, m.shed),
                     sorted((t, r.degraded, r.makespan) for t, r in srv.results.items())))
    assert outs[0] == outs[1]
    assert outs[0][1] == ["chatty", "quiet"]


@pytest.mark.parametrize("with_cache", [False, True])
def test_server_device_sync_and_async_identical_and_equal_reference(with_cache):
    """``spectra_torch`` on the CPU: sync and async serve identical results,
    equal to the reference's ``spectra_jax`` to 1e-4 (one batch of B = 4,
    one shape)."""
    wl = make_workload(tiny_profile(n=8, rate=30.0), duration=0.3, seed=7, s=2, delta=0.01)[:4]
    assert len(wl) == 4
    outs = {}
    for mode in ("sync", "async"):
        srv = ScheduleServer(2, 0.01, mode=mode, options=CPU, max_batch=4,
                             cache=ScheduleCache(8) if with_cache else None)
        assert srv.mode == mode and srv.device == torch.device("cpu")
        outs[mode] = _serve(srv, wl + wl[:1])  # a repeat: served from the cache when there is one
        assert all(r.report is None or r.report.validated for r in srv.results.values())
        assert srv._worker is None  # drain stopped the worker
    same = [(t, mk, k, deg) for t, _, mk, k, deg in outs["sync"]]
    assert same == [(t, mk, k, deg) for t, _, mk, k, deg in outs["async"]]
    if with_cache:
        # The repeat's batch is dispatched before the first batch installs
        # (and fills the cache) in async, as in the reference.
        assert outs["sync"][-1][1] == "cache:exact" and outs["async"][-1][1] == "device"
    else:
        assert outs["sync"] == outs["async"]
    ref = RefServer(2, 0.01, mode="async", solver="spectra_jax", options=RefOptions(**FAST), max_batch=4)
    assert ref.mode == "async"
    want = _serve(ref, wl)
    for g, w in zip(outs["async"], want):
        assert (g[0], g[1], g[4]) == (w[0], w[1], w[4])
        assert g[2] == pytest.approx(w[2], rel=1e-4)


def test_async_dispatch_returns_before_the_workers_solve_ends(monkeypatch):
    """The worker holds the solve until the test releases it: ``_dispatch``
    returns meanwhile, and ``_install`` then collects the reports."""
    release, entered = threading.Event(), threading.Event()
    real = server_mod.dispatch_many_torch
    threads = []

    def gated(*args, **kw):
        threads.append(threading.get_ident())
        entered.set()
        assert release.wait(timeout=60), "the test never released the solve"
        return real(*args, **kw)

    monkeypatch.setattr(server_mod, "dispatch_many_torch", gated)
    srv = ScheduleServer(2, 0.01, mode="async", options=CPU_FAST)
    rng = np.random.default_rng(4)
    for i in range(2):
        srv.submit(f"t{i}", _perm_demand(6, rng))
    flight = srv._dispatch(srv._next_batch())
    assert entered.wait(timeout=60)
    assert not flight.pending.done() and not release.is_set()
    assert threads and threads[0] != threading.get_ident()
    release.set()
    srv._install(flight)
    srv.close()
    assert sorted(srv.results) == [0, 1] and all(r.source == "device" for r in srv.results.values())


def test_async_step_overlaps_install_with_the_next_solve(monkeypatch):
    """In a step, batch t+1 is handed to the worker before batch t
    installs: the worker enters t+1's solve while t's install waits."""
    entered = [threading.Event() for _ in range(3)]
    real = server_mod.dispatch_many_torch
    calls = []

    def counted(*args, **kw):
        entered[len(calls)].set()
        calls.append(1)
        return real(*args, **kw)

    overlapped = []
    real_install = ScheduleServer._install

    def install(self, flight):
        i = len(overlapped)
        nxt = i + 1 < len(entered) and entered[i + 1].wait(timeout=60)
        overlapped.append((self._inflight is not None, bool(nxt)))
        real_install(self, flight)

    monkeypatch.setattr(server_mod, "dispatch_many_torch", counted)
    monkeypatch.setattr(ScheduleServer, "_install", install)
    srv = ScheduleServer(2, 0.01, mode="async", options=CPU_FAST, max_batch=1)
    rng = np.random.default_rng(5)
    for _ in range(3):
        srv.submit("a", _perm_demand(6, rng))
    srv.drain()
    assert len(srv.results) == 3 and len(calls) == 3
    # Each install but the last had the next batch in flight and in its solve.
    assert overlapped == [(True, True), (True, True), (False, False)]


def test_worker_error_reraises_from_drain(monkeypatch):
    def broken(*args, **kw):
        raise FloatingPointError("device solve failed")

    monkeypatch.setattr(server_mod, "dispatch_many_torch", broken)
    srv = ScheduleServer(2, 0.01, mode="async", options=CPU_FAST, max_batch=1)
    rng = np.random.default_rng(6)
    for _ in range(3):
        srv.submit("a", _perm_demand(6, rng))
    with pytest.raises(FloatingPointError, match="device solve failed"):
        srv.drain()
    assert srv.results == {} and srv._worker is None


def test_worker_spans_land_on_the_workers_thread():
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        srv = ScheduleServer(2, 0.01, mode="async", options=CPU_FAST)
        srv.submit("a", _perm_demand(6, np.random.default_rng(7)))
        srv.drain()
        spans = {e.name: e.tid for e in tracer.spans()}
    finally:
        tracer.disable()
        tracer.reset()
    assert spans["serve.dispatch"] == spans["serve.install"] == threading.get_ident()
    assert spans["torch.dispatch"] == spans["torch.collect"] != threading.get_ident()


def test_device_server_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScheduleServer(2, 0.01, mode="async")


def test_run_open_loop_serves_every_arrival():
    wl = make_workload(tiny_profile(n=8, rate=40.0), duration=0.4, seed=2, s=2, delta=0.01)
    srv = ScheduleServer(2, 0.01, mode="async", options=CPU, cache=ScheduleCache(16),
                         admission=AdmissionController())
    m = run_open_loop(srv, wl)
    assert m["schedules"] == len(wl) and m["shed"] == 0 and m["degraded"] == 0
    assert m["stages"]["e2e"]["count"] == len(wl) and srv._worker is None
    assert all(r.report is None or r.report.validated for r in srv.results.values())


# ---------------------------------------------------------------- sessions


def test_solver_service_flush_and_open_session_map_as_reference():
    rng = np.random.default_rng(8)
    mats = [_perm_demand(6, rng) for _ in range(3)] + [_perm_demand(8, rng)]
    got, want = SolverService(2, 0.01, options=SolveOptions(**FAST)), RefService(2, 0.01, options=RefOptions(**FAST))
    for D in mats:
        assert got.submit(D) == want.submit(D)
    assert len(got) == 4
    g, w = got.flush(), want.flush()
    assert {t: r.makespan for t, r in g.items()} == {t: r.makespan for t, r in w.items()}
    assert got.flush() == {}
    dev = SolverService(2, 0.01, solver="spectra_torch", options=CPU)
    assert dev.open_session().solver == "spectra_online_torch"
    assert got.open_session().solver == "spectra_online"
    assert SolverService(2, 0.01, solver="rotor").open_session().solver == "spectra_online"
    assert SolverService(2, 0.01).open_session(solver="spectra_online_torch").solver == "spectra_online_torch"
    with pytest.raises(ValueError, match="bytes"):
        got.submit_trace(make_trace("collective_ring", n=8, periods=2))
    ids = got.submit_trace(np.stack(mats[:3]))
    assert ids == [4, 5, 6] and set(got.flush()) == set(ids)


def _decisions(reports):
    return [(bool(r.extras["warm"]), bool(r.extras["cache_hit"]), int(r.extras["k"]), int(r.extras["reuse_count"]))
            for r in reports]


def test_session_manager_decides_as_reference():
    """Two tenants at n = 8, four periods each, through ``spectra_online_torch``
    on the CPU and the reference's ``spectra_online_jax``: the same
    decisions, makespans to 1e-4, the same fair draining order."""
    traces = {name: make_trace(name, n=8, periods=4).normalized()[0] for name in ("gpt", "moe_phases")}
    served = {}
    for key, mgr in (("port", SessionManager(4, 0.01, options=CPU)),
                     ("ref", RefManager(4, 0.01, solver="spectra_online_jax"))):
        for name, units in traces.items():
            for D in units:
                mgr.submit(name, D)
        assert mgr.backlog == 8
        served[key] = mgr.drain()
        served[key + "_stats"] = mgr.stats()
    assert [t for t, _ in served["port"]] == [t for t, _ in served["ref"]]
    for name in traces:
        got = [r for t, r in served["port"] if t == name]
        want = [r for t, r in served["ref"] if t == name]
        assert _decisions(got) == _decisions(want), name
        np.testing.assert_allclose([r.makespan for r in got], [r.makespan for r in want], rtol=1e-4)
        assert all(r.validated and r.solver == "spectra_online_torch" for r in got)
        g, w = served["port_stats"][name], served["ref_stats"][name]
        assert {k: v for k, v in g.items() if k != "delta_avoided"} == {
            k: v for k, v in w.items() if k != "delta_avoided"}
        assert g["delta_avoided"] == pytest.approx(w["delta_avoided"], rel=1e-6)
    assert served["port_stats"]["moe_phases"]["warm"] > 0


def test_online_session_and_tenant_session():
    units = make_trace("gpt", n=8, periods=3).normalized()[0]
    sess = OnlineSession(4, 0.01)
    assert sess.state is None and sess.solver == "spectra_online"
    reps = sess.run(units)
    assert len(sess) == 3 and sess.state is not None
    assert sess.total_delta_avoided == pytest.approx(sum(r.extras["delta_avoided"] for r in reps))
    with pytest.raises(ValueError, match="bytes"):
        sess.run(make_trace("collective_ring", n=8, periods=2))
    with pytest.raises(ValueError, match="delta_schedule"):
        sess.run(make_trace("gpt", n=8, periods=2, delta_schedule=(0.01, 0.02)))
    ts = TenantSession("t", 4, 0.01, options=CPU, cache_size=4)
    assert ts.solver == "spectra_online_torch"
    ts.step(units[0])
    assert len(ts) == 1 and ts.stats()["periods"] == 1 and ts.state is not None
