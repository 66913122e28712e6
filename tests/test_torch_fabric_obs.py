"""The port's span tracer and fabric timeline/simulator against the
reference's, on the CPU.

The tracer: disabled it hands out the shared no-op singleton; enabled it
nests spans, closes children with their parent, and exports the reference's
Chrome trace-event keys; ``Pipeline`` and ``solve_many`` emit the
reference's span names (``torch.*`` in place of ``jax.*``). The fabric:
``build_timeline`` windows and ``simulate`` reports (the ``installed``
carry too) equal the reference's on the same schedules, and
``OCSFabric.schedule_bytes`` gives the reference's CCT with a registry name,
a callable and the legacy kwargs.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.api as ref_api  # noqa: E402
import repro.obs.trace as ref_trace  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.obs.trace as trace  # noqa: E402
from repro.core.spectra import spectra as ref_spectra  # noqa: E402
from repro.fabric.ocs import OCSFabric as RefFabric  # noqa: E402
from repro.fabric.simulator import simulate as ref_simulate  # noqa: E402
from repro.fabric.timeline import build_timeline as ref_build_timeline  # noqa: E402
from repro_torch.core.spectra import spectra  # noqa: E402
from repro_torch.fabric import OCSFabric, build_timeline, simulate  # noqa: E402
from repro_torch.obs import Tracer, get_tracer  # noqa: E402
from repro_torch.obs.host_reads import count_host_reads  # noqa: E402
from repro_torch.traffic import gpt3b_workload, moe_workload  # noqa: E402

CPU = api.SolveOptions(extra={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def traced():
    """Both packages' default tracers, enabled for one test and then reset."""
    tracers = (get_tracer(), ref_trace.get_tracer())
    for t in tracers:
        t.reset()
        t.enable()
    yield tracers
    for t in tracers:
        t.disable()
        t.reset()


# ----------------------------------------------------------------- tracer


def test_disabled_tracer_returns_the_shared_null_span():
    t = Tracer()
    assert t.span("a") is trace._NULL_SPAN and t.span("b", {"k": 1}) is trace._NULL_SPAN
    with t.span("c") as sp:
        sp.set(x=1)
    t.instant("i")
    t.counter("c", 1.0)
    assert t.events == [] and not get_tracer().enabled


def test_nesting_containment_and_exception_close():
    t = Tracer(enabled=True)
    with t.span("outer"):
        with t.span("mid", {"k": 1}) as sp:
            with t.span("inner"):
                pass
            sp.set(done=True)
        with t.span("mid2"):
            pass
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            with t.span("child"):
                raise RuntimeError("x")
    ev = {e.name: e for e in t.spans()}
    assert [e.name for e in t.spans()] == ["outer", "mid", "inner", "mid2", "boom", "child"]
    names = [e.name for e in t.events]
    for e in t.spans():
        if e.parent is not None:
            p = t.events[e.parent]
            assert p.start <= e.start and e.end <= p.end
    assert names[ev["inner"].parent] == "mid" and names[ev["mid"].parent] == "outer"
    assert ev["outer"].parent is None and ev["mid"].args == {"k": 1, "done": True}
    assert ev["child"].end <= ev["boom"].end
    t.disable()
    assert t.span("after") is trace._NULL_SPAN
    t.reset()
    assert t.events == []


def _drive(t):
    with t.span("solve", {"n": 8}):
        with t.span("stage"):
            t.instant("mark", {"a": 1})
        t.counter("rounds", 3)


def test_chrome_export_has_the_reference_event_keys(tmp_path):
    mine, ref = Tracer(enabled=True), ref_trace.Tracer(enabled=True)
    _drive(mine)
    _drive(ref)
    got, want = mine.to_chrome(), ref.to_chrome()
    assert set(got) == set(want) and got["displayTimeUnit"] == want["displayTimeUnit"]
    assert len(got["traceEvents"]) == len(want["traceEvents"]) == 4
    for g, w in zip(got["traceEvents"], want["traceEvents"]):
        assert set(g) == set(w)
        for key in ("name", "cat", "ph", "pid", "args", "s"):
            assert g.get(key) == w.get(key)
    path = mine.save(tmp_path / "sub" / "trace.json")
    assert json.loads(path.read_text()) == json.loads(json.dumps(got))


def _shape(events):
    return [(e.name, None if e.parent is None else events[e.parent].name) for e in events]


def test_pipeline_and_host_solve_many_emit_the_reference_spans(traced):
    mine, ref = traced
    D = gpt3b_workload(rng=np.random.default_rng(1))
    Ds = np.stack([D, D[::-1]])
    api.solve_many(Ds, 4, 0.01, solver="spectra")
    ref_api.solve_many(Ds, 4, 0.01, solver="spectra")
    api.Pipeline(decompose="eclipse", schedule="wrap", equalize="none")(api.Problem(D, 4, 0.01))
    ref_api.Pipeline(decompose="eclipse", schedule="wrap", equalize="none")(ref_api.Problem(D, 4, 0.01))
    assert _shape(mine.spans()) == _shape(ref.spans())
    assert [e.args for e in mine.spans()] == [e.args for e in ref.spans()]
    assert {e.name for e in mine.spans()} == {"solve_many", "decompose", "matcher", "schedule", "equalize"}


STAGES = ["e2e.decompose", "e2e.lpt", "e2e.equalize", "e2e.bound"]


def test_device_solve_many_emits_the_reference_spans_under_torch_names(traced):
    mine, ref = traced
    Ds = np.random.default_rng(2).random((2, 6, 6))
    api.solve_many(Ds, 2, 0.01, options=CPU)
    ref_api.solve_many(Ds, 2, 0.01, solver="spectra_jax")
    want = [(n.replace("jax.", "torch."), p) for n, p in _shape(ref.spans())]
    # The port's fused solve adds its stage spans under torch.dispatch.
    shape = _shape(mine.spans())
    assert [x for x in shape if not x[0].startswith("e2e.")] == want == [
        ("solve_many", None), ("bucket", "solve_many"), ("torch.dispatch", "bucket"), ("torch.collect", "bucket"),
    ]
    assert [x for x in shape if x[0].startswith("e2e.")] == [(name, "torch.dispatch") for name in STAGES]
    ref_args = [{k: ("spectra_torch" if v == "spectra_jax" else v) for k, v in e.args.items()} for e in ref.spans()]
    assert [e.args for e in mine.spans() if not e.name.startswith("e2e.")] == ref_args
    mine.reset()
    api.Pipeline(decompose="torch_auction", equalize="torch")(api.Problem(Ds[0], 2, 0.01), CPU)
    assert [(e.name, e.args) for e in mine.spans() if e.parent is None] == [
        ("decompose", {"impl": "torch_auction"}), ("schedule", {"impl": "lpt"}), ("equalize", {"impl": "torch"}),
    ]


@pytest.mark.parametrize("equalize", [True, False])
def test_fused_solve_stage_spans_tile_the_dispatch_in_order(traced, equalize):
    mine, _ = traced
    Ds = np.random.default_rng(4).random((3, 7, 7)) * (np.random.default_rng(5).random((3, 7, 7)) < 0.5)
    options = api.SolveOptions(extra={"device": "cpu", "equalize": equalize})
    reports = api.solve_many(Ds, 2, 0.01, options=options)
    spans = mine.spans()
    (dispatch,) = [e for e in spans if e.name == "torch.dispatch"]
    at = spans.index(dispatch)
    stages = [e for e in spans if e.parent == at]
    assert [e.name for e in stages] == [n for n in STAGES if equalize or n != "e2e.equalize"]
    assert not any(e.name.startswith("e2e.") and e.parent != at for e in spans)
    for a, b in zip(stages, stages[1:]):
        assert a.end <= b.start
    assert dispatch.start <= stages[0].start and stages[-1].end <= dispatch.end
    assert sum(e.duration for e in stages) <= dispatch.duration
    dec = stages[0]
    assert dec.args == {"rounds": max(r.extras["k"] for r in reports), "device_loop": 0}
    if equalize:
        assert stages[2].args["iters"] >= 1 and set(stages[2].args) == {"iters"}
    # Nothing synchronizes on the CPU: no span carries a host-read count.
    assert not any("host_reads" in (e.args or {}) for e in spans)


def _annotations(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_spans_land_in_the_profiler_trace_as_user_annotations(tmp_path):
    t = get_tracer()
    Ds = np.random.default_rng(6).random((2, 5, 5))
    acts = [torch.profiler.ProfilerActivity.CPU]
    try:
        t.reset()
        t.enable()
        with torch.profiler.profile(activities=acts) as prof:
            api.solve_many(Ds, 2, 0.01, options=CPU)
        prof.export_chrome_trace(str(tmp_path / "on.json"))
        names = [e.name for e in t.spans()]
        assert set(STAGES) < set(names)
        got = _annotations(tmp_path / "on.json")
        assert sorted(n for n in got if n in set(names)) == sorted(names)
        t.disable()
        t.reset()
        with torch.profiler.profile(activities=acts) as prof:
            api.solve_many(Ds, 2, 0.01, options=CPU)
            assert t.span("e2e.decompose", device="cpu") is trace._NULL_SPAN
        prof.export_chrome_trace(str(tmp_path / "off.json"))
        assert not set(_annotations(tmp_path / "off.json")) & set(names)
        assert t.events == []
    finally:
        t.disable()
        t.reset()
    # A span opened with no profiler recording opens no range.
    mine = Tracer(enabled=True)
    with mine.span("alone"):
        assert not mine._hooks


def _stand_in_card(monkeypatch):
    """The sync-debug mode's switch, with a warning standing in for a read."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def _read(n=1):
    for _ in range(n):
        warnings.warn("called a synchronizing CUDA operation", UserWarning, stacklevel=2)


def test_count_host_reads_nests_and_restores_the_mode(monkeypatch):
    modes = _stand_in_card(monkeypatch)
    with count_host_reads("cpu") as cpu:
        _read()
    assert cpu == [None]
    with pytest.warns(UserWarning, match="not a read"):
        with count_host_reads("cuda") as outer:
            _read(2)
            with count_host_reads("cuda") as inner:
                _read(3)
                warnings.warn("not a read")
            with count_host_reads(torch.device("cuda", 0)) as second:
                pass
            _read()
    assert (outer, inner, second) == ([6], [3], [0])
    assert modes == ["default", "warn", "default"]
    with count_host_reads("cuda") as again:
        _read()
    assert again == [1] and modes[-1] == "default"


def test_span_on_a_card_carries_its_host_reads(monkeypatch):
    _stand_in_card(monkeypatch)
    t = Tracer(enabled=True)
    with t.span("torch.dispatch", {"B": 1}, device="cuda"):
        _read()
        for k in (2, 0):
            with t.span("stage", device="cuda"):
                _read(k)
        with t.span("untracked"):
            _read()
    with t.span("on the cpu", device="cpu"):
        _read()
    assert [(e.name, e.args) for e in t.spans()] == [
        ("torch.dispatch", {"B": 1, "host_reads": 4}), ("stage", {"host_reads": 2}), ("stage", {"host_reads": 0}),
        ("untracked", None), ("on the cpu", None),
    ]
    assert not t._hooks


# ----------------------------------------------------------------- fabric


def _schedules():
    for name, D in (("gpt", gpt3b_workload(rng=np.random.default_rng(3))),
                    ("moe", moe_workload(rng=np.random.default_rng(3)))):
        for s in (2, 4):
            yield name, D, spectra(D, s, 0.01).schedule, ref_spectra(D, s, 0.01).schedule


def _installed(sched, rng):
    """Each switch's first permutation (reused) or a random one, or None."""
    out = []
    for h, sw in enumerate(sched.switches):
        pick = h % 3
        out.append(sw.perms[0] if pick == 0 and sw.perms else (None if pick == 1 else rng.permutation(len(sw.perms[0]))))
    return out


def test_build_timeline_equals_reference():
    rng = np.random.default_rng(5)
    for _, _, mine, ref in _schedules():
        for installed in (None, _installed(ref, rng)):
            got, want = build_timeline(mine, installed=installed), ref_build_timeline(ref, installed=installed)
            assert got.finish == want.finish and got.s == want.s and got.delta == want.delta
            np.testing.assert_array_equal(got.switch_finish, want.switch_finish)
            np.testing.assert_array_equal(got.reused_switches, want.reused_switches)
            assert got.reused_switches.any() == (installed is not None)
            np.testing.assert_array_equal(got.delta_time(), want.delta_time())
            assert len(got.windows) == len(want.windows)
            for g, w in zip(got.windows, want.windows):
                assert (g.switch, g.slot, g.alpha, g.start, g.end, g.reused) == (
                    w.switch, w.slot, w.alpha, w.start, w.end, w.reused)
                np.testing.assert_array_equal(g.perm, w.perm)


def test_simulate_equals_reference_with_and_without_installed():
    rng = np.random.default_rng(6)
    for name, D, mine, ref in _schedules():
        for installed in (None, _installed(ref, rng)):
            got, want = simulate(mine, D, installed=installed), ref_simulate(ref, D, installed=installed)
            assert (got.finish_time, got.demand_met, got.max_shortfall) == (
                want.finish_time, want.demand_met, want.max_shortfall)
            np.testing.assert_array_equal(got.served, want.served)
            np.testing.assert_array_equal(got.reused_switches, want.reused_switches)
            assert got.demand_met, name
        rep = api.solve(api.Problem(D, 4, 0.01), solver="spectra")
        assert simulate(rep, D).finish_time == pytest.approx(rep.makespan)
    with pytest.raises(TypeError):
        simulate(object(), np.eye(2))
    with pytest.raises(ValueError):
        build_timeline(mine, installed=[None])


def test_simulate_rejects_a_schedule_that_is_not_a_permutation_or_overruns():
    D = gpt3b_workload(rng=np.random.default_rng(8))
    sched = spectra(D, 2, 0.01).schedule
    sched.switches[0].perms[0] = np.zeros_like(sched.switches[0].perms[0])
    with pytest.raises(AssertionError, match="not a permutation"):
        simulate(sched, D)
    short = spectra(D, 2, 0.01).schedule
    with pytest.raises(AssertionError, match="claimed makespan"):
        simulate(short, D, expected_makespan=short.makespan() * 2)


def test_schedule_bytes_callable_and_legacy_kwargs_match_reference():
    rng = np.random.default_rng(9)
    demand = rng.random((8, 8)) * 1e9
    mine, ref = OCSFabric(4, 20e-6), RefFabric(4, 20e-6)
    res, cct = mine.schedule_bytes(demand)
    _, ref_cct = ref.schedule_bytes(demand)
    assert cct == ref_cct > 0 and res.validated
    res, cct = mine.schedule_bytes(demand, spectra)
    ref_res, ref_cct = ref.schedule_bytes(demand, ref_spectra)
    assert cct == ref_cct and res.makespan == ref_res.makespan
    res, cct = mine.schedule_bytes(demand, "spectra_pp", validate=False, compute_lb=False)
    ref_res, ref_cct = ref.schedule_bytes(demand, "spectra_pp", validate=False, compute_lb=False)
    assert cct == ref_cct and not res.validated and np.isnan(res.lower_bound)
    res, cct = mine.schedule_bytes(demand, "spectra_torch", device="cpu", validate_tol=1e-3)
    assert res.backend == "torch" and res.extras["device"] == "cpu" and cct > 0
    with pytest.raises(TypeError, match="not both"):
        mine.schedule_bytes(demand, options=api.SolveOptions(), validate=False)
    res, cct = mine.schedule_bytes(np.zeros((8, 8)), "rotor")
    assert cct == 0.0 and res.makespan == 0.0
