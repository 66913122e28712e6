"""The port's ``obs`` metrics, timeline tables, attribution, HTML report and
dashboard against the reference's, on the same seeded inputs.

Host schedules agree to 1e-9 (the same float64 code); a device
``spectra_torch`` report from the plain CPU path must pass the attribution
identity at the float32 tolerance, 1e-4, which the port resolves from its
``"torch"`` backend.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as ref_obs  # noqa: E402
import repro.obs.html as ref_html  # noqa: E402
import repro.scenarios as ref_sc  # noqa: E402
from repro.core.spectra import spectra as ref_spectra  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
import repro_torch.obs.html as html  # noqa: E402
import repro_torch.scenarios as sc  # noqa: E402
from repro_torch.api import SolveOptions  # noqa: E402
from repro_torch.core.schedule import ParallelSchedule, SwitchSchedule  # noqa: E402
from repro_torch.core.spectra import spectra  # noqa: E402
from repro_torch.traffic import gpt3b_workload, moe_workload  # noqa: E402

# Each package's ``obs.timeline_table`` attribute turns into the function of
# that name once a lazy name of the package is read (``from repro.obs import
# timeline_table``, as the reference's tests do), so the modules come from
# ``importlib``.
tt = importlib.import_module("repro_torch.obs.timeline_table")
ref_tt = importlib.import_module("repro.obs.timeline_table")

CPU = SolveOptions(extra={"device": "cpu"})
TINY = dict(n=8, periods=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    if isinstance(want, float):
        if math.isnan(want):
            return math.isnan(got)
        return got == pytest.approx(want, rel=rel, abs=rel)
    return got == want


def _assert_rows_equal(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for key, w in want.items():
        assert _close(got[key], w, rel), (key, got[key], w)


# ----------------------------------------------------------------- metrics


@pytest.mark.parametrize("lo, hi, per_decade", [(1e-6, 100.0, 8), (1e-3, 10.0, 4)])
def test_latency_histogram_equals_reference(lo, hi, per_decade):
    rng = np.random.default_rng(per_decade)
    samples = np.concatenate([rng.lognormal(-5, 2, 500), [lo / 2, hi * 2, lo, hi]])
    got, want = obs.LatencyHistogram(lo, hi, per_decade), ref_obs.LatencyHistogram(lo, hi, per_decade)
    assert math.isnan(got.percentile(50)) and math.isnan(want.percentile(50))
    for x in samples:
        got.observe(x)
        want.observe(x)
    assert got.export() == want.export()
    for p in (0, 1, 25, 50, 75, 99, 100):
        assert got.percentile(p) == want.percentile(p)
    with pytest.raises(ValueError):
        obs.LatencyHistogram(1.0, 1.0)


def test_counters_and_serve_metrics_equal_reference():
    got, want = obs.Counters(), ref_obs.Counters()
    assert not got and got.total == 0
    for name, by in (("b", 2), ("a", 1), ("b", 3), ("c", 0)):
        got.inc(name, by)
        want.inc(name, by)
    assert got.export() == want.export() and got.total == want.total and got.get("b") == 5
    gm, wm = obs.ServeMetrics(), ref_obs.ServeMetrics()
    for verdict in ("ADMIT", "ADMIT", "DEGRADED", "SHED"):
        gm.count_verdict(verdict)
        wm.count_verdict(verdict)
    for m in (gm, wm):
        m.cache_hit_exact, m.cache_hit_support, m.cache_miss, m.batches, m.schedules = 2, 1, 3, 4, 6
        for stage, x in zip(obs.STAGES, (0.01, 0.2, 0.003, 0.5)):
            m.observe(stage, x)
    g, w = gm.export(), wm.export()
    for key in ("elapsed_s", "schedules_per_sec"):
        g.pop(key), w.pop(key)
    assert g == w and gm.cache_hit_rate == 0.5
    assert obs.STAGES == ref_obs.STAGES
    with pytest.raises(ValueError):
        gm.count_verdict("MAYBE")


class _Rep:
    def __init__(self, warnings):
        self.extras = {"warnings": warnings}


def test_warning_counts_equal_reference_and_bucket_the_ports_messages():
    msgs = [["device matcher 'auction' exhausted its iteration budget"],
            ["device EQUALIZE ran out of split headroom", "something else"], [], ["Matcher X"]]
    reps = [_Rep(m) for m in msgs] + [object()]
    got, want = obs.warning_counts(reps), ref_obs.warning_counts(reps)
    assert got.export() == want.export() == {
        "equalize_headroom_exhausted": 1, "matcher_budget_exhausted": 2, "other": 1}
    for m in sum(msgs, []):
        assert obs.warning_category(m) == ref_obs.warning_category(m)
    tracer = obs.get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        obs.warning_counts(reps)
        samples = {e.name: e.args["value"] for e in tracer.events if e.cat == "repro.counter"}
    finally:
        tracer.disable()
        tracer.reset()
    assert samples == {f"warnings.{k}": float(v) for k, v in want.export().items()}


# -------------------------------------------------------- timeline tables


def _as_port(sched) -> ParallelSchedule:
    return ParallelSchedule(
        switches=[SwitchSchedule(perms=[np.asarray(p) for p in sw.perms], alphas=[float(a) for a in sw.alphas])
                  for sw in sched.switches],
        delta=sched.delta,
    )


@pytest.mark.parametrize("workload, s, delta", [(gpt3b_workload, 2, 0.01), (moe_workload, 4, 0.05)])
def test_timeline_table_equals_reference_on_the_same_schedule(workload, s, delta):
    D = workload(rng=np.random.default_rng(s))
    ref = ref_spectra(D, s, delta).schedule
    mine = spectra(D, s, delta).schedule
    rng = np.random.default_rng(7)
    installed = [sw.perms[0] if h % 2 == 0 else rng.permutation(D.shape[0]) for h, sw in enumerate(ref.switches)]
    for sched in (mine, _as_port(ref)):
        for kw in ({}, {"installed": installed}, {"lower_bound": 0.5, "horizon": 1.25 * ref.makespan() + 0.1}):
            got, want = tt.timeline_table(sched, **kw), ref_tt.timeline_table(ref, **kw)
            assert got.horizon == want.horizon and got.delta == want.delta
            _assert_rows_equal(got.attribution.summary(), want.attribution.summary(), 1e-12)
            np.testing.assert_array_equal(got.utilization, want.utilization)
            assert got.per_round() == want.per_round()
            assert got.render_ascii(40) == want.render_ascii(40)
            for gr, wr in zip(got.rows, want.rows):
                assert gr.intervals == [tt.Interval(**vars(iv)) for iv in wr.intervals]
                assert (gr.serve_time, gr.reconf_time, gr.idle_time, gr.reused) == (
                    wr.serve_time, wr.reconf_time, wr.idle_time, wr.reused)
            got.attribution.check(1e-9)
    with pytest.raises(ValueError, match="shorter than the timeline"):
        tt.timeline_table(mine, horizon=0.5 * mine.makespan())
    cooked = tt.MakespanAttribution(s=4, makespan=1.0, transmission=3.0, delta_paid=0.5, idle=0.2)
    with pytest.raises(AssertionError, match="identity violated"):
        cooked.check(1e-9)


@pytest.mark.parametrize("name", ["gpt", "moe_phases", "collective_ring", "uniform"])
def test_attribute_scenario_host_online_equals_reference(name):
    kw = dict(n=8, periods=4)
    got = sc.run_scenario(name, solver="spectra", online=True, **kw)
    want = ref_sc.run_scenario(name, solver="spectra", online=True, **kw)
    ga, wa = tt.attribute_scenario(got), ref_tt.attribute_scenario(want)
    ga.check()
    assert ga.tol == wa.tol == 1e-9
    assert len(ga.online_tables) == len(wa.online_tables) == 4
    _assert_rows_equal(ga.summary(), wa.summary(), 1e-9)
    _assert_rows_equal(got.attribution_summary(), want.attribution_summary(), 1e-9)
    # The HTML report carries the same numbers: the same document.
    assert html.render_html(ga) == ref_html.render_html(wa)


def test_attribute_scenario_device_report_resolves_the_float32_tolerance():
    """A ``spectra_torch`` report (backend "torch") resolves to 1e-4, as
    ``SolveOptions.tol("torch")`` does; a copy keyed on "jax" would hold it
    to 1e-9 and fail."""
    got = sc.run_scenario("gpt", solver="spectra_torch", online=True, options=CPU, n=8, periods=4)
    want = ref_sc.run_scenario("gpt", solver="spectra_jax", online=True, n=8, periods=4)
    assert {r.backend for r in got.reports} == {"torch"}
    att = tt.attribute_scenario(got)
    assert att.tol == 1e-4 == SolveOptions().tol("torch")
    att.check()
    wa = ref_tt.attribute_scenario(want)
    g, w = att.summary(), wa.summary()
    for key in ("total_makespan", "transmission", "delta_paid", "transmission_share", "delta_share",
                "online_total_makespan", "online_delta_paid", "online_reuse_count", "periods"):
        assert _close(g[key], w[key], 1e-4), key
    assert got.attribution_summary()["max_identity_residual"] <= 1e-4
    # A device report held to the host tolerance is a different question.
    assert tt.attribute_scenario(got, tol=1e-3).tol == 1e-3


def test_render_and_save_html(tmp_path):
    rep = sc.run_scenario("gpt", solver="spectra", online=True, **TINY)
    att = tt.attribute_scenario(rep)
    doc = html.render_html(att, title="t <&>")
    assert doc.startswith("<!DOCTYPE html>") and "t &lt;&amp;&gt;" in doc
    assert doc.count('class="obs-card"') == 2 * 3 + 1
    assert doc.count("<tr>") == 1 + 2 * 3
    for s in range(rep.spec.s):
        assert f"ocs{s}" in doc
    path = html.save_html(att, tmp_path / "sub" / "r.html")
    assert path.read_text() == html.render_html(att)


def test_dashboard_runs_the_device_solver_on_the_cpu(tmp_path, capsys):
    from repro_torch.obs.dashboard import main

    out_html, out_trace = tmp_path / "moe.html", tmp_path / "trace.json"
    rc = main(["moe", "--n", "8", "--periods", "2", "--solver", "spectra_torch", "--device", "cpu",
               "--online", "--html", str(out_html), "--trace", str(out_trace), "--width", "40"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "moe · spectra_torch — 2 periods" in out and "online pass: reuse" in out
    text = out_html.read_text()
    assert "obs-root" in text and all(f"ocs{s}" in text for s in range(4))
    assert out_trace.read_text().startswith("{")
    obs.get_tracer().disable()
    obs.get_tracer().reset()


def test_dashboard_needs_cuda_without_device():
    from repro_torch.obs.dashboard import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["gpt", "--n", "8", "--periods", "2", "--solver", "spectra_torch"])
