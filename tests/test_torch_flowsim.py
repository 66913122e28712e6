"""The port's flow-level simulator (``repro_torch.flowsim``) against the
reference's ``repro.flowsim`` on the same schedules and demands.

Host schedules from each package's own solvers (``spectra``, ``rotor``,
``rotor_vlb``: equal to the reference's bit for bit) replay to the same
per-flow completion times, deliveries, indirect fractions and finish, to
1e-12; with a carried ``installed`` state, staggered (``"uniform"``)
arrivals and finite VLB buffers too. ``run_scenario(..., flowsim=True)``
gives the reference's ``flowsim_summary()``; a ``spectra_torch`` report from
the plain CPU path (backend ``"torch"``) resolves the float32 tolerance,
1e-4, and agrees with ``spectra_jax``'s to 1e-4.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.api as ref_api  # noqa: E402
import repro.flowsim as ref_fs  # noqa: E402
import repro.scenarios as ref_sc  # noqa: E402
from repro.traffic.workloads import gpt3b_workload as ref_gpt  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.flowsim as fs  # noqa: E402
import repro_torch.scenarios as sc  # noqa: E402
from repro_torch.fabric import simulate  # noqa: E402
from repro_torch.traffic import gpt3b_workload, moe_workload  # noqa: E402

NO_LB = dict(compute_lb=False)
CPU = api.SolveOptions(extra={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _uniform(n: int) -> np.ndarray:
    D = np.ones((n, n))
    np.fill_diagonal(D, 0.0)
    return D


TRAFFIC = {
    "gpt": lambda: gpt3b_workload(noise=0.003, rng=np.random.default_rng(0), tp=4, pp=2, dp=1),
    "moe": lambda: moe_workload(n=16, rng=np.random.default_rng(1)),
    "uniform": lambda: _uniform(8),
}

VARIANTS = {
    "plain": (dict(), False),
    "installed": (dict(), True),
    "uniform_arrivals": (dict(arrival="uniform", arrival_seed=7, line_rate=1.5), False),
    "finite_buffer": (dict(buffer_limit=0.05), False),
}


def _solve_both(D, solver):
    mine = api.solve(api.Problem(D, 4, 0.01), solver=solver, options=api.SolveOptions(**NO_LB))
    ref = ref_api.solve(ref_api.Problem(D, 4, 0.01), solver=solver, options=ref_api.SolveOptions(**NO_LB))
    assert mine.makespan == ref.makespan
    return mine, ref


def _installed(sched, rng):
    """Even switches keep their first configuration up; odd ones a random
    permutation or nothing."""
    out = []
    for h, sw in enumerate(sched.switches):
        if h % 2 == 0 and sw.perms:
            out.append(np.asarray(sw.perms[0]))
        else:
            out.append(rng.permutation(len(sw.perms[0])) if h % 4 == 1 and sw.perms else None)
    return out


def _assert_reports_equal(got, want, tol):
    np.testing.assert_allclose(got.fct, want.fct, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.delivered, want.delivered, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.flow_src, want.flow_src)
    np.testing.assert_array_equal(got.flow_dst, want.flow_dst)
    np.testing.assert_allclose(got.flow_size, want.flow_size, rtol=tol, atol=tol)
    assert got.finish_time == pytest.approx(want.finish_time, rel=tol, abs=tol)
    assert got.indirect_fraction == pytest.approx(want.indirect_fraction, rel=tol, abs=tol)
    assert (got.conserved, got.port_ok, got.completed) == (want.conserved, want.port_ok, want.completed)
    np.testing.assert_allclose(got.utilization, want.utilization, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.delta_fraction, want.delta_fraction, rtol=tol, atol=tol)
    assert got.extras["vlb"] == want.extras["vlb"] and got.extras["windows"] == want.extras["windows"]
    for key, w in want.summary().items():
        g = got.summary()[key]
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), key
        else:
            assert g == pytest.approx(w, rel=tol, abs=tol), key


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("traffic", list(TRAFFIC))
@pytest.mark.parametrize("solver", ["spectra", "rotor", "rotor_vlb"])
def test_simulate_flows_equals_reference(solver, traffic, variant):
    D = TRAFFIC[traffic]()
    mine, ref = _solve_both(D, solver)
    params, with_installed = VARIANTS[variant]
    installed = _installed(ref.schedule, np.random.default_rng(3)) if with_installed else None
    got = fs.simulate_flows(mine, D, options=fs.FlowSimOptions(**params), installed=installed)
    want = ref_fs.simulate_flows(ref, D, options=ref_fs.FlowSimOptions(**params), installed=installed)
    _assert_reports_equal(got, want, 1e-12)
    if variant == "uniform_arrivals":
        np.testing.assert_array_equal(got.extras["releases"], want.extras["releases"])
    if variant == "plain":
        assert got.conserved and (got.fct <= got.finish_time + 1e-9).all()
        if solver != "rotor_vlb":
            # No indirection: the flow replay ends when the matrix replay does.
            assert got.finish_time == pytest.approx(simulate(mine, D).finish_time, abs=1e-12)


def test_simulate_flows_all_zero_and_single_flow_as_reference():
    for D in (np.zeros((4, 4)), np.diag([0.0, 0.5, 0.0, 0.0])):
        mine, ref = _solve_both(D, "spectra")
        got, want = fs.simulate_flows(mine, D), ref_fs.simulate_flows(ref, D)
        assert got.num_flows == want.num_flows and got.cct == want.cct and got.conserved == want.conserved
        _assert_reports_equal(got, want, 1e-12)


def test_resolve_tol_follows_the_ports_backends():
    """Device schedules carry backend "torch" and resolve to 1e-4 (as
    ``SolveOptions.tol`` does); host ones to 1e-9. A copy keyed on "jax"
    would hold the float32 device schedule to 1e-9."""
    D = TRAFFIC["gpt"]()
    dev = api.solve_many([D], 4, 0.01, solver="spectra_torch", options=CPU)[0]
    host = api.solve(api.Problem(D, 4, 0.01), solver="spectra")
    opts = fs.FlowSimOptions()
    assert dev.backend == "torch" and opts.resolve_tol(dev) == 1e-4 == api.SolveOptions().tol("torch")
    assert opts.resolve_tol(host) == 1e-9 and opts.resolve_tol(object()) == 1e-9
    assert fs.FlowSimOptions(tol=1e-3).resolve_tol(dev) == 1e-3
    r = fs.simulate_flows(dev, D)
    assert r.conserved and r.completed == r.num_flows
    assert r.finish_time == pytest.approx(simulate(dev, D, tol=1e-4).finish_time, abs=1e-12)


def test_options_stats_flows_buffers_and_vlb_equal_reference():
    for bad in (dict(line_rate=0), dict(tol=-1.0), dict(buffer_limit=-1), dict(indirection="x"),
                dict(arrival="poisson"), dict(arrival_span=-0.1)):
        with pytest.raises(ValueError):
            fs.FlowSimOptions(**bad)
        with pytest.raises(ValueError):
            ref_fs.FlowSimOptions(**bad)
    assert fs.FlowSimOptions.from_params({"indirection": "none"}).indirection == "none"
    sample = np.array([0.3, np.inf, 0.1, 0.2, 0.9, np.nan])
    assert vars(fs.FlowStats.from_sample(sample)) == vars(ref_fs.FlowStats.from_sample(sample))
    assert math.isnan(fs.FlowStats.from_sample(np.array([np.inf])).p50)
    D = ref_gpt(noise=0.003, rng=np.random.default_rng(2), tp=4, pp=2, dp=1)
    D[3, 3] = 0.25
    got, want = fs.flows_from_demand(D), ref_fs.flows_from_demand(D)
    assert [vars(f) for f in got] == [vars(f) for f in want] and any(f.src == f.dst for f in got)
    for limit in (np.inf, 0.3):
        gb, wb = fs.FabricBuffers(D, buffer_limit=limit), ref_fs.FabricBuffers(D, buffer_limit=limit)
        for b in (gb, wb):
            b.take_direct(0, 1, 0.05)
            b.stage_arrival(2, 0, 5, 0.2)
        for a, c in ((0, 2), (1, 3), (0, 1)):
            assert fs.vlb_injections(gb, a, c, 0.4) == ref_fs.vlb_injections(wb, a, c, 0.4)
        assert gb.relay_queue(2, 5) == wb.relay_queue(2, 5) == {}
        gb.commit()
        wb.commit()
        assert gb.relay_queue(2, 5) == wb.relay_queue(2, 5)
        assert gb.take_relay(2, 5, 0, 0.15) == wb.take_relay(2, 5, 0, 0.15)
        assert (gb.free_space(2), gb.buffered_total(), gb.direct_total()) == (
            wb.free_space(2), wb.buffered_total(), wb.direct_total())


def _summaries_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "solver":
            continue
        if isinstance(w, float):
            assert (math.isnan(g) and math.isnan(w)) or g == pytest.approx(w, rel=rel, abs=rel * 1e-3), key
        else:
            assert g == w, key


@pytest.mark.parametrize("name", ["gpt", "moe", "uniform"])
def test_run_scenario_flowsim_host_equals_reference(name):
    kw = dict(n=8, periods=3)
    got = sc.run_scenario(name, solver="spectra", flowsim=True, **kw)
    want = ref_sc.run_scenario(name, solver="spectra", flowsim=True, **kw)
    _summaries_close(got.flowsim_summary(), want.flowsim_summary(), 1e-12)
    np.testing.assert_allclose(got.fct_all, want.fct_all, rtol=1e-12)
    assert len(got.flowsim_reports) == 3 and got.flowsim_options == fs.FlowSimOptions()
    row, ref_row = got.summary(), want.summary()
    assert row["conserved"] and row["warnings"] == ref_row["warnings"] == 0
    assert (row["fct_p50"], row["fct_p99"]) == pytest.approx((ref_row["fct_p50"], ref_row["fct_p99"]), rel=1e-12)


@pytest.mark.parametrize("name", ["gpt", "moe"])
def test_run_scenario_flowsim_device_equals_reference(name):
    kw = dict(n=8, periods=3)
    got = sc.run_scenario(name, solver="spectra_torch", flowsim=True, options=CPU, **kw)
    want = ref_sc.run_scenario(name, solver="spectra_jax", flowsim=True, **kw)
    _summaries_close(got.flowsim_summary(), want.flowsim_summary(), 1e-4)
    assert got.flowsim_summary()["conserved"]


def test_run_scenario_flowsim_off_by_default_and_spec_params():
    rep = sc.run_scenario("uniform", solver="spectra", n=8, periods=2)
    assert rep.flowsim_reports == [] and rep.flowsim_options is None and rep.fct_all.size == 0
    assert "fct_p50" not in rep.summary()
    with pytest.raises(ValueError, match="flowsim=True"):
        rep.flowsim_summary()
    trace = sc.make_trace("uniform", n=8, periods=1, flowsim_params={"indirection": "none"})
    rep = sc.run_scenario(trace, solver="rotor_vlb", flowsim=True)
    assert rep.flowsim_options.indirection == "none" and not rep.flowsim_reports[0].extras["vlb"]
    rep = sc.run_scenario("uniform", solver="rotor_vlb", flowsim=True, n=8, periods=1,
                          flowsim_options=fs.FlowSimOptions(buffer_limit=1.0))
    assert rep.flowsim_options.buffer_limit == 1.0 and rep.flowsim_reports[0].extras["vlb"]
