"""The port's scenario registry and runner against the reference's.

Every registered scenario's trace is equal bit for bit for the same seed;
``run_scenario``'s stateless pass and both online passes (the host
controller and the device scan on the plain CPU path) agree with the
reference's summaries on small variants.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.scenarios as ref  # noqa: E402
from repro.traffic.hlo_traffic import demand_from_collectives as ref_demand  # noqa: E402

import repro_torch.scenarios as port  # noqa: E402
from repro_torch.api import SolveOptions  # noqa: E402
from repro_torch.traffic.hlo_traffic import demand_from_collectives  # noqa: E402

CPU = SolveOptions(extra={"device": "cpu"})
TINY = dict(n=8, periods=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_registries_list_the_same_names():
    assert port.list_scenarios() == ref.list_scenarios()
    assert port.list_families() == ref.list_families()
    assert len(port.list_scenarios()) == 15


@pytest.mark.parametrize("name", ref.list_scenarios())
def test_every_scenario_trace_equal_bit_for_bit(name):
    got, want = port.make_trace(name), ref.make_trace(name)
    assert got.spec.n == want.spec.n and got.spec.periods == want.spec.periods
    np.testing.assert_array_equal(got.demands, want.demands)
    assert got.period_meta == want.period_meta
    np.testing.assert_array_equal(got.deltas, want.deltas)
    gu, gs, gd = got.normalized()
    wu, ws, wd = want.normalized()
    np.testing.assert_array_equal(gu, wu)
    assert (gs == ws or (np.isnan(gs) and np.isnan(ws))) and np.array_equal(gd, wd)
    assert port.get_scenario(name).description == ref.get_scenario(name).description


def test_overrides_schedules_and_seeds_as_reference():
    for kw in (dict(n=8, periods=3, noise=0.01), dict(seed=3, **TINY), dict(delta_schedule=(0.01, 0.03), **TINY)):
        for name in ("gpt", "sparsity_sweep", "serve_mixed"):
            got, want = port.make_trace(name, **kw), ref.make_trace(name, **kw)
            np.testing.assert_array_equal(got.demands, want.demands)
            assert got.period_meta == want.period_meta
    spec = port.get_scenario("benchmark").spec.replace(n=8, m=4)
    assert spec.params == {"m": 4} and spec.n == 8
    with pytest.raises(KeyError):
        port.make_trace("nope")
    with pytest.raises(ValueError, match="already registered"):
        port.register_scenario("gpt", spec)
    with pytest.raises(ValueError, match="delta_schedule"):
        port.make_trace("gpt", delta_schedule=(), **TINY)
    with pytest.raises(ValueError, match="byte-denominated"):
        port.make_trace("collective_ring", delta_schedule=(1e-5, 2e-5), **TINY).normalized()


@pytest.mark.parametrize("wire", [
    {"all-reduce": 4.0e9, "all-to-all": 1.0e9, "collective-permute": 0.5e9},
    {"reduce-scatter": 2.5e9, "ragged-all-to-all": 3.0e8, "send": 1.0},
])
def test_demand_from_collectives_equal(wire):
    for kw in (dict(n_chips=256), dict(n_chips=64, chips_per_rack=4, model_axis=8)):
        np.testing.assert_array_equal(demand_from_collectives(wire, **kw), ref_demand(wire, **kw))


def _assert_summaries_equal(got: dict, want: dict, rel: float):
    for key, w in want.items():
        if key in ("runtime_s", "online_runtime_s", "warnings", "warning_counts", "solver", "online_solver"):
            continue
        g = got[key]
        if isinstance(w, float):
            assert (np.isnan(g) and np.isnan(w)) or g == pytest.approx(w, rel=rel, abs=rel * 1e-3), key
        else:
            assert g == w, key


@pytest.mark.parametrize("name, kw", [("gpt", TINY), ("collective_ring", TINY), ("moe_phases", dict(n=8, periods=4))])
def test_run_scenario_host_stateless_and_online_equal_reference(name, kw):
    got = port.run_scenario(name, solver="spectra", online=True, simulate=True, quality_ref="spectra_pp", **kw)
    want = ref.run_scenario(name, solver="spectra", online=True, simulate=True, quality_ref="spectra_pp", **kw)
    assert got.online_solver == want.online_solver == "host"
    _assert_summaries_equal(got.online_summary(), want.online_summary(), 1e-12)
    assert [p.demand_met for p in got.periods] == [p.demand_met for p in want.periods]
    assert [p.demand_met for p in got.online_periods] == [p.demand_met for p in want.online_periods]
    assert [p.warm for p in got.online_periods] == [p.warm for p in want.online_periods]
    np.testing.assert_allclose(got.cct_s, want.cct_s, rtol=1e-12)


def test_run_scenario_device_passes_equal_reference():
    """``spectra_torch`` on the CPU against ``spectra_jax``: the stateless
    pass and the scan's online pass (by the alias ``spectra_online_torch``)."""
    got = port.run_scenario("gpt", solver="spectra_online_torch", options=CPU, simulate=True, n=8, periods=4)
    want = ref.run_scenario("gpt", solver="spectra_online_jax", simulate=True, n=8, periods=4)
    assert got.solver == "spectra_torch" and got.online_solver == "scan"
    _assert_summaries_equal(got.online_summary(), want.online_summary(), 1e-4)
    assert got.reuse_counts.tolist() == want.reuse_counts.tolist()
    assert [p.warm for p in got.online_periods] == [p.warm for p in want.online_periods]
    assert all(p.demand_met for p in got.online_periods)
    assert (got.online_makespans <= got.makespans * (1 + 1e-6)).all()
    assert all(p.k is not None and p.cache_hit is not None for p in got.online_periods)


def test_run_scenario_delta_schedule_threads_through_online():
    kw = dict(n=8, periods=4, delta_schedule=(0.01, 0.03))
    got = port.run_scenario("gpt", solver="spectra", online=True, **kw)
    want = ref.run_scenario("gpt", solver="spectra", online=True, **kw)
    np.testing.assert_array_equal(got.deltas_units, [0.01, 0.03, 0.01, 0.03])
    np.testing.assert_allclose(got.online_makespans, want.online_makespans, rtol=1e-12)
    assert [p.delta_avoided for p in got.online_periods] == pytest.approx(
        [p.delta_avoided for p in want.online_periods])


def test_run_scenario_accepts_a_trace_and_rejects_overrides_on_it():
    tr = port.make_trace("uniform", **TINY)
    rep = port.run_scenario(tr, solver="spectra")
    assert rep.scenario == "trace[uniform]" and len(rep.periods) == 3
    with pytest.raises(TypeError):
        port.run_scenario(tr, n=4)


def test_unported_paths_raise_naming_the_module():
    """The runner's paths that once raised ``NotImplementedError`` naming a
    missing module (the test keeps its name from then): ``warning_counters``,
    ``attribution_summary``, ``summary()``'s warning keys and
    ``flowsim=True`` now equal the reference's."""
    for solver, ref_solver, rel in (("spectra", "spectra", 1e-12), ("spectra_torch", "spectra_jax", 1e-4)):
        opts = {"options": CPU} if solver == "spectra_torch" else {}
        got = port.run_scenario("gpt", solver=solver, online=True, flowsim=True, **opts, **TINY)
        want = ref.run_scenario("gpt", solver=ref_solver, online=True, flowsim=True, **TINY)
        assert got.warning_counters().export() == want.warning_counters().export()
        g, w = got.summary(), want.summary()
        assert g["warnings"] == w["warnings"] and ("warning_counts" in g) == ("warning_counts" in w)
        _assert_summaries_equal(g, w, rel)
        _assert_summaries_equal(got.attribution_summary(), want.attribution_summary(), rel)
        _assert_summaries_equal(got.flowsim_summary(), want.flowsim_summary(), rel)
    rep = port.run_scenario("gpt", solver="spectra", **TINY)
    assert rep.summary()["warnings"] == 0 and "warning_counts" not in rep.summary()
    assert rep.flowsim_reports == [] and "fct_p50" not in rep.summary()


def test_device_runner_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.run_scenario("gpt", solver="spectra_torch", online=True, **TINY)
