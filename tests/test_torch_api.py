"""The port's solver API on the CPU: buckets, reports, collect, host finish."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    Problem,
    SolveOptions,
    dispatch_many_torch,
    list_solvers,
    solve,
    solve_many,
)

CPU = SolveOptions(extra={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sparse_demand(rng, n, density=0.5):
    D = rng.random((n, n)) * (rng.random((n, n)) < density)
    if not (D > 0).any():
        D[rng.integers(n), rng.integers(n)] = 0.5
    return D


def test_ragged_buckets_return_in_submission_order(monkeypatch):
    import repro_torch.api.batch as batch

    calls = []
    real = batch.solve_many_torch

    def counting(Ds, *a, **kw):
        calls.append(tuple(Ds.shape))
        return real(Ds, *a, **kw)

    monkeypatch.setattr(batch, "solve_many_torch", counting)
    rng = np.random.default_rng(0)
    mats = [sparse_demand(rng, n) for n in (8, 12, 8, 5)]
    deltas = [0.01, 0.02, 0.03, 0.04]
    reports = solve_many(mats, 3, deltas, options=CPU)
    assert sorted(calls) == [(1, 5, 5), (1, 12, 12), (2, 8, 8)]
    for D, d, rep in zip(mats, deltas, reports):
        assert rep.schedule.delta == d
        assert rep.validated and rep.backend == "torch"
        rep.schedule.validate(D, tol=1e-4)
        assert rep.makespan >= rep.lower_bound * (1 - 1e-6)
        assert rep.extras["device"] == "cpu" and rep.extras["batched"]
        assert rep.decomposition.k == rep.extras["k"]


def test_solve_many_matches_single_solves():
    rng = np.random.default_rng(1)
    Ds = np.stack([sparse_demand(rng, 10) for _ in range(3)])
    batched = solve_many(Ds, 4, 0.01, options=CPU)
    for D, rep in zip(Ds, batched):
        one = solve(Problem(D, 4, 0.01), solver="spectra_torch", options=CPU)
        assert one.makespan == pytest.approx(rep.makespan, rel=1e-6)
        assert one.lower_bound == pytest.approx(rep.lower_bound, rel=1e-4)


def test_collect_is_idempotent_and_ready_on_cpu():
    rng = np.random.default_rng(2)
    pending = dispatch_many_torch(np.stack([sparse_demand(rng, 6) for _ in range(2)]), 2, 0.01, CPU)
    assert pending.ready and len(pending) == 2
    first = pending.collect()
    assert pending.collect() is first
    assert [r.extras["batch_size"] for r in first] == [2, 2]


def test_exhausted_equalize_finished_on_host():
    """``extra_slots=0`` forbids any device split; the backend flags it and
    host EQUALIZE finishes the schedule, matching the reference pipeline."""
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.api import Problem as RefProblem
    from repro.api import solve as ref_solve

    rng = np.random.default_rng(21)
    Ds = np.stack([sparse_demand(rng, 8, density=0.7) for _ in range(3)])
    s, delta = 3, 0.01
    reports = solve_many(Ds, s, delta, options=SolveOptions(extra={"device": "cpu", "extra_slots": 0}))
    assert any(rep.extras["eq_exhausted"] for rep in reports)
    for b, rep in enumerate(reports):
        host = ref_solve(RefProblem(Ds[b], s, delta), solver="spectra")
        assert abs(rep.makespan - host.makespan) / max(host.makespan, 1e-12) < 1e-4
        if rep.extras["eq_exhausted"]:
            assert rep.makespan <= rep.extras["device_makespan"] + 1e-9
            assert rep.num_configs == rep.schedule.num_configs()
            assert rep.extras["warnings"]


def test_registry_and_options():
    assert list_solvers() == ["spectra_torch"]
    with pytest.raises(KeyError):
        solve(Problem(np.eye(3), 2, 0.01), solver="spectra")
    with pytest.raises(ValueError):
        solve_many(np.ones((2, 3, 3)), 2, [0.01], options=CPU)
    rep = solve_many([np.eye(4)], 2, 0.01, options=SolveOptions(validate=False, compute_lb=False, extra={"device": "cpu"}))[0]
    assert not rep.validated and np.isnan(rep.lower_bound)


@pytest.mark.parametrize("name", ["gpt", "moe", "benchmark"])
def test_traffic_copies_match_reference(name):
    pytest.importorskip("jax")
    from repro.traffic import workloads as ref_workloads
    from repro_torch.traffic import WORKLOADS

    mine = WORKLOADS[name](rng=np.random.default_rng(7))
    ref = ref_workloads.WORKLOADS[name](rng=np.random.default_rng(7))
    np.testing.assert_array_equal(mine, ref)


def test_permutations_copy_matches_reference_family():
    pytest.importorskip("jax")
    from repro.scenarios.library import _permutations_family
    from repro.scenarios.spec import TrafficSpec
    from repro_torch.traffic import permutations_workload

    spec = TrafficSpec(family="permutations", n=20, s=4, delta=0.01, params={"k": 5})
    ref, _ = _permutations_family(spec, 0, np.random.default_rng(3))
    np.testing.assert_array_equal(permutations_workload(n=20, k=5, rng=np.random.default_rng(3)), ref)
