"""The port's host solvers against the reference's: the §V comparison
algorithms (``core/baselines.py``), SPECTRA++ (``core/improved.py``) and
every registered host solver, on the same numpy inputs.

The port's copies keep the reference's float64 operation order, so the
results are equal, not just close: permutations equal, weights within
1e-12 absolute (the tolerance stated for α), report numbers equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.api as ref_api  # noqa: E402
import repro.core.baselines as ref_baselines  # noqa: E402
import repro.core.improved as ref_improved  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.core.baselines as baselines  # noqa: E402
import repro_torch.core.improved as improved  # noqa: E402
from repro.core.decompose import decompose as ref_decompose  # noqa: E402
from repro.core.schedule import schedule_lpt as ref_schedule_lpt  # noqa: E402
from repro_torch.core.decompose import decompose  # noqa: E402
from repro_torch.core.schedule import schedule_lpt  # noqa: E402
from repro_torch.traffic import WORKLOADS  # noqa: E402

ALPHA_TOL = 1e-12
CPU = api.SolveOptions(extra={"device": "cpu"})

# Fig. 2's worked example.
FIG2 = np.array([
    [0.60, 0.30, 0.00, 0.10],
    [0.00, 0.61, 0.39, 0.00],
    [0.00, 0.09, 0.61, 0.30],
    [0.40, 0.00, 0.00, 0.60],
])


def _matrix(name: str) -> np.ndarray:
    if name == "fig2":
        return FIG2
    return WORKLOADS[name](rng=np.random.default_rng(7))


MATRICES = ["fig2", "gpt", "moe", "benchmark"]  # n = 4, 32, 64, 100
DELTAS = [1e-3, 1e-2]  # two of benchmarks/common.py's grid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_perms_alphas(got_perms, got_alphas, want_perms, want_alphas):
    assert len(got_perms) == len(want_perms)
    for g, w in zip(got_perms, want_perms):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_allclose(got_alphas, want_alphas, rtol=0, atol=ALPHA_TOL)


def assert_same_schedule(got, want):
    assert got.s == want.s and got.delta == want.delta
    for g, w in zip(got.switches, want.switches):
        assert_perms_alphas(g.perms, g.alphas, w.perms, w.alphas)


@pytest.mark.parametrize("name", MATRICES)
def test_less_split_and_baseline_less_match_reference(name):
    D = _matrix(name)
    for s in (2, 4):
        for got, want in zip(baselines.less_split(D, s), ref_baselines.less_split(D, s)):
            np.testing.assert_allclose(got, want, rtol=0, atol=ALPHA_TOL)
        for delta in DELTAS:
            assert_same_schedule(baselines.baseline_less(D, s, delta), ref_baselines.baseline_less(D, s, delta))


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("delta", DELTAS)
def test_eclipse_decompose_matches_reference(name, delta):
    D = _matrix(name)
    got = baselines.eclipse_decompose(D, delta)
    want = ref_baselines.eclipse_decompose(D, delta)
    assert_perms_alphas(got.perms, got.alphas, want.perms, want.alphas)


@pytest.mark.parametrize("n", [4, 32, 100])
def test_rotor_schedule_matches_reference(n):
    for s in (2, 4):
        for kw in ({}, {"cycles": 3, "include_identity": True}):
            got = baselines.rotor_schedule(n, s, 0.01, 0.25, **kw)
            assert_same_schedule(got, ref_baselines.rotor_schedule(n, s, 0.01, 0.25, **kw))
            assert got.makespan() == pytest.approx(max(len(o) for o in baselines.rotor_offsets(
                n, s, include_identity=kw.get("include_identity", False))) * kw.get("cycles", 1) * 0.26)
    with pytest.raises(ValueError):
        baselines.rotor_offsets(1, 2)
    with pytest.raises(ValueError):
        baselines.rotor_schedule(4, 2, 0.01, -1.0)


@pytest.mark.parametrize("name", MATRICES)
def test_local_search_and_wrap_match_reference(name):
    D = _matrix(name)
    dec, ref_dec = decompose(D), ref_decompose(D)
    for s in (2, 4):
        for delta in DELTAS:
            got = improved.local_search(schedule_lpt(dec, s, delta))
            assert_same_schedule(got, ref_improved.local_search(ref_schedule_lpt(ref_dec, s, delta)))
            got = improved.schedule_wrap(dec, s, delta)
            assert_same_schedule(got, ref_improved.schedule_wrap(ref_dec, s, delta))
            assert got.makespan() <= schedule_lpt(dec, s, delta).makespan() + delta + 1e-12


@pytest.mark.parametrize("name", MATRICES)
def test_spectra_pp_matches_reference(name):
    D = _matrix(name)
    for s in (2, 4):
        for delta in DELTAS:
            got = improved.spectra_pp(D, s, delta)
            want = ref_improved.spectra_pp(D, s, delta)
            assert_same_schedule(got.schedule, want.schedule)
            assert_perms_alphas(got.decomposition.perms, got.decomposition.alphas,
                                want.decomposition.perms, want.decomposition.alphas)
            assert got.makespan == want.makespan and got.lower_bound == want.lower_bound


HOST_SOLVERS = ["baseline_less", "rotor", "rotor_vlb", "spectra", "spectra_eclipse", "spectra_no_eq", "spectra_pp"]


@pytest.mark.parametrize("name", MATRICES)
def test_every_host_solver_report_matches_reference(name):
    D = _matrix(name)
    for s in (2, 4):
        for solver in HOST_SOLVERS:
            got = api.solve(api.Problem(D, s, DELTAS[1]), solver=solver)
            want = ref_api.solve(ref_api.Problem(D, s, DELTAS[1]), solver=solver)
            assert (got.solver, got.backend) == (want.solver, want.backend) == (solver, "numpy")
            assert got.makespan == want.makespan, solver
            assert got.num_configs == want.num_configs, solver
            assert got.lower_bound == want.lower_bound, solver
            assert got.validated == want.validated == (solver != "rotor_vlb"), solver
            assert got.extras == want.extras, solver
            assert_same_schedule(got.schedule, want.schedule)


def test_rotor_extras_options_match_reference():
    D = _matrix("gpt")
    for solver, extra in (("rotor", {"rotor_cycles": 3}), ("rotor_vlb", {"rotor_cycles": 1, "rotor_safety_cycles": 2})):
        got = api.solve(api.Problem(D, 4, 0.01), solver=solver, options=api.SolveOptions(extra=extra))
        want = ref_api.solve(ref_api.Problem(D, 4, 0.01), solver=solver, options=ref_api.SolveOptions(extra=extra))
        assert got.makespan == want.makespan and got.extras == want.extras
    zero = api.solve(api.Problem(np.zeros((5, 5)), 2, 0.01), solver="rotor")
    assert zero.makespan == 0.0 and zero.num_configs == 0


def test_list_solvers_is_the_reference_list_with_spectra_torch():
    """The reference's built-in list, read in a fresh process: in this one,
    other test files may have registered more (``repro.online`` adds its
    solvers on import; tests add their own)."""
    probe = "import json; from repro.api import list_solvers; print(json.dumps(list_solvers()))"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    builtin = json.loads(out.stdout.strip().splitlines()[-1])
    assert "spectra_jax" in builtin
    assert api.list_solvers() == sorted("spectra_torch" if n == "spectra_jax" else n for n in builtin)


def test_fig2_through_every_solver_and_solve_all():
    problem = api.Problem(FIG2, 2, 0.01)
    reports = api.solve_all(problem, options=CPU)
    assert sorted(reports) == api.list_solvers()
    assert reports["spectra"].makespan == pytest.approx(0.53, abs=5e-5)
    assert reports["spectra_torch"].backend == "torch"
    assert reports["spectra_torch"].makespan == pytest.approx(reports["spectra"].makespan, rel=1e-4)
    assert reports["spectra_pp"].makespan <= reports["spectra"].makespan + 1e-12
    some = api.solve_all(problem, solvers=["rotor", "spectra_eclipse"])
    assert list(some) == ["rotor", "spectra_eclipse"]
    assert some["spectra_eclipse"].extras["pipeline"] == "eclipse → lpt → standard"


def test_solve_many_host_solver_in_worker_processes(monkeypatch):
    """``processes=2`` fans the host solver out over a pool and returns the
    serial results in order. The test process has run JAX, so its pool
    starts from a forkserver rather than forking this process."""
    import repro_torch.api.batch as batch

    assert batch._start_method() == ("fork" if not torch.cuda.is_initialized() else "forkserver")
    monkeypatch.setattr(batch, "_start_method", lambda: "forkserver")
    rng = np.random.default_rng(3)
    Ds = rng.random((3, 6, 6)) * (rng.random((3, 6, 6)) < 0.6)
    serial = api.solve_many(Ds, 2, [0.01, 0.02, 0.03], solver="spectra_pp")
    pooled = api.solve_many(Ds, 2, [0.01, 0.02, 0.03], solver="spectra_pp", processes=2)
    for a, b in zip(serial, pooled):
        assert a.makespan == b.makespan and a.num_configs == b.num_configs
        assert_same_schedule(a.schedule, b.schedule)
