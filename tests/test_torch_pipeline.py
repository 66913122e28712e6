"""The port's pipeline stages against the reference's on the CPU.

The device stages (``torch_auction``, ``torch_refined``, ``torch``,
``torch_merge_aware``) run their plain PyTorch path here and are held to
the reference's ``jax_*`` stages: makespans to 1e-4 relative (the float32
ε-schedule ``pow`` may round 2 ulps apart in XLA and PyTorch). The host
stages and the slot-table helpers are copies and must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.api as ref_api  # noqa: E402
import repro.core.schedule_ir as ref_ir  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.core.schedule_ir as ir  # noqa: E402
from repro.core.decompose import decompose as ref_decompose  # noqa: E402
from repro.core.schedule import schedule_lpt as ref_schedule_lpt  # noqa: E402
from repro_torch.api.pipeline import DECOMPOSERS, EQUALIZERS, SCHEDULERS  # noqa: E402
from repro_torch.core.decompose import decompose  # noqa: E402
from repro_torch.core.schedule import schedule_lpt  # noqa: E402
from repro_torch.core.torchopt.decompose_torch import TorchDecomposition, to_decomposition  # noqa: E402
from repro_torch.core.torchopt.equalize_torch import equalize_torch  # noqa: E402
from repro_torch.traffic import gpt3b_workload  # noqa: E402

CPU = api.SolveOptions(extra={"device": "cpu"})
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrices():
    rng = np.random.default_rng(12)
    sparse = np.where(rng.random((12, 12)) < 0.4, rng.random((12, 12)), 0.0)
    return {"sparse12": sparse, "gpt32": gpt3b_workload(rng=np.random.default_rng(0))}


STAGE_PAIRS = [
    (dict(decompose="torch_auction"), dict(decompose="jax_auction")),
    (dict(decompose="torch_refined"), dict(decompose="jax_refined")),
    (dict(decompose="torch_auction", decompose_kwargs={"matcher": "auction_fr"}),
     dict(decompose="jax_auction", decompose_kwargs={"matcher": "auction_fr"})),
    (dict(equalize="torch"), dict(equalize="jax")),
    (dict(equalize="torch_merge_aware"), dict(equalize="jax_merge_aware")),
    (dict(decompose="torch_auction", schedule="lpt_local_search", equalize="torch"),
     dict(decompose="jax_auction", schedule="lpt_local_search", equalize="jax")),
]


@pytest.mark.parametrize("pair", range(len(STAGE_PAIRS)))
def test_device_stages_match_reference(pair):
    mine, ref = STAGE_PAIRS[pair]
    for name, D in _matrices().items():
        for s in (2, 4):
            got = api.Pipeline(**mine)(api.Problem(D, s, 0.01), CPU)
            want = ref_api.Pipeline(**ref)(ref_api.Problem(D, s, 0.01))
            assert got.backend == "torch" and want.backend == "jax"
            assert got.validated and want.validated
            assert abs(got.makespan - want.makespan) <= RTOL * want.makespan, (name, s, mine)
            assert got.lower_bound == want.lower_bound


def test_host_stages_match_reference():
    for D in _matrices().values():
        for stages in (dict(decompose="eclipse"), dict(schedule="lpt_local_search", equalize="merge_aware"),
                       dict(schedule="wrap", equalize="none")):
            got = api.Pipeline(**stages)(api.Problem(D, 3, 0.01))
            want = ref_api.Pipeline(**stages)(ref_api.Problem(D, 3, 0.01))
            assert got.backend == want.backend == "numpy"
            assert (got.makespan, got.num_configs, got.extras) == (want.makespan, want.num_configs, want.extras)


def test_stage_tables_are_the_reference_tables_under_the_port_names():
    for mine, ref in ((DECOMPOSERS, ref_api.DECOMPOSERS), (SCHEDULERS, ref_api.SCHEDULERS),
                      (EQUALIZERS, ref_api.EQUALIZERS)):
        assert sorted(mine) == sorted(n.replace("jax", "torch") for n in ref)


def test_device_stage_takes_its_device_from_kwargs_or_options():
    D = _matrices()["sparse12"]
    via_kw = api.Pipeline(decompose="torch_auction", decompose_kwargs={"device": "cpu"},
                          equalize="torch", equalize_kwargs={"device": "cpu"})(api.Problem(D, 2, 0.01))
    via_options = api.Pipeline(decompose="torch_auction", equalize="torch")(api.Problem(D, 2, 0.01), CPU)
    assert via_kw.makespan == via_options.makespan
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Pipeline(decompose="torch_auction")(api.Problem(D, 2, 0.01))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Pipeline(equalize="torch")(api.Problem(D, 2, 0.01))


def test_register_stage_errors_and_overwrite():
    problem = api.Problem(_matrices()["sparse12"], 2, 0.01)
    with pytest.raises(ValueError, match="unknown stage kind"):
        api.register_stage("bogus", "x", lambda *a, **k: None)
    with pytest.raises(ValueError, match="already registered"):
        api.register_stage("schedule", "lpt", lambda *a, **k: None)
    with pytest.raises(KeyError, match="unknown schedule stage"):
        api.Pipeline(schedule="no_such_stage")(problem)
    calls = []

    def spy(dec, problem, **kw):
        calls.append(kw)
        return schedule_lpt(dec, problem.s, problem.delta)

    try:
        api.register_stage("schedule", "spy_lpt", spy)
        with pytest.raises(ValueError):
            api.register_stage("schedule", "spy_lpt", spy)
        api.register_stage("schedule", "spy_lpt", spy, overwrite=True)
        rep = api.Pipeline(schedule="spy_lpt", schedule_kwargs={"tag": 1})(problem)
        assert calls == [{"tag": 1}]
        assert rep.makespan == api.Pipeline()(problem).makespan
        assert rep.extras["pipeline"] == "spectra → spy_lpt → standard"
    finally:
        SCHEDULERS.pop("spy_lpt", None)


def test_to_decomposition_drops_zero_rounds_and_reads_one_lane():
    perms = torch.arange(3).expand(2, 3, 3).clone()
    perms[1, 1] = torch.tensor([1, 2, 0])
    dec = TorchDecomposition(perms, torch.tensor([[0.5, 0.0, 0.2], [0.25, 0.75, 0.0]]),
                             torch.tensor([3, 2]), torch.tensor([True, True]), torch.tensor([0, 0]))
    one = to_decomposition(dec, lane=1)
    assert one.alphas == [0.25, 0.75] and [p.tolist() for p in one.perms] == [[0, 1, 2], [1, 2, 0]]
    assert one.perms[0].dtype == np.int64
    zero = to_decomposition(dec)
    assert zero.alphas == [0.5, pytest.approx(0.2)] and zero.k == 2


def test_equalize_torch_matches_reference_and_finishes_on_host():
    from repro.core.jaxopt.equalize_jax import equalize_jax

    D = _matrices()["gpt32"]
    for merge_aware in (False, True):
        for kw in ({}, {"extra_slots": 8}, {"max_iters": 3}):
            got = equalize_torch(schedule_lpt(decompose(D), 4, 0.01), merge_aware=merge_aware, device="cpu", **kw)
            want = equalize_jax(ref_schedule_lpt(ref_decompose(D), 4, 0.01), merge_aware=merge_aware, **kw)
            assert abs(got.makespan() - want.makespan()) <= RTOL * want.makespan(), (merge_aware, kw)
            assert got.num_configs() == want.num_configs()
            got.validate(D, tol=1e-4)
    empty = schedule_lpt(decompose(np.zeros((4, 4))), 2, 0.01)
    assert equalize_torch(empty, device="cpu") is empty


def test_equalize_torch_out_of_slots_is_finished_on_host(monkeypatch):
    """64 slots on one switch, one of them long, and no headroom: the device
    pass cannot split, so host EQUALIZE finishes, as in the reference."""
    from repro.core.jaxopt.equalize_jax import equalize_jax
    from repro.core.schedule import ParallelSchedule as RefParallel
    from repro.core.schedule import SwitchSchedule as RefSwitch
    from repro_torch.core.schedule import ParallelSchedule, SwitchSchedule

    import importlib

    # The package exports the function ``equalize_torch`` under the module's
    # name (as the reference's ``equalize_jax``), so ``import ... as`` would
    # bind the function; take the module from ``sys.modules``.
    eqt = importlib.import_module("repro_torch.core.torchopt.equalize_torch")

    host_calls = []
    real = eqt.equalize
    monkeypatch.setattr(eqt, "equalize", lambda *a, **k: host_calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(4)
    perms = [rng.permutation(6) for _ in range(64)]
    alphas = [100.0] + list(rng.random(63) + 0.1)
    got = equalize_torch(ParallelSchedule([SwitchSchedule(list(perms), list(alphas)), SwitchSchedule()], 0.01),
                         extra_slots=0, device="cpu")
    want = equalize_jax(RefParallel([RefSwitch(list(perms), list(alphas)), RefSwitch()], 0.01), extra_slots=0)
    assert host_calls == [1]
    assert got.switches[1].alphas and got.num_configs() == want.num_configs() > 64
    assert abs(got.makespan() - want.makespan()) <= RTOL * want.makespan()
    assert max(got.loads()) - min(got.loads()) <= 0.01 + 1e-6


def test_schedule_ir_helpers_match_reference():
    D = _matrices()["sparse12"]
    sched = schedule_lpt(decompose(D), 3, 0.01)
    ref_sched = ref_schedule_lpt(ref_decompose(D), 3, 0.01)
    for cap in (None, 40):
        ds, ref_ds = ir.schedule_to_ir(sched, 12, capacity=cap), ref_ir.schedule_to_ir(ref_sched, 12, capacity=cap)
        for a, b in zip(ds, ref_ds):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(ir.ir_loads(ds, 3), ref_ir.ir_loads(ref_ds, 3))
        assert ir.ir_makespan(ds, 3) == ref_ir.ir_makespan(ref_ds, 3) == sched.makespan()
        assert ir.ir_num_configs(ds) == ref_ir.ir_num_configs(ref_ds) == sched.num_configs()
        np.testing.assert_array_equal(ir.ir_coverage(ds), ref_ir.ir_coverage(ref_ds))
        assert ir.ir_to_schedule(ds, 3).makespan() == sched.makespan()
    with pytest.raises(ValueError):
        ir.schedule_to_ir(sched, 12, capacity=1)
