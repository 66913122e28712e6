"""The port's training loop, checkpoints and OCS tick, on the CPU.

The ports of ``tests/test_train_loop.py`` and ``tests/test_checkpoint.py``
(the same checks on the port), plus parity with the reference where both
compute on the host in float64: the OCS controller tick's ``cct_log`` and
the host ``spectra`` / ``spectra_no_eq`` solvers, bit for bit.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Problem as JaxProblem  # noqa: E402
from repro.api import solve as jax_solve  # noqa: E402
from repro.api.pipeline import Pipeline as JaxPipeline  # noqa: E402
from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.core.spectra import spectra as jax_spectra  # noqa: E402
from repro.data.pipeline import make_stream as jax_make_stream  # noqa: E402
from repro.fabric.ocs import OCSFabric as JaxOCSFabric  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.parallel.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.traffic.workloads import gpt3b_workload as jax_gpt3b_workload  # noqa: E402
from repro.train.loop import LoopConfig as JaxLoopConfig  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.api import Pipeline, Problem, solve  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.spectra import spectra  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.fabric import OCSFabric  # noqa: E402
from repro_torch.launch.train import make_trainer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel.steps import make_train_step  # noqa: E402
from repro_torch.traffic import gpt3b_workload  # noqa: E402
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.train.fault_tolerance import Heartbeat, fail_at  # noqa: E402
from repro_torch.train.loop import LoopConfig, SimulatedFailure, Trainer, _demand_from_stats  # noqa: E402
from repro_torch.train.optimizer import AdamW, cosine_schedule  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is about as fast, and
    does not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_setup(tmp_path=None, total_steps=24, arch="granite-3-8b"):
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(schedule=cosine_schedule(3e-3, total_steps), weight_decay=0.0)
    stream = make_stream(cfg.vocab_size, 32, 4, device="cpu")
    step = make_train_step(model, opt)
    loop_cfg = LoopConfig(total_steps=total_steps, ckpt_dir=str(tmp_path) if tmp_path else None, ckpt_every=8,
                          log_every=4)
    return model, opt, stream, step, loop_cfg


# ---------------------------------------------------------------------------
# The loop (port of tests/test_train_loop.py).
# ---------------------------------------------------------------------------

def test_loss_decreases():
    model, opt, stream, step, loop_cfg = tiny_setup(None)
    state = Trainer(model, opt, stream, step, loop_cfg, device="cpu").run(0)
    first, last = state.history[0]["loss"], state.history[-1]["loss"]
    assert last < first - 0.3, (first, last)
    # The model holds the trained weights themselves, not a second copy.
    own = dict(model.named_parameters())
    assert set(own) == set(state.params) and all(own[k] is state.params[k] for k in own)


def test_crash_restore_bit_identical(tmp_path):
    model, opt, stream, step, cfg_a = tiny_setup(tmp_path / "a")
    ref = Trainer(model, opt, stream, step, cfg_a, device="cpu").run(0)
    model, opt, stream, step, cfg_b = tiny_setup(tmp_path / "b")
    state = Trainer(model, opt, stream, step, cfg_b, failure_injector=fail_at({13, 19}), device="cpu").run(0)
    assert state.restarts == 2 and state.step == ref.step == 24
    assert set(ref.params) == set(state.params)
    for k in ref.params:
        assert torch.equal(ref.params[k], state.params[k]), k
    for k in ref.opt_state["mu"]:
        assert torch.equal(ref.opt_state["mu"][k], state.opt_state["mu"][k]), k
    # The replayed steps logged the same losses as the uninterrupted run.
    losses = {h["step"]: h["loss"] for h in ref.history}
    assert all(h["loss"] == losses[h["step"]] for h in state.history)


def test_restart_budget_enforced(tmp_path):
    model, opt, stream, step, cfg = tiny_setup(tmp_path, total_steps=12)
    cfg.max_restarts = 2

    def always_fail(step_i):
        if step_i == 3:
            raise SimulatedFailure("boom")

    with pytest.raises(SimulatedFailure):
        Trainer(model, opt, stream, step, cfg, failure_injector=always_fail, device="cpu").run(0)


def test_straggler_watchdog_counts():
    """A step slowed to 10× the slowest step so far (at least 1 s, the
    reference test's delay) is a straggler however busy the host is."""
    model, opt, stream, step, cfg = tiny_setup(None, total_steps=16)
    cfg.straggler_zscore = 3.0
    hits, walls = [], []

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        walls.append(time.perf_counter() - t0)
        return out

    def injector(step_i):
        if step_i == 12:
            time.sleep(max(1.0, 10 * max(walls)))  # simulated straggler

    state = Trainer(model, opt, stream, timed_step, cfg, failure_injector=injector,
                    remap_hook=lambda s, dt: hits.append((s, dt)), device="cpu").run(0)
    assert state.stragglers >= 1
    assert 12 in [h[0] for h in hits]


def test_trainer_checks_devices():
    model, opt, stream, step, cfg = tiny_setup(None)
    with pytest.raises(ValueError):
        Trainer(model, opt, stream, step, cfg, device="meta")


def test_heartbeat_marks_silent_worker():
    hb = Heartbeat(num_workers=2, timeout_s=0.05)
    hb.ping(0)
    hb.ping(1)
    time.sleep(0.1)
    hb.ping(1)
    dead = []
    hb.watch(dead.append, poll_s=0.01).join(timeout=5)
    assert dead == [{0}]


def test_fail_at_fires_once():
    inject = fail_at({2})
    inject(1)
    with pytest.raises(SimulatedFailure):
        inject(2)
    inject(2)


# ---------------------------------------------------------------------------
# The OCS controller tick against the reference's.
# ---------------------------------------------------------------------------

def test_ocs_tick_cct_log_equals_reference():
    """The DP-ring tick on the same loop config: the same schedule on the
    host, so every entry equals the reference's exactly."""
    steps = 4
    cfg_j = JAX_ARCHS["granite-3-8b"].reduced()
    jmodel = jax_build_model(cfg_j, attn_impl="chunked", ssd_impl="chunked")
    jopt = JaxAdamW(schedule=jax_cosine(3e-3, steps), weight_decay=0.0)
    jtr = JaxTrainer(jmodel, jopt, jax_make_stream(cfg_j.vocab_size, 16, 2),
                     jax.jit(jax_make_train_step(jmodel, jopt)),
                     JaxLoopConfig(total_steps=steps, ocs_every=2, ocs_num_racks=8),
                     fabric=JaxOCSFabric(num_switches=4, reconfig_delay_s=20e-6))
    want = jtr.run(jax.random.PRNGKey(0)).cct_log
    tr = make_trainer(ARCHS["granite-3-8b"].reduced(), steps=steps, batch=2, seq=16, lr=3e-3, ocs_switches=4,
                      ocs_delta_us=20.0, ocs_every=2, device="cpu")
    got = tr.run(0).cct_log
    assert len(got) == len(want) == 2
    assert got == want
    assert all(r["cct_s"] > 0 and r["makespan"] >= r["lb"] - 1e-9 for r in got)


def test_demand_from_stats_moe_branch():
    D = _demand_from_stats(4, {"expert_load": np.array([4.0, 0.0, 2.0, 2.0, 1.0])}, 0)
    assert D.shape == (4, 4) and np.all(np.diag(D) == 0) and D.max() > 0
    assert _demand_from_stats(4, {"expert_load": np.zeros(3)}, 0) is None


def _ring8():
    from repro_torch.traffic.collectives import Placement, TrafficModel

    tm = TrafficModel(Placement(8, 1))
    tm.ring_allreduce(list(range(8)), 1.0)
    return tm.demand_bytes


def _workload(name):
    """(D, s, delta): the gpt n = 32 workload, a random 10 × 10 matrix at
    half density (where α over every matched entry and merge-aware EQUALIZE
    change the schedule), or the 8-rack ring as the tick normalises it."""
    if name == "gpt":
        D = gpt3b_workload(rng=np.random.default_rng(0))
        np.testing.assert_array_equal(D, jax_gpt3b_workload(rng=np.random.default_rng(0)))
        return D, 4, 0.01
    if name == "sparse":
        rng = np.random.default_rng(1)
        return rng.random((10, 10)) * (rng.random((10, 10)) < 0.5), 3, 0.05
    D, unit_s = OCSFabric(4, 20e-6).normalize(_ring8() * 1e9)
    return D, 4, OCSFabric(4, 20e-6).delta_units(unit_s)


def _assert_same_schedule(got, want):
    assert len(got.switches) == len(want.switches)
    for sw_g, sw_w in zip(got.switches, want.switches):
        assert sw_g.alphas == sw_w.alphas
        assert all(np.array_equal(a, b) for a, b in zip(sw_g.perms, sw_w.perms))


@pytest.mark.parametrize("solver", ["spectra", "spectra_no_eq"])
@pytest.mark.parametrize("workload", ["gpt", "ring8"])
def test_host_spectra_equals_reference_bit_for_bit(solver, workload):
    D, s, delta = _workload(workload)
    want = jax_solve(JaxProblem(D, s, delta), solver=solver)
    got = solve(Problem(D, s, delta), solver=solver)
    assert got.validated and got.backend == "numpy"
    assert got.makespan == want.makespan
    assert got.lower_bound == want.lower_bound
    assert got.num_configs == want.num_configs
    _assert_same_schedule(got.schedule, want.schedule)


@pytest.mark.parametrize("stages", [
    dict(decompose_kwargs={"refine": "lp"}),
    dict(decompose_kwargs={"refine": "signed"}),
    dict(decompose_kwargs={"alpha_mode": "all_matched"}),
    dict(equalize="merge_aware"),
    dict(decompose_kwargs={"refine": "signed", "alpha_mode": "all_matched"}, equalize="merge_aware"),
], ids=["refine_lp", "refine_signed", "all_matched", "merge_aware", "signed_all_matched_merge_aware"])
@pytest.mark.parametrize("workload", ["gpt", "sparse", "ring8"])
def test_host_pipeline_options_equal_reference_bit_for_bit(stages, workload):
    """The host stages' other options (REFINE by LP or on signed residuals,
    α over every matched entry, merge-aware EQUALIZE) as the reference's."""
    D, s, delta = _workload(workload)
    want = JaxPipeline(**stages)(JaxProblem(D, s, delta))
    got = Pipeline(**stages)(Problem(D, s, delta))
    assert got.validated and got.makespan == want.makespan and got.num_configs == want.num_configs
    assert got.decomposition.alphas == want.decomposition.alphas
    _assert_same_schedule(got.schedule, want.schedule)


@pytest.mark.parametrize("kw", [{}, {"do_equalize": False}, {"merge_aware": True}], ids=["eq", "no_eq", "merge_aware"])
def test_core_spectra_equals_reference_bit_for_bit(kw):
    D, s, delta = _workload("sparse")
    want, got = jax_spectra(D, s, delta, **kw), spectra(D, s, delta, **kw)
    assert got.makespan == want.makespan and got.lower_bound == want.lower_bound
    _assert_same_schedule(got.schedule, want.schedule)


def test_schedule_bytes_zero_demand():
    res, cct = OCSFabric(4, 20e-6).schedule_bytes(np.zeros((8, 8)))
    assert cct == 0.0 and res.makespan == 0.0


# ---------------------------------------------------------------------------
# Checkpoints (port of tests/test_checkpoint.py).
# ---------------------------------------------------------------------------

def tree_example(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g), "b": torch.zeros((4,)),
                   "h": torch.randn((3, 5), generator=g).to(torch.bfloat16)},
        "opt": {"mu": torch.ones((8, 4)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    from repro_torch.train.checkpoint import _flatten

    return _flatten(tree)


def test_roundtrip_exact(tmp_path):
    t = tree_example()
    save_checkpoint(tmp_path, 5, t, extra={"step": 5})
    restored, extra = restore_checkpoint(tmp_path, t)
    assert extra["step"] == 5
    for (pa, a), (pb, b) in zip(_leaves(t), _leaves(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_bf16_round_trip_bit_for_bit(tmp_path):
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    t = {"x": bits.view(torch.bfloat16)}  # every bf16 bit pattern, NaNs included
    save_checkpoint(tmp_path, 1, t)
    manifest = json.loads((tmp_path / "step_000000001" / "manifest.json").read_text())
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    restored, _ = restore_checkpoint(tmp_path, t)
    assert restored["x"].dtype == torch.bfloat16
    assert torch.equal(restored["x"].view(torch.int16), bits)


def test_restore_takes_the_like_trees_types(tmp_path):
    t = tree_example()
    save_checkpoint(tmp_path, 1, t)
    like = {"params": {k: v.double() for k, v in t["params"].items()}, "opt": t["opt"]}
    restored, _ = restore_checkpoint(tmp_path, like)
    assert restored["params"]["w"].dtype == torch.float64
    assert torch.equal(restored["params"]["w"], t["params"]["w"].double())


def test_latest_and_gc(tmp_path):
    t = tree_example()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, t, keep=2)
    assert latest_step(tmp_path) == 5
    assert len(sorted(p.name for p in tmp_path.glob("step_*"))) == 2  # GC keeps the last 2


def test_async_save(tmp_path):
    t = tree_example()
    th = save_checkpoint(tmp_path, 9, t, async_=True)
    assert isinstance(th, threading.Thread)
    th.join(timeout=30)
    assert latest_step(tmp_path) == 9


def test_uncommitted_checkpoint_ignored(tmp_path):
    t = tree_example()
    save_checkpoint(tmp_path, 3, t)
    broken = tmp_path / "step_000000009"  # a crash mid-write: no committed marker
    broken.mkdir()
    (broken / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 3


def test_crc_detects_corruption(tmp_path):
    t = tree_example()
    save_checkpoint(tmp_path, 1, t)
    d = tmp_path / "step_000000001"
    manifest = json.loads((d / "manifest.json").read_text())
    victim = d / next(r["file"] for r in manifest["leaves"] if r["dtype"] == "float32")
    arr = np.load(victim)
    arr.reshape(-1)[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError, match="crc"):
        restore_checkpoint(tmp_path, t)


def test_structure_mismatch_raises(tmp_path):
    t = tree_example()
    save_checkpoint(tmp_path, 1, t)
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, {"params": {"w": torch.zeros((8, 4))}})
    renamed = {"params": {**t["params"], "v": t["params"]["w"]}, "opt": t["opt"]}
    del renamed["params"]["w"]
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, renamed)


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, tree_example())
