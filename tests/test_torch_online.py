"""The port's online controller against the reference's, on the same inputs.

Covers the warm-price path through the matchers and DECOMPOSE, the host
``SwitchState`` / ``OnlineController`` (equal to the reference's to 1e-12:
the same float64 code), the device ``online_step`` / ``spectra_online_scan``
on the plain CPU path against ``online_step_jax`` / ``spectra_online_scan``
(decisions exact, makespans to 1e-4 relative) and both registry solvers.

Matcher parity is exact given the same ε schedule (the float32 ``pow``
forming it may round differently in XLA and PyTorch, see
``test_torch_matching.py``), so those tests hand the port the reference's ε.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

jm = importlib.import_module("repro.core.jaxopt.matching")
jd = importlib.import_module("repro.core.jaxopt.decompose_jax")
jo = importlib.import_module("repro.core.jaxopt.online_jax")
import repro.online as ref_online  # noqa: E402
from repro.api import Problem as RefProblem  # noqa: E402
from repro.api import SolveOptions as RefOptions  # noqa: E402
from repro.api import solve as ref_solve  # noqa: E402
from repro.scenarios import make_trace  # noqa: E402

import repro_torch.core.torchopt.matching as tm  # noqa: E402
import repro_torch.online as port_online  # noqa: E402
from repro_torch.api import Problem, SolveOptions, solve  # noqa: E402
from repro_torch.core.schedule_ir import DeviceSchedule  # noqa: E402
from repro_torch.core.torchopt.decompose_torch import decompose, decompose_prices  # noqa: E402
from repro_torch.core.torchopt.online_torch import (  # noqa: E402
    OnlineDeviceState,
    count_host_reads,
    online_initial_state,
    online_step,
    spectra_online_scan,
)
from repro_torch.kernels.auction_bid import auction_round_loop, auction_rounds, auction_rounds_ref  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bonus_weights(D):
    S = D > 0
    rd, cd = S.sum(1), S.sum(0)
    k = max(rd.max(), cd.max())
    M = np.maximum(D, 0).max(axis=1).sum() + 1.0
    bonus = M * ((rd == k)[:, None].astype(float) + (cd == k)[None, :])
    return (np.maximum(D, 0) + np.where(S, bonus, 0)).astype(np.float32)


def _ref_eps(W, P):
    """The reference's ε schedule for each lane of a (B, n, n) tensor."""
    return torch.stack([
        torch.from_numpy(np.array(jm._eps_schedule(jnp.asarray(w.numpy()), P))) for w in W
    ]).to(W.device)


def _warm_inputs(rng, B, n):
    """Bonus weights and the final prices of a matcher call on a perturbed
    copy: warm prices at the M-bonus scale, as a previous period leaves them."""
    Ws = np.stack([_bonus_weights(np.where(rng.random((n, n)) < 0.3, rng.random((n, n)), 0.0))
                   for _ in range(B)])
    W2 = (Ws * (1.0 + 0.01 * rng.standard_normal(Ws.shape))).astype(np.float32)
    p0 = tm.match_auction(torch.from_numpy(W2)).prices
    return Ws, p0


# ------------------------------------------------------------- warm prices

@pytest.mark.parametrize("n", [12, 37])
@pytest.mark.parametrize("reverse", [False, True])
def test_rounds_ref_and_loop_take_prices0_bit_for_bit(n, reverse):
    """``auction_rounds`` (its plain version on the CPU), ``auction_rounds_ref``
    and ``auction_round_loop`` agree bit for bit with ``prices0``, and
    ``prices0=None`` is a zeros ``prices0``."""
    Ws, p0 = _warm_inputs(np.random.default_rng(n), 2, n)
    W = torch.from_numpy(Ws)
    eps = tm._eps_schedule(W, tm.default_num_phases(n)).contiguous()
    mi = tm.default_max_iters(n)
    want = auction_rounds_ref(W, eps, mi, reverse=reverse, prices0=p0)
    cold = auction_rounds_ref(W, eps, mi, reverse=reverse)
    assert not torch.equal(want[2], cold[2])  # the warm start changed the run
    for got in (auction_rounds(W, eps, mi, reverse=reverse, prices0=p0),
                auction_round_loop(W, eps, mi, reverse=reverse, prices0=p0)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(auction_rounds_ref(W, eps, mi, reverse=reverse, prices0=torch.zeros_like(p0)), cold):
        assert torch.equal(g, w)


def test_rounds_reject_misshapen_prices0():
    W = torch.zeros((2, 4, 4))
    eps = torch.ones((2, 3))
    with pytest.raises(ValueError, match="prices0"):
        auction_rounds(W, eps, 10, reverse=False, prices0=torch.zeros((2, 5)))
    with pytest.raises(ValueError, match="prices0"):
        auction_rounds(W, eps, 10, reverse=False, prices0=torch.zeros((2, 4), dtype=torch.float64))


@pytest.mark.parametrize("matcher", ["auction", "auction_fr", "auction_fused"])
def test_warm_matchers_match_reference_given_same_eps(monkeypatch, matcher):
    """``prices0`` in, final prices out: perm, converged and prices equal the
    reference's ``with_prices=True`` path exactly (the fused matcher on the
    tail of the ε schedule, as the reference's)."""
    n = 24
    Ws, p0 = _warm_inputs(np.random.default_rng(7), 3, n)
    monkeypatch.setattr(tm, "_eps_schedule", _ref_eps)
    res = tm.MATCHERS[matcher](torch.from_numpy(Ws), prices0=p0)
    for b in range(3):
        perm, conv, prices = jm.MATCHERS[matcher](
            jnp.asarray(Ws[b]), prices0=jnp.asarray(p0[b].numpy()), with_prices=True
        )
        np.testing.assert_array_equal(res.perm[b].numpy(), np.asarray(perm))
        assert bool(res.converged[b]) == bool(conv)
        np.testing.assert_array_equal(res.prices[b].numpy(), np.asarray(prices))


def test_matchers_without_prices0_equal_zero_prices():
    n = 20
    Ws, _ = _warm_inputs(np.random.default_rng(3), 2, n)
    W = torch.from_numpy(Ws)
    for name in ("auction", "auction_fr"):
        for g, w in zip(tm.MATCHERS[name](W), tm.MATCHERS[name](W, prices0=torch.zeros((2, n)))):
            assert torch.equal(g, w)


@pytest.mark.parametrize("matcher", ["auction", "auction_fr", "auction_fused"])
@pytest.mark.parametrize("name, kw", [("benchmark", dict(m=4)), ("moe_phases", dict(phases=2))])
def test_decompose_carry_prices_matches_reference(monkeypatch, matcher, name, kw):
    """``decompose_prices`` against ``decompose_jax_prices`` over three
    periods at n = 16, the final prices carried from period to period:
    perms and k exact, alphas to 1e-6, prices to 1e-5 relative up to a
    common shift. (Where the reference itself turns on one ulp, see the
    next test.)"""
    monkeypatch.setattr(tm, "_eps_schedule", _ref_eps)
    tr = make_trace(name, n=16, periods=3, **kw)
    D = tr.demands.astype(np.float32)
    pj, pt = jnp.zeros(16), None
    for t in range(tr.T):
        dj, pj = jd.decompose_jax_prices(jnp.asarray(D[t]), pj, matcher=matcher)
        dt, pt = decompose_prices(torch.from_numpy(D[t:t + 1]), pt, matcher=matcher)
        k = int(dj.k)
        assert int(dt.k[0]) == k
        np.testing.assert_array_equal(dt.perms[0, :k].numpy(), np.asarray(dj.perms)[:k])
        np.testing.assert_allclose(dt.alphas[0].numpy(), np.asarray(dj.alphas), rtol=0, atol=1e-6)
        # Prices agree up to a common shift, which leaves every bid's
        # ranking, and so every matching, unchanged.
        shift = pt[0].numpy() - np.asarray(pj)
        assert np.ptp(shift) <= 1e-5 * np.abs(np.asarray(pj)).max()
    # Without the carry every round starts from zero prices: ``decompose``.
    plain = decompose(torch.from_numpy(D[:1]), matcher=matcher)
    ref_plain = jd.decompose_jax(jnp.asarray(D[0]), matcher=matcher)
    assert int(plain.k[0]) == int(ref_plain.k)


@pytest.mark.parametrize("name, kw, matcher", [
    ("moe", dict(tokens_per_gpu=512), "auction"),
    ("gpt", {}, "auction_fr"),
])
def test_warm_prices_divergence_is_the_references_own(monkeypatch, name, kw, matcher):
    """Carried prices amplify a one-ulp difference in the weights (the
    M-bonus sum, which the port takes in float64) into different matchings
    a few rounds later: on these traces a one-ulp change of one demand entry
    changes the reference's own warm-price decomposition, not its cold one.
    So the port is held to the reference on every matcher call instead,
    given the same weights, prices and ε, and to the carry's semantics
    (round 0 from ``prices0``, each later round from the previous round's
    final prices)."""
    tr = make_trace(name, n=16, periods=1, **kw)
    D = tr.demands[0].astype(np.float32)
    D2 = D.copy()
    D2[1, np.argmax(D[1])] = np.nextafter(D[1].max(), np.float32(np.inf))
    warm = [jd.decompose_jax_prices(jnp.asarray(x), jnp.zeros(16), matcher=matcher)[0] for x in (D, D2)]
    cold = [jd.decompose_jax(jnp.asarray(x), matcher=matcher) for x in (D, D2)]
    assert not np.array_equal(np.asarray(warm[0].perms), np.asarray(warm[1].perms))
    np.testing.assert_array_equal(np.asarray(cold[0].perms), np.asarray(cold[1].perms))

    calls = []
    real = tm.MATCHERS[matcher]

    def spy(W, prices0=None, **kw_):
        res = real(W, prices0=prices0, **kw_)
        calls.append((W.clone(), prices0.clone(), res))
        return res

    monkeypatch.setitem(tm.MATCHERS, matcher, spy)
    monkeypatch.setattr(tm, "_eps_schedule", _ref_eps)
    p0 = torch.full((1, 16), 0.5)
    _, final = decompose_prices(torch.from_numpy(tr.demands[:1].astype(np.float32)), p0, matcher=matcher)
    assert len(calls) >= 8
    assert torch.equal(calls[0][1], p0) and torch.equal(final, calls[-1][2].prices)
    for (W, prices0, res), nxt in zip(calls, calls[1:] + [None]):
        if nxt is not None:
            assert torch.equal(nxt[1], res.prices)
        perm, conv, prices = jm.MATCHERS[matcher](jnp.asarray(W[0].numpy()), prices0=jnp.asarray(prices0[0].numpy()),
                                                  with_prices=True)
        np.testing.assert_array_equal(res.perm[0].numpy(), np.asarray(perm))
        np.testing.assert_array_equal(res.prices[0].numpy(), np.asarray(prices))


# ---------------------------------------------------------------- host state

def _host_outcomes(mod, tr, cache_size):
    ctl = mod.OnlineController(s=tr.spec.s, delta=tr.spec.delta, cache_size=cache_size)
    return ctl, ctl.solve_trace(tr.demands)


@pytest.mark.parametrize("name, kw, cache_size", [
    ("gpt", dict(n=8, periods=4), 8),
    ("moe_phases", dict(n=16, periods=6, phases=2), 8),
    ("moe_phases", dict(n=16, periods=4, phases=2), 0),
])
def test_controller_and_switch_state_match_reference(name, kw, cache_size):
    tr = make_trace(name, **kw)
    ref_ctl, want = _host_outcomes(ref_online, tr, cache_size)
    ctl, got = _host_outcomes(port_online, tr, cache_size)
    for g, w in zip(got, want):
        for f in ("makespan", "stateless_makespan", "delta_paid", "delta_avoided"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12, abs=1e-12), f
        assert (g.reuse_count, g.warm, g.num_configs) == (w.reuse_count, w.warm, w.num_configs)
        np.testing.assert_array_equal(g.reused_switches, w.reused_switches)
        for gs, ws in zip(g.schedule.switches, w.schedule.switches):
            assert len(gs.perms) == len(ws.perms)
            for a, b in zip(gs.perms, ws.perms):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(gs.alphas, ws.alphas, rtol=1e-12, atol=1e-12)
    st, rs = ctl.state, ref_ctl.state
    assert st.installed_keys() == rs.installed_keys()
    assert st.fresh_ratio == pytest.approx(rs.fresh_ratio, rel=1e-12)
    assert st.fresh_gap == pytest.approx(rs.fresh_gap, rel=1e-12)
    assert list(st.support_cache) == list(rs.support_cache)
    if name == "moe_phases" and cache_size:
        assert [o.warm for o in got] == [False, False, True, True, True, True]


def test_state_helpers_match_reference():
    """``reuse_marks``, ``effective_makespan``, ``apply_reuse_order``,
    ``advance_installed`` and ``online_ir_to_schedule`` on the same schedule
    and carried state."""
    tr = make_trace("gpt", n=8, periods=2)
    ref_ctl, outs = _host_outcomes(ref_online, tr, 8)
    sched = outs[1].schedule
    ref_state = ref_ctl.state
    state = port_online.SwitchState(installed=list(ref_state.installed))
    from repro_torch.core.schedule import ParallelSchedule, SwitchSchedule

    port_sched = ParallelSchedule(
        switches=[SwitchSchedule(perms=list(sw.perms), alphas=list(sw.alphas)) for sw in sched.switches],
        delta=sched.delta,
    )
    np.testing.assert_array_equal(port_online.reuse_marks(port_sched, state),
                                  ref_online.reuse_marks(sched, ref_state))
    assert port_online.effective_makespan(port_sched, state) == ref_online.effective_makespan(sched, ref_state)
    got, gm = port_online.apply_reuse_order(port_sched, state)
    want, wm = ref_online.apply_reuse_order(sched, ref_state)
    np.testing.assert_array_equal(gm, wm)
    for a, b in zip(port_online.advance_installed(got, state, gm), ref_online.advance_installed(want, ref_state, wm)):
        np.testing.assert_array_equal(a, b)
    from repro.core.schedule_ir import schedule_to_ir as ref_to_ir

    ds = ref_to_ir(sched, 8, capacity=32)
    reused = np.zeros(32, dtype=bool)
    reused[3] = ds.switch[3] >= 0
    g_sched, g_marks = port_online.online_ir_to_schedule(DeviceSchedule(*ds), tr.spec.s, reused)
    w_sched, w_marks = ref_online.online_ir_to_schedule(ds, tr.spec.s, reused)
    np.testing.assert_array_equal(g_marks, w_marks)
    assert g_sched.makespan() == w_sched.makespan()
    with pytest.raises(ValueError):
        port_online.SwitchState.initial(0)


# ------------------------------------------------------------- device step

def _compare_step(rt, rj, lane=0):
    for f in ("makespan", "stateless_makespan", "lb"):
        np.testing.assert_allclose(float(getattr(rt, f)[lane]), float(getattr(rj, f)), rtol=1e-4)
    for f in ("reuse_count", "warm", "cache_hit", "k"):
        assert int(getattr(rt, f)[lane]) == int(getattr(rj, f)), f


@pytest.mark.parametrize("name, warm_prices, cache_size", [
    ("gpt", False, 0), ("gpt", False, 8), ("gpt", True, 0), ("gpt", True, 8),
    ("moe_phases", False, 0), ("moe_phases", False, 8), ("moe_phases", True, 0), ("moe_phases", True, 8),
    ("moe", False, 0), ("moe", False, 8),
])
def test_online_step_matches_reference(name, warm_prices, cache_size):
    """Four periods at n = 16: makespans to 1e-4, the decisions (warm,
    cache_hit, k, reuse_count) exactly, the installed configurations."""
    kw = {"gpt": {}, "moe_phases": dict(phases=2), "moe": dict(tokens_per_gpu=512)}[name]
    tr = make_trace(name, n=16, periods=4, **kw)
    s, delta = tr.spec.s, tr.spec.delta
    sj = jo.online_initial_state(16, s, cache_size)
    st = online_initial_state(16, s, cache_size, device=CPU)
    for t in range(tr.T):
        rj, sj = jo.online_step_jax(sj, tr.demands[t], s, delta, warm_prices=warm_prices)
        rt, st = online_step(st, torch.from_numpy(tr.demands[t][None]), s, delta, warm_prices=warm_prices)
        _compare_step(rt, rj)
        # The same configurations stay installed; which switch holds which
        # may differ where EQUALIZE's float32 switch loads tie (the port sums
        # them in float64, the reference in XLA's order: a stated bound).
        got = st.installed[0].numpy()
        want = np.asarray(sj.installed)
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))
        assert int(st.prev_k[0]) == int(sj.prev_k)
        assert float(rt.makespan[0]) <= float(rt.stateless_makespan[0])
    if cache_size:
        np.testing.assert_array_equal(st.cache_k[0].numpy(), np.asarray(sj.cache_k))
        assert int(st.cache_ptr[0]) == int(sj.cache_ptr)


def test_online_step_lanes_equal_single_runs():
    """B controllers in one step: each lane equals its own single-lane run."""
    trs = [make_trace("gpt", n=12, periods=2, seed=sd) for sd in (0, 5)]
    s, delta = trs[0].spec.s, trs[0].spec.delta
    both = online_initial_state(12, s, 4, batch=2, device=CPU)
    ones = [online_initial_state(12, s, 4, device=CPU) for _ in trs]
    for t in range(2):
        rb, both = online_step(both, torch.from_numpy(np.stack([tr.demands[t] for tr in trs])), s, delta)
        for b, tr in enumerate(trs):
            r1, ones[b] = online_step(ones[b], torch.from_numpy(tr.demands[t][None]), s, delta)
            for f in ("makespan", "stateless_makespan", "reuse_count", "warm", "k", "reused"):
                assert torch.equal(getattr(rb, f)[b], getattr(r1, f)[0]), f
            assert torch.equal(both.installed[b], ones[b].installed[0])


def test_online_scan_matches_reference_gpt_n32():
    """The rolling loop on the gpt trace at n = 32, three periods, the
    support cache on (the runner's default of 8): every period's decisions
    exactly, makespans to 1e-4, and the final carry."""
    tr = make_trace("gpt", periods=3)
    rj, fj = jo.spectra_online_scan(tr.demands, tr.spec.s, tr.spec.delta, cache_size=8)
    reads = []
    rt, ft = spectra_online_scan(tr.demands, tr.spec.s, tr.spec.delta, device=CPU, cache_size=8, host_reads=reads)
    assert rt.makespan.shape == (1, 3) and reads == [None, None, None]
    for t in range(tr.T):
        for f in ("makespan", "stateless_makespan"):
            np.testing.assert_allclose(float(getattr(rt, f)[0, t]), float(np.asarray(getattr(rj, f))[t]), rtol=1e-4)
        for f in ("reuse_count", "warm", "cache_hit", "k"):
            assert int(getattr(rt, f)[0, t]) == int(np.asarray(getattr(rj, f))[t]), (t, f)
    np.testing.assert_array_equal(ft.installed[0].numpy(), np.asarray(fj.installed))
    assert isinstance(ft, OnlineDeviceState)


def test_count_host_reads_is_none_on_the_cpu():
    with count_host_reads(CPU) as reads:
        torch.zeros(3).sum().item()
    assert reads == [None]


# ---------------------------------------------------------------- registry

def test_registry_host_solver_threads_state_as_reference():
    tr = make_trace("gpt", n=8, periods=3)
    state = ref_state = None
    for D in tr.demands:
        rep = solve(Problem(D, tr.spec.s, tr.spec.delta), solver="spectra_online",
                    options=SolveOptions(extra={"online": state}))
        ref = ref_solve(RefProblem(D, tr.spec.s, tr.spec.delta), solver="spectra_online",
                        options=RefOptions(extra={"online": ref_state}))
        state, ref_state = rep.extras["online_state"], ref.extras["online_state"]
        assert rep.makespan == pytest.approx(ref.makespan, rel=1e-12)
        assert rep.lower_bound == pytest.approx(ref.lower_bound, rel=1e-12)
        for f in ("reuse_count", "warm", "delta_avoided", "stateless_makespan"):
            assert rep.extras[f] == pytest.approx(ref.extras[f], rel=1e-12), f
        assert rep.validated and rep.backend == "numpy"
    assert isinstance(state, port_online.SwitchState)
    with pytest.raises(TypeError, match="SwitchState"):
        solve(Problem(tr.demands[0], 2, 0.01), solver="spectra_online",
              options=SolveOptions(extra={"online": object()}))


def test_registry_device_solver_threads_state_as_reference():
    tr = make_trace("gpt", n=8, periods=3)
    state = ref_state = None
    for t, D in enumerate(tr.demands):
        rep = solve(Problem(D, tr.spec.s, tr.spec.delta), solver="spectra_online_torch",
                    options=SolveOptions(extra={"online": state, "device": CPU, "cache_size": 4}))
        ref = ref_solve(RefProblem(D, tr.spec.s, tr.spec.delta), solver="spectra_online_jax",
                        options=RefOptions(extra={"online": ref_state, "cache_size": 4}))
        state, ref_state = rep.extras["online_state"], ref.extras["online_state"]
        assert rep.makespan == pytest.approx(ref.makespan, rel=1e-4)
        for f in ("reuse_count", "warm", "cache_hit", "k"):
            assert rep.extras[f] == ref.extras[f], f
        rep.schedule.validate(D, tol=1e-4)
        assert rep.backend == "torch" and rep.extras["device"] == CPU
        if t:
            assert rep.extras["reuse_count"] > 0
    assert isinstance(state, OnlineDeviceState)
    with pytest.raises(TypeError, match="OnlineDeviceState"):
        solve(Problem(tr.demands[0], 2, 0.01), solver="spectra_online_torch",
              options=SolveOptions(extra={"online": object(), "device": CPU}))
    with pytest.raises(ValueError, match="fresh session"):
        solve(Problem(np.ones((12, 12)), tr.spec.s, 0.01), solver="spectra_online_torch",
              options=SolveOptions(extra={"online": state, "device": CPU}))


def test_device_solver_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(Problem(np.ones((4, 4)), 2, 0.01), solver="spectra_online_torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spectra_online_scan(np.ones((2, 4, 4)), 2, 0.01)
