"""The port's batched matchers against the reference's, lane by lane.

Exact parity holds when both sides bid with the same ε values, so the
parity tests hand the port the reference's ε schedule: the float32 ``pow``
inside ``_eps_schedule`` may round differently in XLA and in PyTorch (a
separate test bounds that difference at 2 ulps). Given the same ε, the
permutation, the convergence flag and the final prices agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core.jaxopt.matching as jm  # noqa: E402
import repro_torch.core.torchopt.matching as tm  # noqa: E402
from repro_torch.core.torchopt.decompose_torch import decompose  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
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


def _sparse_bonus_batch(rng, B, n, density=0.3):
    return np.stack([
        _bonus_weights(np.where(rng.random((n, n)) < density, rng.random((n, n)), 0.0))
        for _ in range(B)
    ])


def _use_reference_eps(monkeypatch, Ws):
    n = Ws.shape[-1]
    eps = np.stack([
        np.asarray(jm._eps_schedule(jnp.asarray(W), jm.default_num_phases(n))) for W in Ws
    ])
    monkeypatch.setattr(tm, "_eps_schedule", lambda W, P: torch.from_numpy(eps).to(W.device))


@pytest.mark.parametrize("matcher", ["auction", "auction_fr", "auction_fused"])
@pytest.mark.parametrize("n", [8, 37])
def test_matcher_matches_reference_given_same_eps(monkeypatch, matcher, n):
    rng = np.random.default_rng(n + len(matcher))
    Ws = _sparse_bonus_batch(rng, 3, n)
    _use_reference_eps(monkeypatch, Ws)
    res = tm.MATCHERS[matcher](torch.from_numpy(Ws))
    for b in range(3):
        perm, conv, prices = jm.MATCHERS[matcher](jnp.asarray(Ws[b]), with_prices=True)
        np.testing.assert_array_equal(res.perm[b].numpy(), np.asarray(perm))
        assert bool(res.converged[b]) == bool(conv)
        np.testing.assert_array_equal(res.prices[b].numpy(), np.asarray(prices))


def test_warm_fused_tail_matches_reference(monkeypatch):
    """With prices0 the fused matcher runs only the tail of the ε schedule."""
    rng = np.random.default_rng(11)
    n = 40
    W = rng.random((1, n, n)).astype(np.float32)
    _, _, warm = jm.match_auction_fused(jnp.asarray(W[0]), with_prices=True)
    W2 = (W * (1.0 + 0.01 * rng.standard_normal((1, n, n)))).astype(np.float32)
    _use_reference_eps(monkeypatch, W2)
    p0 = torch.from_numpy(np.array(warm))[None]
    cold = tm.match_auction_fused(torch.from_numpy(W2))
    res = tm.match_auction_fused(torch.from_numpy(W2), prices0=p0)
    perm, conv, prices = jm.match_auction_fused(
        jnp.asarray(W2[0]), prices0=jnp.asarray(warm), with_prices=True
    )
    np.testing.assert_array_equal(res.perm[0].numpy(), np.asarray(perm))
    np.testing.assert_array_equal(res.prices[0].numpy(), np.asarray(prices))
    assert bool(res.converged[0]) and bool(conv)
    assert int(res.rounds[0]) < int(cold.rounds[0])  # half the phases


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("n", [8, 100, 1024])
def test_eps_schedule_within_two_ulps_of_reference(n):
    """XLA and PyTorch may round the float32 ``pow`` that forms the schedule's
    ratio differently, by up to 2 ulps. Given the same ratio the schedules
    agree bit for bit; from the port's own ratio, the error grows with the
    power taken, so phase k may differ by about 2k ulps."""
    rng = np.random.default_rng(n)
    P = tm.default_num_phases(n)
    for scale in (1.0, 37.0, 1e4):
        W = (rng.random((1, n, n)) * scale).astype(np.float32)
        Wj = jnp.asarray(W[0])
        # The reference's own expressions (matching.py, _eps_schedule).
        wmax = jnp.maximum(jnp.abs(Wj).max(), 1e-12)
        eps_final = jnp.maximum(wmax * 1e-6 / n, wmax * jm._EPS_FLOOR)
        ratio_ref = (eps_final / (wmax / 2.0)) ** (1.0 / max(P - 1, 1))
        start, ratio = tm._eps_ratio(torch.from_numpy(W), P)
        assert _ulps(ratio.numpy()[0], ratio_ref) <= 2
        assert _ulps(start.numpy()[0], wmax / 2.0) == 0
        ref = np.asarray(jm._eps_schedule(Wj, P))
        same_ratio = start[:, None] * torch.tensor([float(ratio_ref)])[:, None] ** torch.arange(P)
        np.testing.assert_array_equal(same_ratio.numpy()[0], ref)
        mine = tm._eps_schedule(torch.from_numpy(W), P).numpy()[0]
        assert (_ulps(mine, ref) <= 2 * np.arange(P) + 2).all()


@pytest.mark.parametrize("matcher", ["auction", "auction_fr", "auction_fused"])
def test_batched_lanes_equal_single_instance_runs(matcher):
    """Lanes that converge at different rounds: each lane's result is its own
    single-instance result (a finished lane is frozen, counters included)."""
    rng = np.random.default_rng(3)
    n = 24
    Ws = np.stack([
        _bonus_weights(np.where(rng.random((n, n)) < d, rng.random((n, n)), 0.0))
        for d in (0.1, 0.5, 0.9)
    ])
    batch = tm.MATCHERS[matcher](torch.from_numpy(Ws))
    assert len(set(batch.rounds.tolist())) > 1  # the lanes finish apart
    for b in range(3):
        one = tm.MATCHERS[matcher](torch.from_numpy(Ws[b:b + 1]))
        for got, want in zip(batch, one):
            assert torch.equal(got[b], want[0]), (matcher, b)


def test_decompose_lanes_equal_single_instance_runs():
    """DECOMPOSE's round loop: a lane with no residual support left is never
    touched again (no extra α = 0 round, no k increment)."""
    rng = np.random.default_rng(5)
    n = 12
    Ds = np.stack([
        np.where(rng.random((n, n)) < d, rng.random((n, n)), 0.0) for d in (0.15, 0.6, 1.0)
    ]).astype(np.float32)
    batch = decompose(torch.from_numpy(Ds), matcher="auction", repair_rounds=2)
    assert len(set(batch.k.tolist())) > 1
    for b in range(3):
        one = decompose(torch.from_numpy(Ds[b:b + 1]), matcher="auction", repair_rounds=2)
        for got, want in zip(batch, one):
            assert torch.equal(got[b], want[0]), b


def test_greedy_completion_when_starved():
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.random((2, 24, 24)).astype(np.float32))
    for name in tm.MATCHERS:
        res = tm.MATCHERS[name](W, max_iters=1)
        assert not bool(res.converged.any())
        for b in range(2):
            assert sorted(res.perm[b].tolist()) == list(range(24))


def test_default_matcher_thresholds_and_registry():
    assert [tm.default_matcher(n) for n in (16, 32, 33, 128, 129, 512)] == [
        "auction", "auction", "auction_fr", "auction_fr", "auction_fused", "auction_fused"
    ]
    for n in (8, 33, 100, 257, 1024):
        assert tm.default_num_phases(n) == jm.default_num_phases(n)
        assert tm.default_max_iters(n) == jm.default_max_iters(n)
        assert tm.default_matcher(n) == jm.default_matcher(n)
    with pytest.raises(KeyError):
        tm.get_matcher("hungarian")
