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


def _maps_with_holes(rng, n, holes):
    """A row -> column map and its inverse with ``holes`` rows unassigned."""
    r2c = rng.permutation(n)
    c2r = np.empty(n, dtype=np.int64)
    c2r[r2c] = np.arange(n)
    drop = rng.choice(n, holes, replace=False)
    c2r[r2c[drop]] = -1
    r2c[drop] = -1
    return r2c, c2r


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n,swaps", [(9, "2n"), (33, "2n"), (33, 3)])
def test_polish_2swap_matches_reference(kind, n, swaps):
    """The fused matcher's tail (``polish_2swap``'s plain version: greedy
    completion, then the best-pair 2-swap polish) against the reference's
    ``_complete_greedy`` and ``_polish_2swap``, lane by lane, exactly."""
    from repro_torch.kernels.auction_fused import polish_2swap, polish_2swap_ref

    rng = np.random.default_rng(n)
    B = 2
    W = (rng.random((B, n, n)) if kind == "random" else rng.integers(0, 3, (B, n, n))).astype(np.float32)
    maps = [_maps_with_holes(rng, n, n // 4) for _ in range(B)]
    r2c = torch.from_numpy(np.stack([m[0] for m in maps])).int()
    c2r = torch.from_numpy(np.stack([m[1] for m in maps])).int()
    max_swaps = 2 * n if swaps == "2n" else swaps
    perm, converged = polish_2swap_ref(torch.from_numpy(W), r2c, c2r, max_swaps=max_swaps)
    for got, want in zip(polish_2swap(torch.from_numpy(W), r2c, c2r, max_swaps=max_swaps), (perm, converged)):
        assert torch.equal(got, want)
    assert not bool(converged.any())
    for b in range(B):
        start = jm._complete_greedy(jnp.asarray(maps[b][0], jnp.int32), jnp.asarray(maps[b][1], jnp.int32))
        want = np.asarray(jm._polish_2swap(jnp.asarray(W[b]), start, max_swaps))
        assert perm[b].tolist() == want.tolist()


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


@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
def test_matcher_above_128_matches_reference_given_same_eps(monkeypatch, matcher):
    """Above n = 128 the matchers run the round loop (one ``masked_row_top2``
    a round) where ``auction_rounds`` cannot hold W; the result is the
    reference's, as below 128."""
    rng = np.random.default_rng(160)
    Ws = _sparse_bonus_batch(rng, 1, 160)
    _use_reference_eps(monkeypatch, Ws)
    res = tm.MATCHERS[matcher](torch.from_numpy(Ws))
    perm, conv, prices = jm.MATCHERS[matcher](jnp.asarray(Ws[0]), with_prices=True)
    np.testing.assert_array_equal(res.perm[0].numpy(), np.asarray(perm))
    assert bool(res.converged[0]) == bool(conv)
    np.testing.assert_array_equal(res.prices[0].numpy(), np.asarray(prices))


@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
def test_matchers_take_n_above_128(matcher):
    """n = 160 used to raise (``auction_rounds`` takes n <= 128). Lanes of a
    batch equal their own runs, and the CPU launches no kernel."""
    from repro_torch.kernels.auction_bid import masked_row_top2

    W = torch.from_numpy(np.random.default_rng(7).random((2, 160, 160), dtype=np.float32))
    before = masked_row_top2.launches
    batch = tm.MATCHERS[matcher](W)
    assert masked_row_top2.launches == before
    assert bool(batch.converged.all())
    for b in range(2):
        assert sorted(batch.perm[b].tolist()) == list(range(160))
    one = tm.MATCHERS[matcher](W[1:])
    for got, want in zip(batch, one):
        assert torch.equal(got[1], want[0])


@pytest.mark.parametrize("n, max_iters", [(37, None), (128, 40)])
@pytest.mark.parametrize("reverse", [False, True])
def test_round_loop_equals_auction_rounds_bit_for_bit(n, max_iters, reverse):
    """At n <= 128 both paths can run: the round loop and ``auction_rounds``
    agree in every output (row2col, col2row, prices, rounds, bids)."""
    from repro_torch.kernels.auction_bid import auction_round_loop, auction_rounds

    Ws = torch.from_numpy(_sparse_bonus_batch(np.random.default_rng(n), 2, n))
    eps = tm._eps_schedule(Ws, tm.default_num_phases(n)).contiguous()
    mi = tm.default_max_iters(n) if max_iters is None else max_iters
    for got, want in zip(auction_round_loop(Ws, eps, mi, reverse=reverse),
                         auction_rounds(Ws, eps, mi, reverse=reverse)):
        assert got.dtype == want.dtype and torch.equal(got, want)
