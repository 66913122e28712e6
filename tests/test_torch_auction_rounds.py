"""``auction_rounds`` (every phase and bidding round of a matcher call in one
op) against the reference's matchers, on the CPU.

On a CPU tensor the op takes its plain version, ``auction_rounds_ref``. Given
the reference's ε schedule (the float32 ``pow`` that forms it may round
differently in XLA and in PyTorch; see ``test_torch_matching.py``), the
permutation after greedy completion, the convergence flag and the final
prices equal the reference's ``match_auction`` / ``match_auction_fr``
exactly, on random and on tie-rich weights, with the round budget cut too.
``test_torch_kernels_cuda.py`` holds the CUDA kernel to this plain version
bit for bit on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core.jaxopt.matching as jm  # noqa: E402
from repro_torch.core.torchopt.matching import _complete_greedy, default_max_iters  # noqa: E402
from repro_torch.kernels.auction_bid import auction_rounds, auction_rounds_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(n, seed):
    """Two lanes: random weights in [0, 1), and small integers full of ties."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.random((n, n)).astype(np.float32),
        rng.integers(0, 3, (n, n)).astype(np.float32),
    ])


def _against_reference(Ws, matcher, max_iters):
    n = Ws.shape[-1]
    P = jm.default_num_phases(n)
    eps = np.stack([np.asarray(jm._eps_schedule(jnp.asarray(W), P)) for W in Ws])
    r2c, c2r, prices, rounds, bids = auction_rounds(
        torch.from_numpy(Ws), torch.from_numpy(eps), max_iters, reverse=matcher == "auction_fr"
    )
    perm = _complete_greedy(r2c, c2r)
    for b in range(Ws.shape[0]):
        want_perm, want_conv, want_prices = jm.MATCHERS[matcher](
            jnp.asarray(Ws[b]), max_iters=max_iters, with_prices=True
        )
        np.testing.assert_array_equal(perm[b].numpy(), np.asarray(want_perm))
        assert bool((r2c[b] >= 0).all()) == bool(want_conv)
        np.testing.assert_array_equal(prices[b].numpy(), np.asarray(want_prices))
    assert (rounds <= P * max_iters).all() and (bids >= rounds).all()
    return r2c, rounds


@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
@pytest.mark.parametrize("n", [1, 2, 5, 32, 33])
def test_rounds_match_reference(matcher, n):
    Ws = _lanes(n, seed=n + 7 * len(matcher))
    r2c, _ = _against_reference(Ws, matcher, default_max_iters(n))
    assert bool((r2c >= 0).all())  # the full budget converges here


@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
@pytest.mark.parametrize("n", [5, 33])
def test_rounds_match_reference_with_budget_cut(matcher, n):
    Ws = _lanes(n, seed=100 + n)
    _, rounds = _against_reference(Ws, matcher, 3)
    assert (rounds <= 3 * jm.default_num_phases(n)).all()


def test_no_budget_leaves_everything_unassigned():
    W = torch.from_numpy(_lanes(4, seed=1))
    r2c, c2r, prices, rounds, bids = auction_rounds(W, torch.ones((2, 3)), 0, reverse=True)
    assert bool((r2c < 0).all() and (c2r < 0).all()) and not prices.any()
    assert rounds.tolist() == [0, 0] and bids.tolist() == [0, 0]


def test_op_is_its_plain_version_on_the_cpu():
    Ws = torch.from_numpy(_lanes(9, seed=2))
    eps = torch.full((2, 4), 0.05)
    for reverse in (False, True):
        for got, want in zip(auction_rounds(Ws, eps, 50, reverse=reverse),
                             auction_rounds_ref(Ws, eps, 50, reverse=reverse)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("bad,err", [
    ("n > 128", ValueError),
    ("float64", TypeError),
    ("strided", ValueError),
    ("eps rows", ValueError),
    ("eps empty", ValueError),
    ("max_iters", ValueError),
])
def test_op_rejects_bad_inputs(bad, err):
    W = torch.zeros((2, 8, 8))
    eps = torch.ones((2, 3))
    max_iters = 10
    if bad == "n > 128":
        W = torch.zeros((1, 129, 129))
        eps = torch.ones((1, 3))
    elif bad == "float64":
        W = W.double()
    elif bad == "strided":
        W = torch.zeros((2, 8, 16))[:, :, ::2]
    elif bad == "eps rows":
        eps = torch.ones((3, 3))
    elif bad == "eps empty":
        eps = torch.ones((2, 0))
    else:
        max_iters = -1
    with pytest.raises(err):
        auction_rounds(W, eps, max_iters, reverse=False)
