"""The port's kernel modules against the reference's, and kernel vs plain.

On the CPU each wrapper takes its plain PyTorch version; those must equal
the reference's jnp versions (and the interpret-mode Pallas bid kernel)
exactly: the rounds only subtract, add, take max/min and first-index
argmax, in the same order. ``test_torch_kernels_cuda.py`` holds each CUDA
kernel to its plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.jaxopt.matching import _eps_schedule as jax_eps_schedule  # noqa: E402
from repro.kernels.auction_bid.ops import masked_row_top2 as jax_top2_kernel  # noqa: E402
from repro.kernels.auction_bid.ref import masked_row_top2_ref as jax_top2_ref  # noqa: E402
from repro.kernels.auction_fused.ref import fused_auction_ref as jax_fused_ref  # noqa: E402
from repro_torch.core.torchopt.matching import default_max_iters  # noqa: E402
from repro_torch.kernels.auction_bid import masked_row_top2, masked_row_top2_ref  # noqa: E402
from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref  # noqa: E402
from repro_torch.kernels.auction_fused.ops import (  # noqa: E402
    cluster_max_n,
    cluster_smem_bytes,
    fused_kernel_for,
    pick_kernel,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perm_workload(n, k, rng, floor=0.05):
    D = np.zeros((n, n), dtype=np.float64)
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + floor
    return D


def _bonus_weights(D):
    """DECOMPOSE-regime weights: positive demand plus node-coverage M-bonus."""
    S = D > 0
    rd, cd = S.sum(1), S.sum(0)
    k = max(rd.max(), cd.max())
    M = np.maximum(D, 0).max(axis=1).sum() + 1.0
    bonus = M * ((rd == k)[:, None].astype(float) + (cd == k)[None, :])
    return (np.maximum(D, 0) + np.where(S, bonus, 0)).astype(np.float32)


# ------------------------------------------------------------- auction_bid


@pytest.mark.parametrize("n", [5, 37, 100, 130])
def test_top2_ref_matches_reference_exactly(n):
    rng = np.random.default_rng(n)
    B = 2
    # Small integers: rows full of ties in both v1 and v2.
    W = rng.integers(0, 4, (B, n, n)).astype(np.float32)
    p = rng.integers(0, 3, (B, n)).astype(np.float32)
    v1, v2, j1 = masked_row_top2(torch.from_numpy(W), torch.from_numpy(p))
    assert j1.dtype == torch.int32
    for b in range(B):
        for jax_fn in (jax_top2_ref, jax_top2_kernel):  # jnp, interpret Pallas
            r1, r2, rj = jax_fn(jnp.asarray(W[b]), jnp.asarray(p[b]))
            np.testing.assert_array_equal(v1[b].numpy(), np.asarray(r1))
            np.testing.assert_array_equal(v2[b].numpy(), np.asarray(r2))
            np.testing.assert_array_equal(j1[b].numpy(), np.asarray(rj))


def test_top2_single_column_second_best_is_neg():
    W = torch.tensor([[[3.0], [1.0]]])
    v1, v2, j1 = masked_row_top2_ref(W, torch.zeros((1, 1)))
    assert bool((v2 == torch.tensor(-1e30)).all()) and j1.tolist() == [[0, 0]]


def test_top2_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        masked_row_top2(torch.zeros((1, 3, 3), dtype=torch.float64), torch.zeros((1, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        masked_row_top2(torch.zeros((1, 3, 3)), torch.zeros((1, 4)))


# ----------------------------------------------------------- auction_fused


def _fused_vs_reference(Ws, num_phases=8):
    B, n, _ = Ws.shape
    eps = np.stack([np.asarray(jax_eps_schedule(jnp.asarray(W), num_phases)) for W in Ws])
    mi = default_max_iters(n)
    got = fused_auction(
        torch.from_numpy(Ws), torch.zeros((B, n)), torch.from_numpy(eps), max_iters=mi
    )
    for b in range(B):
        want = jax_fused_ref(
            jnp.asarray(Ws[b]), jnp.zeros((n,), jnp.float32), jnp.asarray(eps[b]),
            max_iters=mi, with_iters=True,
        )
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("n", [5, 37, 100, 130])
def test_fused_ref_matches_reference_random(n):
    rng = np.random.default_rng(n)
    _fused_vs_reference(rng.random((2, n, n)).astype(np.float32))


@pytest.mark.parametrize("n", [37, 64])
def test_fused_ref_matches_reference_bonus_regime(n):
    rng = np.random.default_rng(7 * n)
    Ws = np.stack([_bonus_weights(_perm_workload(n, 6, rng)) for _ in range(2)])
    r2c, c2r, _, rounds, bids = _fused_vs_reference(Ws)
    assert (r2c >= 0).all() and (rounds > 0).all()
    # Every round has at least one bidder, and no more than n.
    assert (bids >= rounds).all() and (bids <= rounds * n).all()


def test_fused_wrapper_rejects_bad_inputs():
    W = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError):
        fused_auction(W, torch.zeros((1, 4)), torch.zeros((1, 0)), max_iters=10)
    with pytest.raises(ValueError):
        fused_auction(torch.zeros((1, 4, 5)), torch.zeros((1, 4)), torch.ones((1, 2)), max_iters=10)


# ------------------------------------------------- which fused kernel serves n

_MAX_N = {8: 645, 16: 893}  # the largest n whose rows of W fit a CTA's 227 KB


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("n", [1, 8, 100, 512, "max", "max+1"])
def test_fused_kernel_choice_by_n(n, cluster):
    """The cluster kernel serves n up to the largest whose share of W (R =
    ⌈n / cluster⌉ rows) and column arrays fit one block's 227 KB of shared
    memory; the one-block kernel serves every larger n."""
    assert cluster_max_n(cluster) == _MAX_N[cluster]
    n = {"max": _MAX_N[cluster], "max+1": _MAX_N[cluster] + 1}.get(n, n)
    fits = cluster_smem_bytes(n, cluster) <= 232448
    assert fits == (n <= _MAX_N[cluster])
    assert fused_kernel_for(n, cluster) == ("cluster" if fits else "block")


@pytest.mark.parametrize("B,n,want", [(1, 256, ("cluster", 16)), (4, 512, ("cluster", 16)),
                                       (4, 893, ("cluster", 16)), (1, 894, ("block", 0)),
                                       (5, 256, ("block", 0)), (8, 100, ("block", 0))])
def test_fused_kernel_picked_by_lanes_and_n(B, n, want):
    """Unless the caller names a kernel, up to four lanes take 16-CTA
    clusters where W fits them, and the rest the one-block kernel."""
    assert pick_kernel(B, n) == want


def test_fused_wrapper_kernel_choice_checks():
    W = torch.zeros((1, 700, 700))
    p0, eps = torch.zeros((1, 700)), torch.ones((1, 2))
    with pytest.raises(ValueError):
        fused_auction(W, p0, eps, max_iters=1, kernel="cluster")  # 700 > 645 at 8 CTAs
    with pytest.raises(ValueError):
        fused_auction(W, p0, eps, max_iters=1, kernel="warp")
    with pytest.raises(ValueError):
        fused_auction(W, p0, eps, max_iters=1, cluster=32)
    assert fused_kernel_for(700, 16) == "cluster" and fused_kernel_for(1024, 16) == "block"
    # On the CPU either choice is the plain version.
    rng = np.random.default_rng(3)
    Wt = torch.from_numpy(rng.random((2, 40, 40)).astype(np.float32))
    p0, eps = torch.zeros((2, 40)), torch.full((2, 3), 0.01)
    want = fused_auction_ref(Wt, p0, eps, max_iters=default_max_iters(40))
    for kernel in ("cluster", "block"):
        for g, w in zip(fused_auction(Wt, p0, eps, max_iters=default_max_iters(40), kernel=kernel), want):
            assert torch.equal(g, w)
