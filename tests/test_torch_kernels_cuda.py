"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``requires_cuda``: they skip without a CUDA device. On the GPU host
(which has no JAX) run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m requires_cuda

Both kernels must equal their plain versions exactly, on inputs full of ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.torchopt.matching import default_max_iters  # noqa: E402
from repro_torch.kernels.auction_bid import masked_row_top2, masked_row_top2_ref  # noqa: E402
from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bonus_weights(rng, n, k=8, floor=0.05):
    """A sum of k random permutations plus DECOMPOSE's node-coverage M-bonus."""
    D = np.zeros((n, n))
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + floor
    S = D > 0
    rd, cd = S.sum(1), S.sum(0)
    top = max(rd.max(), cd.max())
    M = D.max(axis=1).sum() + 1.0
    return (D + np.where(S, M * ((rd == top)[:, None] + (cd == top)[None, :]), 0)).astype(np.float32)


@pytest.mark.parametrize("B,n", [(8, 32), (8, 64), (8, 100), (4, 128), (2, 1)])
def test_bid_kernel_equals_plain(cuda, B, n):
    rng = np.random.default_rng(n)
    W = torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.float32)).to(cuda)
    before = masked_row_top2.launches
    got = masked_row_top2(W, p)
    torch.cuda.synchronize()
    assert masked_row_top2.launches == before + 1
    for g, w in zip(got, masked_row_top2_ref(W, p)):
        assert torch.equal(g, w)


def test_bid_kernel_rejects_strided_input(cuda):
    W = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        masked_row_top2(W.transpose(1, 2), torch.zeros((2, 8), device=cuda))


@pytest.mark.parametrize("B,n", [(4, 100), (2, 256), (1, 1024)])
def test_fused_kernel_equals_plain(cuda, B, n):
    rng = np.random.default_rng(n)
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n) for _ in range(B)])).to(cuda)
    eps = ((W.amax(dim=(1, 2)) / 2)[:, None] * (0.25 ** torch.arange(8, device=cuda))[None, :]).contiguous()
    p0 = torch.zeros((B, n), device=cuda)
    before = fused_auction.launches
    got = fused_auction(W, p0, eps, max_iters=default_max_iters(n))
    torch.cuda.synchronize()
    assert fused_auction.launches == before + 1
    for g, w in zip(got, fused_auction_ref(W, p0, eps, max_iters=default_max_iters(n))):
        assert torch.equal(g, w)
