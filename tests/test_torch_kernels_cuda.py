"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``requires_cuda``: they skip without a CUDA device. On the GPU host
(which has no JAX) run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m requires_cuda

The auction kernels must equal their plain versions exactly, on inputs full
of ties; flash_attention and ssd_chunk hold to the tolerances stated below.
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


# ---------------------------------------------------------------------------
# flash_attention and ssd_chunk: float32 to accumulation order (atol 1e-4),
# bfloat16 to the rounding of the output (atol 2e-2 on values of order 1).
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import flash_attention, mha_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import _pick_chunk  # noqa: E402

_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 200, 200, 128, True, None),   # GQA, ragged tiles
    (1, 4, 4, 300, 300, 32, True, 64),      # sliding window
    (1, 4, 2, 100, 300, 64, True, None),    # Sq < Sk
    (1, 2, 1, 77, 130, 64, False, None),    # no mask
])
def test_flash_kernel_equals_plain(cuda, dtype, B, Hq, Hkv, Sq, Sk, D, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((B, Hq, Sq, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, Sk, D), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = mha_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,N,P", [(8, 512, 64, 64), (4, 96, 16, 16), (2, 256, 128, 128), (3, 40, 8, 24)])
def test_ssd_chunk_kernel_equals_plain(cuda, dtype, BH, S, N, P):
    gen = torch.Generator(device=cuda).manual_seed(S)
    xd = torch.randn((BH, S, P), generator=gen, device=cuda).to(dtype)
    loga = -0.5 * torch.rand((BH, S), generator=gen, device=cuda)
    B = (torch.randn((BH, S, N), generator=gen, device=cuda) / N ** 0.5).to(dtype)
    C = (torch.randn((BH, S, N), generator=gen, device=cuda) / N ** 0.5).to(dtype)
    L = _pick_chunk(S)
    before = ssd_chunk.launches
    got = ssd_chunk(xd, loga, B, C, L)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    for g, w in zip(got, ssd_chunk_ref(xd, loga, B, C, L)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if S <= 256:  # the whole op against the sequential scan
        y, hT = ssd_scan(xd, loga, B, C)
        y_ref, h_ref = ssd_ref(xd, loga, B, C)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=0, atol=_ATOL[dtype])
        torch.testing.assert_close(hT, h_ref, rtol=1e-4, atol=1e-4)
