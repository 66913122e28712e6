"""The port's demand_accum plain version against the JAX reference, on the CPU.

The reference's op (``repro.kernels.demand_accum.ops.demand_accum``, its
Pallas kernel in interpret mode) and its ``.at[].add`` oracle against the
port's ``demand_accum`` on CPU tensors, which takes ``demand_accum_ref``.
Events with an index outside ``[0, n)`` add nothing (the reference op's
one-hot never matches them; its ``.at[]`` oracle would wrap a negative
index instead, so those cases compare with the op only). Sums run in
float32 in other orders: rtol 1e-5 of each cell plus 1e-5 of the largest.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.demand_accum.ops import demand_accum as jax_demand_accum  # noqa: E402
from repro.kernels.demand_accum.ref import demand_accum_ref as jax_demand_accum_ref  # noqa: E402
from repro_torch.kernels.demand_accum import demand_accum, demand_accum_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is about as fast, and
    does not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1.0))


def _events(rng, T, n, lo=0, hi=None):
    hi = n if hi is None else hi
    return (rng.integers(lo, hi, T).astype(np.int32), rng.integers(lo, hi, T).astype(np.int32),
            rng.random(T).astype(np.float32))


@pytest.mark.parametrize("n", [4, 64, 130])
@pytest.mark.parametrize("T", [1, 100, 512, 1000, 4096])
def test_plain_version_matches_reference(T, n):
    rng = np.random.default_rng(T * 1000 + n)
    src, dst, w = _events(rng, T, n)
    got = demand_accum(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), n=n)
    _close(got, jax_demand_accum(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n=n, interpret=True))
    _close(got, jax_demand_accum_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n))
    assert torch.equal(got, demand_accum_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), n))


def test_duplicate_events_accumulate():
    src = torch.tensor([1, 1, 1, 2], dtype=torch.int32)
    dst = torch.tensor([3, 3, 3, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 3.0, 5.0])
    D = demand_accum(src, dst, w, n=4)
    assert float(D[1, 3]) == 6.0 and float(D[2, 0]) == 5.0 and float(D.sum()) == 11.0


@pytest.mark.parametrize("T,n", [(100, 4), (1000, 64), (4096, 130)])
def test_out_of_range_events_add_nothing(T, n):
    rng = np.random.default_rng(T + n)
    src, dst, w = _events(rng, T, n, lo=-3, hi=n + 3)
    assert ((src < 0) | (src >= n) | (dst < 0) | (dst >= n)).any()
    got = demand_accum(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), n=n)
    _close(got, jax_demand_accum(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n=n, interpret=True))
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    _close(got, jax_demand_accum_ref(jnp.asarray(src[keep]), jnp.asarray(dst[keep]), jnp.asarray(w[keep]), n))


@pytest.mark.parametrize("wtype", [torch.bfloat16, torch.float16])
def test_int64_indices_and_low_precision_weights(wtype):
    rng = np.random.default_rng(7)
    src, dst, w = _events(rng, 1000, 64)
    w_low = torch.from_numpy(w).to(wtype)
    got = demand_accum(torch.from_numpy(src).long(), torch.from_numpy(dst).long(), w_low, n=64)
    w32 = w_low.float().numpy()  # the weights the reference sees after the same rounding
    _close(got, jax_demand_accum(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w32), n=64, interpret=True))


def test_no_events_give_zeros():
    e = torch.zeros((0,), dtype=torch.int32)
    D = demand_accum(e, e, torch.zeros((0,)), n=5)
    assert D.shape == (5, 5) and D.dtype == torch.float32 and not D.any()


def test_wrapper_rejects_bad_inputs():
    i = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        demand_accum(i, i[:2], torch.zeros(3), n=4)
    with pytest.raises(TypeError):
        demand_accum(i.float(), i.float(), torch.zeros(3), n=4)
    with pytest.raises(TypeError):
        demand_accum(i, i.long(), torch.zeros(3), n=4)
    with pytest.raises(TypeError):
        demand_accum(i, i, torch.zeros(3, dtype=torch.int32), n=4)
