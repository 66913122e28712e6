"""The port's fused pipeline against ``spectra_jax_e2e_many``.

Same inputs (numpy, from a seed) through both. Sums are taken in another
order on each side (the M-bonus, coverage, switch loads) and the ε
schedules may differ in the last ulps, so makespans and bounds are held to
1e-4 relative, and the discrete outcomes (k, convergence, EQUALIZE
exhaustion) must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.jaxopt.e2e import spectra_jax_e2e_many  # noqa: E402
from repro.core.jaxopt.matching import default_matcher  # noqa: E402
from repro.traffic.workloads import benchmark_workload, gpt3b_workload  # noqa: E402
from repro_torch.core.torchopt.e2e import schedule_decomposition, spectra_torch_e2e_many  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perm_workload(n, k, rng, floor=0.05):
    D = np.zeros((n, n), dtype=np.float64)
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + floor
    return D


def assert_e2e_parity(Ds, s, delta):
    n = Ds.shape[-1]
    matcher = default_matcher(n)
    mine = spectra_torch_e2e_many(Ds, s, delta, device="cpu", matcher=matcher)
    ref = spectra_jax_e2e_many(
        jnp.asarray(Ds, jnp.float32), s, jnp.asarray(delta, jnp.float32), matcher=matcher
    )
    for field in ("makespan", "lpt_makespan", "lb"):
        np.testing.assert_allclose(
            getattr(mine, field).numpy(), np.asarray(getattr(ref, field)), rtol=RTOL,
            err_msg=field,
        )
    np.testing.assert_array_equal(mine.dec.k.numpy(), np.asarray(ref.dec.k))
    np.testing.assert_array_equal(mine.dec.converged.numpy(), np.asarray(ref.dec.converged))
    np.testing.assert_array_equal(mine.eq_exhausted.numpy(), np.asarray(ref.eq_exhausted))
    assert bool(mine.dec.converged.all()) and not bool(mine.eq_exhausted.any())
    assert (mine.makespan >= mine.lb * (1 - 1e-6)).all()
    return mine, ref


def test_gpt_n32_per_instance_delta():
    Ds = np.stack([gpt3b_workload(rng=np.random.default_rng(s)) for s in (1, 2)])
    assert_e2e_parity(Ds, 4, np.array([0.01, 0.03]))


def test_benchmark_n100():
    Ds = benchmark_workload(rng=np.random.default_rng(4))[None]
    assert_e2e_parity(Ds, 4, 0.01)


def test_permutations_n160_fused_matcher():
    assert default_matcher(160) == "auction_fused"
    Ds = perm_workload(160, 4, np.random.default_rng(160))[None]
    assert_e2e_parity(Ds, 4, 0.01)


def test_stage_carry_jax_decompose_into_port_schedule():
    """JAX DECOMPOSE → the port's LPT + EQUALIZE: pins any mismatch to the
    schedule stages, which must reproduce the reference's slot table."""
    Ds = np.stack([gpt3b_workload(rng=np.random.default_rng(s)) for s in (5, 6)])
    deltas = np.array([0.01, 0.02], np.float32)
    ref = spectra_jax_e2e_many(jnp.asarray(Ds, jnp.float32), 4, jnp.asarray(deltas), matcher="auction")
    dec = from_reference({f: np.asarray(getattr(ref.dec, f)) for f in ref.dec._fields}, "cpu")
    ds, lpt_makespan, exhausted = schedule_decomposition(dec, 4, torch.from_numpy(deltas))
    np.testing.assert_array_equal(ds.switch.numpy(), np.asarray(ref.schedule.switch))
    np.testing.assert_array_equal(ds.perms.numpy(), np.asarray(ref.schedule.perms))
    np.testing.assert_allclose(ds.alphas.numpy(), np.asarray(ref.schedule.alphas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lpt_makespan.numpy(), np.asarray(ref.lpt_makespan), rtol=1e-6)
    np.testing.assert_array_equal(exhausted.numpy(), np.asarray(ref.eq_exhausted))

    # The whole result carries across too, nested fields keyed by prefix.
    flat = {f: np.asarray(getattr(ref, f)) for f in ("makespan", "lpt_makespan", "eq_exhausted", "lb")}
    flat.update({f"schedule.{f}": np.asarray(getattr(ref.schedule, f)) for f in ref.schedule._fields})
    flat.update({f"dec.{f}": np.asarray(getattr(ref.dec, f)) for f in ref.dec._fields})
    twin = from_reference(flat, "cpu")
    assert torch.equal(twin.schedule.switch, ds.switch)
    assert twin.dec.k.tolist() == dec.k.tolist()
    with pytest.raises(ValueError):
        from_reference({"perms": np.zeros((1, 2, 2))}, "cpu")
