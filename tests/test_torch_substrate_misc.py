"""The port's gradient compression, legacy auction shim, gpt-100m OCS
training twin and matcher benchmark against the reference, on the CPU."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.core.jaxopt.auction import auction_maximize as jax_auction_maximize  # noqa: E402
from repro.core.jaxopt.auction import auction_maximize_batch as jax_auction_maximize_batch  # noqa: E402
from repro.data.pipeline import make_stream as jax_make_stream  # noqa: E402
from repro.fabric.ocs import OCSFabric as JaxOCSFabric  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train.loop import _demand_from_stats as jax_demand_from_stats  # noqa: E402
from repro_torch.bench import matching as bench  # noqa: E402
from repro_torch.core.torchopt.auction import auction_maximize, auction_maximize_batch  # noqa: E402
from repro_torch.core.torchopt.matching import match_auction  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import train_gpt_ocs  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 24)).astype(np.float32),
            "b": rng.standard_normal((40,)).astype(np.float32),
            # ties at the threshold: every |g| ≥ the k-th largest is sent
            "c": np.repeat(rng.standard_normal((5,)).astype(np.float32), 6).reshape(5, 6)}


@pytest.mark.parametrize("frac", [0.05, 0.25, 0.5])
def test_compress_topk_equals_reference(frac):
    grads = _grads(0)
    err = {k: (0.1 * np.random.default_rng(1).standard_normal(v.shape)).astype(np.float32) for k, v in grads.items()}
    want_sent, want_err = jgc.compress_topk({k: jnp.asarray(v) for k, v in grads.items()},
                                            {k: jnp.asarray(v) for k, v in err.items()}, frac)
    sent, new_err = tgc.compress_topk({k: torch.from_numpy(v) for k, v in grads.items()},
                                      {k: torch.from_numpy(v) for k, v in err.items()}, frac)
    for k in grads:
        np.testing.assert_array_equal(sent[k].numpy(), np.asarray(want_sent[k]), err_msg=k)
        np.testing.assert_array_equal(new_err[k].numpy(), np.asarray(want_err[k]), err_msg=k)
    assert tgc.compression_ratio({k: torch.from_numpy(v) for k, v in grads.items()}, frac) == \
        jgc.compression_ratio({k: jnp.asarray(v) for k, v in grads.items()}, frac)


def test_init_error_and_error_feedback_loop():
    grads = {k: torch.from_numpy(v) for k, v in _grads(2).items()}
    err = tgc.init_error(grads)
    assert all(e.dtype == torch.float32 and not e.any() for e in err.values())
    sent, err = tgc.compress_topk(grads, err, 0.1)
    for k in grads:  # sent + carried error is the whole gradient
        torch.testing.assert_close(sent[k] + err[k], grads[k], rtol=0, atol=0)


def _auction_weights(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    W = rng.random((n, n)).astype(np.float32)
    W[rng.random((n, n)) < 0.3] = 0.0  # ties and zeros, as DECOMPOSE's rounds make
    return W


@pytest.mark.parametrize("n,seed", [(8, 0), (17, 1), (32, 2)])
def test_auction_shim_equals_reference(n, seed):
    W = _auction_weights(n, seed)
    want_perm, want_conv = jax_auction_maximize(jnp.asarray(W))
    perm, conv = auction_maximize(torch.from_numpy(W))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    assert bool(conv) == bool(want_conv)
    # The same permutation as the port's own matcher.
    np.testing.assert_array_equal(perm.numpy(), match_auction(torch.from_numpy(W)[None]).perm[0].numpy())


def test_auction_shim_batch_and_device_rule():
    W = np.stack([_auction_weights(16, s) for s in range(3)])
    want, _ = jax_auction_maximize_batch(jnp.asarray(W))
    perm, conv = auction_maximize_batch(torch.from_numpy(W))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want))
    assert conv.all()
    # A numpy W goes to the named device; without one it needs CUDA.
    perm_np, _ = auction_maximize(W[0], device="cpu")
    np.testing.assert_array_equal(perm_np.numpy(), np.asarray(want)[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            auction_maximize(W[0])


def test_gpt_100m_config_is_the_examples():
    spec = importlib.util.spec_from_file_location("train_gpt_ocs_example", REPO / "examples" / "train_gpt_ocs.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want = example.gpt_100m()
    got = train_gpt_ocs.gpt_100m()
    assert isinstance(want, JaxModelConfig)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert {f: getattr(got.reduced(), f) for f in got.__dataclass_fields__} == \
        {f: getattr(want.reduced(), f) for f in want.__dataclass_fields__}


def test_gpt_twin_first_step_loss_equals_reference():
    """The twin's model, data and loss from the reference's parameters."""
    tr, cfg, steps = train_gpt_ocs.make_gpt_trainer(tiny=True, device="cpu")
    assert steps == 30 and tr.cfg.ocs_every == 20 and tr.cfg.ocs_num_racks == 8
    assert tr.fabric.num_switches == 4 and tr.fabric.reconfig_delay_s == 20e-6
    jcfg = JaxModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jmodel = JaxLM(jcfg, attn_impl="chunked")
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jbatch = jax_make_stream(cfg.vocab_size, 256, 8).next_batch(0)
    want, _ = jmodel.loss(jax.tree.map(jnp.asarray, jparams), jbatch)
    batch = tr.stream.next_batch(0)
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
    with torch.no_grad(), tr.model.bound(params_from_reference(cfg, jparams)):
        loss, _ = tr.model.loss(batch)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_gpt_twin_tiny_run_ticks_equal_reference(capsys):
    state = train_gpt_ocs.main(["--tiny", "--device", "cpu", "--steps", "21"])
    out = capsys.readouterr().out
    assert "OK: loss decreased" in out and "gpt-100m" in out
    assert state.history[-1]["loss"] < state.history[0]["loss"]
    assert [r["step"] for r in state.cct_log] == [19]
    ring = jax_demand_from_stats(8, {}, 19)
    res, cct = JaxOCSFabric(num_switches=4, reconfig_delay_s=20e-6).schedule_bytes(ring * 1e9)
    rec = state.cct_log[0]
    assert rec["cct_s"] == cct and rec["makespan"] == res.makespan and rec["lb"] == res.lower_bound
    assert rec["configs"] == res.schedule.num_configs()


def _reference_bench():
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks import bench_matching
    finally:
        sys.path.remove(str(REPO))
    return bench_matching


@pytest.mark.parametrize("n", [32, 100, 256])
def test_bench_weights_bit_for_bit(n):
    ref = _reference_bench()
    got, want = bench.bench_weights(n), ref.bench_weights(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert bench._matchers_for(n) == ref._matchers_for(n)
    assert bench._matchers_for(512) == ref._matchers_for(512)


def test_bench_run_and_check_at_32(tmp_path):
    rows = bench.run((32,), 1, device="cpu")
    assert [r["matcher"] for r in rows] == ["auction", "auction_fr", "auction_fused"]
    assert all(r["converged"] and r["quality_ratio"] <= bench.QUALITY_GATE for r in rows)
    assert bench.check(rows) == []
    # The gates: a slow fused matcher at n >= 256 fails, as in the reference.
    slow = [dict(r, n=256) for r in rows]
    slow[2]["ms_per_dispatch"] = slow[0]["ms_per_dispatch"]
    assert any("auction_fused only" in f for f in bench.check(slow))
    assert bench.check(slow) == _reference_bench().check(slow)
    path = bench.write(rows, "cpu", tmp_path / "BENCH_matching_torch.json")
    assert "perm16+M-bonus" in path.read_text()


def test_gpt_100m_params_round_trip_through_interop():
    """gpt-100m is a dense config: the reference's tree maps onto the port's
    state names and back (at its reduced widths, the same layout)."""
    from repro_torch.interop import params_to_reference
    from repro_torch.models import build_model

    cfg = train_gpt_ocs.gpt_100m().reduced()
    jcfg = JaxModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jparams = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(1)))
    state = params_from_reference(cfg, jparams)
    assert set(state) == set(build_model(cfg, device="cpu").state_dict())
    back = params_to_reference(cfg, state)
    flat_a = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
