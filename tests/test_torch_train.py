"""The port's training path against the JAX reference, on the CPU.

Both sides start from the same state: the reference's ``LM.init`` tree and
``AdamW.init`` state, taken out as numpy arrays, load into the port through
``interop.params_from_reference`` and ``opt_state_from_reference``. The
reference differentiates its plain chunked functions
(``LM(cfg, attn_impl="chunked", ssd_impl="chunked")``, as its training
launcher builds it); the port runs on ``device="cpu"``, where its kernels
take their plain versions. Tolerances: the schedules and one AdamW update
to 1e-6 (float32, one op order apart); loss and every gradient to 1e-4 of
each tensor's largest entry (float32 sums in other orders through a few
layers); the SSD backward to 1e-4.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.pipeline import make_stream as jax_make_stream  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.parallel.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    opt_state_from_reference,
    opt_state_to_reference,
    params_from_reference,
)
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel.steps import make_optimizer, make_serve_step, make_train_step  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

LOSS_ARCHS = ["zamba2-1.2b", "mamba2-2.7b", "minicpm-2b", "gemma3-27b"]
S = 48  # > gemma3's reduced window of 16, so its local layers really cut


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is about as fast, and
    does not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, seed=0):
    """(port config, port model, reference model, reference params as numpy)."""
    cfg = ARCHS[arch].reduced()
    jmodel = JaxLM(JAX_ARCHS[arch].reduced(), attn_impl="chunked", ssd_impl="chunked")
    jparams = _np(jmodel.init(jax.random.PRNGKey(seed)))
    return cfg, build_model(cfg, device="cpu"), jmodel, jparams


def _tokens(cfg, B=2, step=0):
    return jax_make_stream(cfg.vocab_size, S, B).next_batch(step)["tokens"]


def _assert_tensors_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30), err_msg=k)


# ---------------------------------------------------------------------------
# Optimizer and schedules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["warmup_stable_decay", "cosine_schedule"])
def test_schedules_match_reference(name):
    want = getattr(jopt, name)(3e-4, 50)
    got = getattr(topt, name)(3e-4, 50)
    for step in range(0, 56):
        assert float(got(step)) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12)
    assert float(got(torch.tensor(7, dtype=torch.int32))) == pytest.approx(float(want(7)), rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e3, None])
def test_adamw_update_matches_reference(clip):
    """One update from a nonzero state at step 3, float32 and bfloat16
    parameters. Moments and float32 parameters to 1e-6; bfloat16 parameters
    to one bf16 ulp (the float32 update rounds to the nearest bf16, and an
    update one float32 ulp apart may round the other way)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 8), "b": (8,), "c": (4, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["c16"] = rng.standard_normal((8, 8)).astype(np.float32)
    grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32) for k, v in params.items()}
    mu = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
    nu = {k: (rng.random(v.shape) * 0.1).astype(np.float32) for k, v in params.items()}

    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "c16" else jnp.float32) for k, v in params.items()}
    jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in grads.items()}
    jstate = {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu), "step": jnp.int32(3)}
    jo = jopt.AdamW(schedule=jopt.warmup_stable_decay(3e-3, 10), clip_norm=clip)
    want_p, want_s = jo.update(jg, jstate, jp)

    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16 if k == "c16" else torch.float32)
          for k, v in jp.items()}
    tg = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tp[k].dtype) for k, v in jg.items()}
    tstate = {"mu": {k: torch.from_numpy(v) for k, v in mu.items()},
              "nu": {k: torch.from_numpy(v) for k, v in nu.items()}, "step": torch.tensor(3, dtype=torch.int32)}
    to = topt.AdamW(schedule=topt.warmup_stable_decay(3e-3, 10), clip_norm=clip)
    got_p, got_s = to.update(tg, tstate, tp)

    assert int(got_s["step"]) == int(want_s["step"]) == 4
    for k in params:
        for name in ("mu", "nu"):
            w = np.asarray(want_s[name][k])
            np.testing.assert_allclose(got_s[name][k].numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
        assert got_p[k].dtype == tp[k].dtype and got_s["mu"][k].dtype == torch.float32
        w = np.asarray(want_p[k].astype(jnp.float32))
        g = got_p[k].float().numpy()
        if k == "c16":
            np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    # The inputs are left as they were.
    assert torch.equal(tstate["mu"]["a"], torch.from_numpy(mu["a"]))
    # The train step hands over the norm it already formed: the same update.
    again_p, _ = to.update(tg, tstate, tp, grad_norm=topt.global_norm(tg))
    assert all(torch.equal(again_p[k], got_p[k]) for k in got_p)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (3,), (2, 2, 2))]
    want = float(jopt.global_norm([jnp.asarray(a) for a in leaves]))
    got = float(topt.global_norm([torch.from_numpy(a) for a in leaves]))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17)])
def test_token_stream_bit_identical(seed, step):
    want = np.asarray(jax_make_stream(32000, 64, 3, seed=seed).next_batch(step)["tokens"])
    stream = make_stream(32000, 64, 3, seed=seed, device="cpu")
    got = stream.next_batch(step)["tokens"]
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert stream.state(step) == {"step": step, "seed": seed}


# ---------------------------------------------------------------------------
# Loss and gradients.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, model, jmodel, jparams = _pair(arch)
    tokens = _tokens(cfg)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": tokens}), has_aux=True))(jax.tree.map(jnp.asarray, jparams))

    params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
    with model.bound(params):
        loss, metrics = model.loss({"tokens": torch.from_numpy(np.array(tokens))})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(float(want_m["ce"]), rel=1e-5)
    _assert_tensors_close(grads, params_from_reference(cfg, _np(want_g)), 1e-4)
    # The model's own parameters are back in place and got no gradient.
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())


def test_loss_mask_matches_reference():
    cfg, model, jmodel, jparams = _pair("minicpm-2b")
    tokens = _tokens(cfg)
    mask = (np.random.default_rng(2).random(np.array(tokens).shape) < 0.6).astype(np.float32)
    want, _ = jmodel.loss(jax.tree.map(jnp.asarray, jparams), {"tokens": tokens, "loss_mask": jnp.asarray(mask)})
    model.load_state_dict(params_from_reference(cfg, jparams))
    got, _ = model.loss({"tokens": torch.from_numpy(np.array(tokens)), "loss_mask": torch.from_numpy(mask)})
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_remat_gives_the_same_gradients():
    """``remat`` recomputes each block in the backward: the same loss and
    gradients as without it, bit for bit on the CPU."""
    cfg, model, _, jparams = _pair("zamba2-1.2b")
    batch = {"tokens": torch.from_numpy(np.array(_tokens(cfg)))}
    out = []
    for remat in (False, True):
        model.remat = remat
        params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
        with model.bound(params):  # the recompute runs in the backward, inside the binding
            loss, _ = model.loss(batch)
            out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bound_rejects_foreign_names():
    cfg, model, _, _ = _pair("mamba2-2.7b")
    params = model.init(0)
    params["bogus"] = params.pop("embed")
    with pytest.raises(KeyError):
        with model.bound(params):
            pass


def test_init_is_functional_and_seeded():
    cfg, model, _, _ = _pair("zamba2-1.2b")
    a, b, c = model.init(3), model.init(3), model.init(4)
    assert set(a) == set(dict(model.named_parameters()))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


# ---------------------------------------------------------------------------
# Train steps.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "minicpm-2b"])
def test_train_steps_follow_reference_trajectory(arch):
    """Three steps from one (params, opt_state). Each step's loss to 1e-5
    relative, its grad norm to 1e-4 and its learning rate to 1e-6. The
    parameters' three-step updates to 2e-3 of each tensor's update norm,
    and no entry further than one step's learning rate: AdamW divides by
    √ν, so where a gradient is at rounding level its sign, and a step of up
    to ~lr, follows the rounding (measured: 4e-4 and 0.12·lr)."""
    lr = 3e-3
    cfg, model, jmodel, jparams = _pair(arch)
    jo = jopt.AdamW(schedule=jopt.warmup_stable_decay(lr, 10))
    jstate = _np(jo.init(jparams))
    to = topt.AdamW(schedule=topt.warmup_stable_decay(lr, 10))
    params = params_from_reference(cfg, jparams)
    start = {k: v.clone() for k, v in params.items()}
    state = opt_state_from_reference(cfg, jstate)
    jstep = jax.jit(jax_make_train_step(jmodel, jo))
    tstep = make_train_step(model, to)
    jp, js = jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, jstate)
    stream = jax_make_stream(cfg.vocab_size, S, 2)
    for step in range(3):
        tokens = stream.next_batch(step)["tokens"]
        jp, js, jm = jstep(jp, js, {"tokens": tokens})
        params, state, m = tstep(params, state, {"tokens": torch.from_numpy(np.array(tokens))})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state["step"]) == int(js["step"]) == 3
    want = params_from_reference(cfg, _np(jp))
    for k in want:
        d_got, d_want = params[k] - start[k], want[k] - start[k]
        assert float((d_got - d_want).norm()) <= 2e-3 * float(d_want.norm()), k
        assert float((d_got - d_want).abs().max()) <= lr, k
    _assert_tensors_close(state["mu"], params_from_reference(cfg, _np(js["mu"])), 2e-3)
    ref_state = opt_state_to_reference(cfg, state)
    assert ref_state["step"] == np.int32(3) and ref_state["mu"].keys() == js["mu"].keys()


def test_train_step_leaves_its_inputs():
    cfg, model, _, _ = _pair("mamba2-2.7b")
    opt = topt.AdamW(schedule=topt.warmup_stable_decay(3e-3, 10))
    params = model.init(0)
    state = opt.init(params)
    before = {k: v.clone() for k, v in params.items()}
    batch = make_stream(cfg.vocab_size, S, 2, device="cpu").next_batch(0)
    new, new_state, m = make_train_step(model, opt)(params, state, batch)
    assert all(torch.equal(before[k], params[k]) for k in params)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert any(not torch.equal(new[k], params[k]) for k in params)
    assert set(m) == {"loss", "grad_norm", "lr"}


def test_serve_step_is_greedy_decode():
    """``make_serve_step`` with a params dict gives the argmax of the
    model's own decode step on the same weights, and advances the cache."""
    cfg, model, _, jparams = _pair("zamba2-1.2b")
    params = params_from_reference(cfg, jparams)
    model.load_state_dict(params)
    tokens = torch.tensor([[3], [7]], dtype=torch.int32)
    serve = make_serve_step(build_model(cfg, device="cpu", seed=5))  # its own weights are not used
    nxt, cache = serve(params, model.init_cache(2, 8), tokens)
    with torch.no_grad():
        logits, _ = model.decode_step(model.init_cache(2, 8), tokens)
    assert nxt.dtype == torch.int32 and torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
    assert cache["groups"][0]["attn"]["pos"] == 1
    opt = make_optimizer(total_steps=100, peak_lr=1e-3)
    assert float(opt.schedule(50)) == pytest.approx(1e-3)


def test_bf16_train_step_keeps_types():
    cfg = replace(ARCHS["zamba2-1.2b"].reduced(), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    opt = topt.AdamW(schedule=topt.warmup_stable_decay(3e-3, 10))
    params = model.init(0)
    state = opt.init(params)
    batch = make_stream(cfg.vocab_size, S, 2, device="cpu").next_batch(0)
    new, new_state, m = make_train_step(model, opt)(params, state, batch)
    assert all(new[k].dtype == torch.bfloat16 for k in new)
    assert all(v.dtype == torch.float32 for v in new_state["mu"].values())
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# The SSD backward: the plain chunked recompute.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,S_,N,P", [(3, 64, 8, 16), (2, 40, 16, 8)])
def test_ssd_backward_matches_reference(BH, S_, N, P):
    rng = np.random.default_rng(BH * 100 + S_)
    xd = rng.standard_normal((BH, S_, P)).astype(np.float32)
    loga = (-0.5 * rng.random((BH, S_))).astype(np.float32)
    B = (rng.standard_normal((BH, S_, N)) / np.sqrt(N)).astype(np.float32)
    C = (rng.standard_normal((BH, S_, N)) / np.sqrt(N)).astype(np.float32)
    h0 = rng.standard_normal((BH, N, P)).astype(np.float32)
    gy = rng.standard_normal((BH, S_, P)).astype(np.float32)
    gh = rng.standard_normal((BH, N, P)).astype(np.float32)

    def objective(fn):
        def f(*args):
            y, hT = fn(*args)
            return (y * gy).sum() + (hT * gh).sum()
        return f

    jargs = [jnp.asarray(a) for a in (xd, loga, B, C, h0)]
    want_chunked = jax.grad(objective(jax_ssd_chunked), argnums=range(5))(*jargs)
    want_vjp = jax.grad(objective(lambda *a: jax_ssd_scan(*a, impl="pallas", interpret=True)),
                        argnums=range(5))(*jargs)
    for fn in (ssd_scan, ssd_chunked):
        targs = [torch.from_numpy(a).requires_grad_() for a in (xd, loga, B, C, h0)]
        y, hT = fn(*targs)
        got = torch.autograd.grad((y, hT), targs, (torch.from_numpy(gy), torch.from_numpy(gh)))
        for name, g, w1, w2 in zip(("xd", "loga", "B", "C", "h0"), got, want_chunked, want_vjp):
            for w in (np.asarray(w1), np.asarray(w2)):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)
