"""The port's public API against the reference's, name for name.

(a) and (b) read both packages' sources with ``ast``: every public
top-level function, class, method and constant of a reference module with
a twin exists in the twin (under the renames of ``NAME_MAP``) or stands in
``NOT_PORTED`` with its reason, and every name a reference package exports
has its counterpart exported by the twin package. The rest runs both on
the CPU at small sizes: the matcher registry and the default-matcher
policy, the routing of a registered matcher through every consumer, the
traffic model's collectives, ``spectra_torch`` / ``lower_bound`` against
``spectra_jax`` / ``lower_bounds_many``, and the package data the kernel
build reads.
"""

import ast
import fnmatch
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Reference module → the port's module that takes its place.
MODULE_MAP = {
    "core/jaxopt": "core/torchopt",
    "api/jax_backend.py": "api/torch_backend.py",
    "analysis/hlo.py": "analysis/collectives.py",
}

# Reference name → the port's name (besides ``_jax`` → ``_torch``). Every
# port function takes a leading batch dimension, so the single-instance and
# the batched entry points of the reference share one counterpart.
NAME_MAP = {
    "decompose_jax": "decompose",
    "decompose_jax_prices": "decompose_prices",
    "lpt_schedule_jax": "lpt_schedule",
    "JaxDecomposition": "TorchDecomposition",
    "equalize_jax": "equalize_torch",
    "online_step_jax": "online_step",
    "lower_bound_jax": "lower_bound",
    "lower_bounds_many": "lower_bound",
    "spectra_jax_e2e": "spectra_torch_e2e_many",
    "spectra_jax_e2e_many": "spectra_torch_e2e_many",
    "spectra_jax": "spectra_torch",
    "lower_cell": "trace_cell",
}

_NO_KNOB = "the port has no use_kernel knob: a tensor's device picks the kernel or its plain version"
_MODULES = "the blocks are nn.Modules in the port (models/blocks.py's Attention, Mamba2, MoE)"
_NO_HLO = ("the port has no HLO; analysis/collectives.py::LocalCounter counts the collectives and "
           "analysis/roofline.py::H100_SXM is the data sheet")
NOT_PORTED = {
    "kernels/backend.py::default_use_kernel": _NO_KNOB,
    "kernels/backend.py::on_tpu": _NO_KNOB,
    "kernels/backend.py::resolve_use_kernel": _NO_KNOB,
    "core/jaxopt/equalize_jax.py::equalize_ir_jit": "eager PyTorch has no jit variant; equalize_ir is the one entry",
    "analysis/hlo.py::parse_collectives": _NO_HLO,
    "analysis/roofline.py::TPU_V5E": _NO_HLO,
    "analysis/roofline.py::Roofline.hlo_flops_per_chip": _NO_HLO + " (Roofline.flops_per_chip)",
    "analysis/roofline.py::Roofline.hlo_bytes_per_chip": _NO_HLO + " (Roofline.bytes_per_chip)",
    "models/blocks.py::attn_init": _MODULES,
    "models/blocks.py::attn_apply": _MODULES,
    "models/blocks.py::mamba_init": _MODULES,
    "models/blocks.py::mamba_apply": _MODULES,
    "models/blocks.py::moe_init": _MODULES,
    "models/blocks.py::moe_apply": _MODULES,
    "kernels/flash_attention/ref.py::mha_chunked": (
        "a lowering path of the reference (attn_impl); the dry run counts flash_attention at its "
        "kernel_cost and the launchers run the kernel"
    ),
}


def _twin(rel: Path) -> Path:
    s = rel.as_posix()
    for a, b in MODULE_MAP.items():
        s = s.replace(a, b)
    return PORT / s.replace("_jax.py", "_torch.py")


def _public_names(path: Path, fields: bool = False) -> set[str]:
    """Public top-level functions, classes and UPPERCASE constants, and the
    public methods and method aliases of each class (with ``fields``, its
    annotated fields too)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        names = [sub.name]
                    elif isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Name):
                        names = [t.id for t in sub.targets if isinstance(t, ast.Name)]
                    elif fields and isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                        names = [sub.target.id]
                    else:
                        names = []
                    out |= {f"{node.name}.{x}" for x in names if not x.startswith("_")}
        else:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign) else [])
            out |= {t.id for t in targets
                    if isinstance(t, ast.Name) and t.id.isupper() and not t.id.startswith("_")}
    return out


def _port_name(name: str) -> str:
    head, _, attr = name.partition(".")
    head = NAME_MAP.get(head, head.replace("_jax", "_torch").replace("Jax", "Torch"))
    return f"{head}.{attr}" if attr else head


def _twinned_modules():
    return [p.relative_to(REF) for p in sorted(REF.rglob("*.py")) if _twin(p.relative_to(REF)).exists()]


@pytest.mark.parametrize("rel", _twinned_modules(), ids=lambda r: r.as_posix())
def test_every_reference_name_has_a_port_counterpart(rel):
    theirs = _public_names(REF / rel)
    ours = _public_names(_twin(rel))
    missing = sorted(
        name for name in theirs
        if name not in ours and _port_name(name) not in ours and f"{rel.as_posix()}::{name}" not in NOT_PORTED
    )
    assert not missing, f"{rel}: no counterpart in {_twin(rel).relative_to(ROOT)} and no reason: {missing}"


def test_not_ported_names_exist_in_the_reference_and_have_reasons():
    for key, reason in NOT_PORTED.items():
        mod, name = key.split("::")
        assert reason.strip(), key
        assert name in _public_names(REF / mod, fields=True), f"{key} is not a reference name"
        assert _port_name(name) not in _public_names(_twin(Path(mod)), fields=True), f"{key} is ported"


def test_the_perf_variants_are_ported_or_omitted_with_a_reason():
    from repro_torch.launch import perf

    tree = ast.parse((REF / "launch" / "perf.py").read_text())
    variants = next(
        n.value for n in tree.body
        if isinstance(n, ast.Assign) and any(getattr(t, "id", None) == "VARIANTS" for t in n.targets)
    )
    names = [ast.literal_eval(k) for k in variants.keys]
    assert names
    for name in names:
        assert name in perf.VARIANTS or perf.OMITTED.get(name, "").strip(), name


def _exports(path: Path) -> set[str]:
    """``__all__`` of a package's ``__init__.py`` (starred tuples resolved),
    else the names it imports."""
    tree = ast.parse(path.read_text())
    consts = {n.targets[0].id: n.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}

    def names(node):
        out = []
        for e in node.elts:
            out += names(consts[e.value.id]) if isinstance(e, ast.Starred) else [ast.literal_eval(e)]
        return out

    if "__all__" in consts:
        return set(names(consts["__all__"]))
    return {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names}


_NOT_EXPORTED = {"core/jaxopt/equalize_ir_jit": NOT_PORTED["core/jaxopt/equalize_jax.py::equalize_ir_jit"]}


def _packages():
    return [p.relative_to(REF) for p in sorted(REF.rglob("__init__.py"))]


@pytest.mark.parametrize("rel", _packages(), ids=lambda r: r.parent.as_posix() or "repro")
def test_every_reference_export_is_exported_by_the_twin(rel):
    twin = _twin(rel)
    assert twin.exists(), f"{rel} has no twin package"
    theirs, ours = _exports(REF / rel), _exports(twin)
    missing = sorted(
        name for name in theirs
        if _port_name(name) not in ours and f"{rel.parent.as_posix()}/{name}" not in _NOT_EXPORTED
    )
    assert not missing, f"{twin.relative_to(ROOT)} does not export {missing}"


def test_the_torchopt_exports_import_and_name_the_registry():
    import repro_torch.core.torchopt as t
    import repro_torch.traffic as tr

    for mod in (t, tr):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    for name in ("match_auction_fused", "default_matcher", "register_matcher", "set_default_matcher_policy",
                 "spectra_torch", "lower_bound"):
        assert name in t.__all__, name


# ---------------------------------------------------------------------------
# (c) default_matcher and its policy, against the reference's.
# ---------------------------------------------------------------------------

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core.jaxopt.matching as jm  # noqa: E402
import repro_torch.core.torchopt.matching as tm  # noqa: E402
from repro.core.jaxopt.decompose_jax import spectra_jax  # noqa: E402
from repro.core.jaxopt.lower_bounds_jax import lower_bounds_many  # noqa: E402
from repro_torch.api import SolveOptions, solve_many  # noqa: E402
from repro_torch.core.torchopt import (  # noqa: E402
    decompose,
    lower_bound,
    spectra_online_scan,
    spectra_torch,
    spectra_torch_e2e_many,
)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def both_policies():
    """Installs a policy in both packages; restores both afterwards."""
    def install(policy):
        jm.set_default_matcher_policy(policy)
        tm.set_default_matcher_policy(policy)
    try:
        yield install
    finally:
        jm.set_default_matcher_policy(None)
        tm.set_default_matcher_policy(None)


def _n_dependent(n):
    return "auction" if n <= 16 else "auction_fr" if n <= 200 else "auction_fused"


@pytest.mark.parametrize("policy", [None, lambda n: "auction", _n_dependent],
                         ids=["thresholds", "constant", "n_dependent"])
def test_default_matcher_equals_the_references(both_policies, policy):
    both_policies(policy)
    assert [tm.default_matcher(n) for n in range(1, 301)] == [jm.default_matcher(n) for n in range(1, 301)]
    both_policies(None)
    assert [tm.default_matcher(n) for n in range(1, 301)] == [jm.default_matcher(n) for n in range(1, 301)]
    assert tm.default_matcher(100) == "auction_fr"


def _raised(fn, kind):
    with pytest.raises(kind) as info:
        fn()
    return str(info.value)


def test_policy_and_registry_errors_equal_the_references(both_policies):
    for mod in (tm, jm):
        assert "unknown matcher" in _raised(lambda: mod.set_default_matcher_policy(lambda n: "nope"), KeyError)
        assert mod._DEFAULT_POLICY is None  # a refused policy is not installed
    assert (_raised(lambda: tm.set_default_matcher_policy(lambda n: "nope"), KeyError)
            == _raised(lambda: jm.set_default_matcher_policy(lambda n: "nope"), KeyError))
    both_policies(lambda n: "auction" if n <= 8 else "nope")
    assert tm.default_matcher(8) == jm.default_matcher(8) == "auction"
    port_msg = _raised(lambda: tm.default_matcher(9), KeyError)
    assert "default matcher policy returned unknown matcher 'nope' for n=9" in port_msg
    assert port_msg == _raised(lambda: jm.default_matcher(9), KeyError)
    assert (_raised(lambda: tm.register_matcher("auction", tm.match_auction), ValueError)
            == _raised(lambda: jm.register_matcher("auction", jm.match_auction), ValueError))
    assert "already registered" in _raised(lambda: tm.register_matcher("auction_fr", tm.match_auction), ValueError)
    assert tm.MATCHERS["auction_fr"] is tm.match_auction_fr


# ---------------------------------------------------------------------------
# (d) A registered matcher is the one every consumer runs.
# ---------------------------------------------------------------------------

def _demand(rng, B, n, density=0.4):
    return np.stack([np.where(rng.random((n, n)) < density, rng.random((n, n)), 0.0) + np.eye(n) * 0.05
                     for _ in range(B)])


@pytest.fixture
def counting():
    """``"counting"``: ``match_auction`` behind a wrapper that counts its calls."""
    calls = []

    def fn(W, **kw):
        calls.append(tuple(W.shape))
        return tm.match_auction(W, **kw)

    tm.register_matcher("counting", fn)
    try:
        yield calls
    finally:
        tm.MATCHERS.pop("counting", None)
        tm.set_default_matcher_policy(None)


def _via_decompose(D, matcher):
    dec = decompose(torch.as_tensor(D, dtype=torch.float32), matcher=matcher)
    return [dec.perms.numpy(), dec.alphas.numpy(), dec.k.numpy()]


def _via_e2e(D, matcher):
    res = spectra_torch_e2e_many(D, 2, 0.01, device="cpu", matcher=matcher)
    return [res.makespan.numpy(), res.dec.alphas.numpy()]


def _via_solve_many(D, matcher):
    reps = solve_many(D, 2, 0.01, solver="spectra_torch", options=SolveOptions(extra={**CPU, "matcher": matcher}))
    assert {r.extras["matcher"] for r in reps} == {matcher}
    return [np.array([r.makespan for r in reps])]


def _via_scan(D, matcher):
    res, _ = spectra_online_scan(D, 2, 0.01, device="cpu", matcher=matcher, cache_size=2)
    return [res.makespan.numpy(), res.warm.numpy(), res.schedule.alphas.numpy()]


def _via_run_scenario(D, matcher):
    from repro_torch.scenarios import run_scenario

    rep = run_scenario("gpt", solver="spectra_torch", online=True, n=8, periods=3,
                       options=SolveOptions(extra={**CPU, "matcher": matcher}))
    s = rep.online_summary()
    return [np.array([s["online_total_makespan"], s["stateless_total_makespan"]]), rep.online_makespans]


def _via_service(D, matcher):
    from repro_torch.serve import SolverService

    svc = SolverService(2, 0.01, solver="spectra_torch", options=SolveOptions(extra={**CPU, "matcher": matcher}))
    for x in D:
        svc.submit(x)
    reps = list(svc.flush().values())
    assert {r.extras["matcher"] for r in reps} == {matcher}
    return [np.array([r.makespan for r in reps])]


@pytest.mark.parametrize("via", [_via_decompose, _via_e2e, _via_solve_many, _via_scan, _via_run_scenario,
                                 _via_service], ids=lambda f: f.__name__[5:])
def test_a_registered_matcher_is_the_one_each_consumer_runs(counting, via):
    D = _demand(np.random.default_rng(3), 3, 8)
    got = via(D, "counting")
    assert counting, "the registered matcher was never called"
    want = via(D, "auction")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_policy_reaches_solve_many_and_the_scan(counting):
    D = _demand(np.random.default_rng(4), 2, 8)
    want = _via_solve_many(D, "auction")
    tm.set_default_matcher_policy(lambda n: "counting")
    reps = solve_many(D, 2, 0.01, solver="spectra_torch", options=SolveOptions(extra=CPU))
    assert {r.extras["matcher"] for r in reps} == {"counting"} and len(counting) > 0
    np.testing.assert_array_equal([r.makespan for r in reps], want[0])
    from repro_torch.scenarios import run_scenario

    counting.clear()
    run_scenario("gpt", solver="spectra_torch", online=True, n=8, periods=2, options=SolveOptions(extra=CPU))
    assert counting


def test_overwrite_takes_effect_at_the_next_call():
    D = torch.as_tensor(_demand(np.random.default_rng(5), 2, 8), dtype=torch.float32)
    want = decompose(D)
    calls = []

    def fn(W, **kw):
        calls.append(1)
        return tm.match_auction(W, **kw)

    try:
        tm.register_matcher("auction", fn, overwrite=True)
        got = decompose(D)
    finally:
        tm.register_matcher("auction", tm.match_auction, overwrite=True)
    assert calls
    assert torch.equal(got.perms, want.perms) and torch.equal(got.alphas, want.alphas)
    calls.clear()
    decompose(D)
    assert not calls and tm.MATCHERS["auction"] is tm.match_auction


# ---------------------------------------------------------------------------
# (e) The same policy in both packages: the same matcher, the same makespans.
# ---------------------------------------------------------------------------

def test_policy_parity_with_the_reference(both_policies):
    from repro.api import solve_many as ref_solve_many

    both_policies(lambda n: "auction_fr")
    D = _demand(np.random.default_rng(6), 4, 8)
    mine = solve_many(D, 2, 0.01, solver="spectra_torch", options=SolveOptions(extra=CPU))
    ref = ref_solve_many(D, 2, 0.01, solver="spectra_jax")
    assert [r.extras["matcher"] for r in mine] == [r.extras["matcher"] for r in ref] == ["auction_fr"] * 4
    np.testing.assert_allclose([r.makespan for r in mine], [r.makespan for r in ref], rtol=1e-4)


# ---------------------------------------------------------------------------
# (f) TrafficModel's collectives, exactly the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_traffic_model_collectives_equal_the_references(seed):
    from repro.traffic import Placement as RefPlacement
    from repro.traffic import TrafficModel as RefTrafficModel
    from repro_torch.traffic import Placement, TrafficModel

    rng = np.random.default_rng(seed)
    cpr = int(rng.choice([1, 2, 4]))
    chips = cpr * int(rng.integers(3, 9))
    ours, theirs = TrafficModel(Placement(chips, cpr)), RefTrafficModel(RefPlacement(chips, cpr))
    assert TrafficModel.ring_reducescatter is TrafficModel.ring_allgather
    for op in ("ring_allreduce", "ring_allgather", "ring_reducescatter", "all_to_all", "weighted_all_to_all", "p2p"):
        for _ in range(3):
            g = int(rng.integers(1, chips + 1))
            group = [int(x) for x in rng.choice(chips, size=g, replace=False)]
            if op == "p2p":
                args = (group[0], group[-1], float(rng.random() * 1e6))
            elif op == "weighted_all_to_all":
                args = (group, rng.random((g, g)) * 1e6)
            else:
                args = (group, float(rng.random() * 1e6))
            getattr(ours, op)(*args)
            getattr(theirs, op)(*args)
    assert np.array_equal(ours.demand_bytes, theirs.demand_bytes)
    assert ours.demand_bytes.sum() > 0


# ---------------------------------------------------------------------------
# (g) spectra_torch and the batch's one δ.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
def test_spectra_torch_equals_spectra_jax_lane_by_lane(matcher):
    D = _demand(np.random.default_rng(7), 4, 8)
    dec, assignment, loads, makespan = spectra_torch(D, 2, 0.01, matcher=matcher, device="cpu")
    assert assignment.shape == (4, 8) and loads.shape == (4, 2) and makespan.shape == (4,)
    for b in range(4):
        rdec, rassign, rloads, rmk = spectra_jax(jnp.asarray(D[b], jnp.float32), 2, 0.01, matcher=matcher)
        assert int(dec.k[b]) == int(rdec.k)
        np.testing.assert_allclose(dec.alphas[b].numpy(), np.asarray(rdec.alphas), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(assignment[b].numpy(), np.asarray(rassign))
        np.testing.assert_allclose(loads[b].numpy(), np.asarray(rloads), rtol=1e-4)
        np.testing.assert_allclose(float(makespan[b]), float(rmk), rtol=1e-4)


@pytest.mark.parametrize("s", [2, 3])
def test_lower_bound_takes_one_delta_for_the_batch(s):
    D = _demand(np.random.default_rng(8 + s), 4, 8, density=0.3)
    got = lower_bound(torch.as_tensor(D, dtype=torch.float32), s, 0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(lower_bounds_many(jnp.asarray(D, jnp.float32), s, 0.02)),
                               rtol=1e-5)
    vec = lower_bound(torch.as_tensor(D, dtype=torch.float32), s, torch.full((4,), 0.02))
    assert torch.equal(got, vec)


# ---------------------------------------------------------------------------
# (h) The package data holds every file the kernel build reads.
# ---------------------------------------------------------------------------

def test_package_data_ships_every_kernel_build_input():
    from repro_torch.kernels import backend

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    globs = data["repro_torch"]
    inputs = backend._inputs()
    assert any(p.suffix == ".cuh" for p in inputs)
    for path in inputs:
        rel = path.relative_to(PORT).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is read by the build but not shipped"
