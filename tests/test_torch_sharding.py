"""The port's sharding rules against the reference's, on the CPU.

The reference's ``param_pspec`` / ``batch_shardings`` / ``cache_shardings``
read only ``mesh.shape``, so a stub with a ``shape`` dict stands in for a
``jax.sharding.Mesh`` of 256 or 512 devices, and ``NamedSharding`` is
patched to hand back its spec. The reference stacks its layers (a leading
None in the spec), the port does not: the port's spec is the reference's
without the stack dims.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.registry import get_shape as jax_get_shape  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro.train.fault_tolerance import largest_mesh as jax_largest_mesh  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_shape  # noqa: E402
from repro_torch.interop import _TOP, _blocks  # noqa: E402
from repro_torch.models.registry import cache_specs, input_specs, param_specs  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.fault_tolerance import largest_mesh  # noqa: E402


class StubMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)


MESHES = {
    "4x2": {"data": 4, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _norm(spec) -> tuple:
    """A spec as a tuple of None / axis name / tuple of names (1-tuples unwrapped)."""
    out = []
    for ax in tuple(spec):
        if isinstance(ax, (tuple, list)):
            ax = tuple(ax)
            ax = ax[0] if len(ax) == 1 else ax
        out.append(ax)
    return tuple(out)


@pytest.fixture(autouse=True)
def _spec_only(monkeypatch):
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: spec)


_REF_PARAMS: dict = {}
_PORT_PARAMS: dict = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        model = JaxLM(JAX_ARCHS[arch])
        _REF_PARAMS[arch] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def _port_params(arch):
    if arch not in _PORT_PARAMS:
        _PORT_PARAMS[arch] = param_specs(ARCHS[arch])
    return _PORT_PARAMS[arch]


def _ref_leaf(cfg, tree, name: str):
    """(reference path, leaf, stack dims) of the port's state name."""
    if name in _TOP:
        return (jax.tree_util.DictKey(name),), tree[name], 0
    for prefix, path, idx in _blocks(cfg):
        if name.startswith(prefix) and "." not in name[len(prefix):]:
            node, keys = tree, []
            for key in path:
                node = node[key]
                keys.append(jax.tree_util.DictKey(key) if isinstance(key, str) else jax.tree_util.SequenceKey(key))
            leaf_name = name[len(prefix):]
            return (*keys, jax.tree_util.DictKey(leaf_name)), node[leaf_name], 0 if idx is None else 1
    raise KeyError(name)


@pytest.mark.parametrize("mode", ["tp_fsdp", "tp_only"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_reference(arch, mode):
    cfg = ARCHS[arch]
    tree = _ref_params(arch)
    port = _port_params(arch)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(t.numel() for t in port.values()) == n_ref  # the same parameters, unstacked
    for mesh_name, shape in MESHES.items():
        mesh = StubMesh(shape)
        for name, t in port.items():
            path, leaf, lead = _ref_leaf(cfg, tree, name)
            assert tuple(leaf.shape[lead:]) == tuple(t.shape), name
            want = _norm(jax_sharding.param_pspec(path, leaf, mesh, mode))
            got = _norm(sharding.param_pspec(name, t.shape, mesh, mode))
            want = want + (None,) * (leaf.ndim - len(want))
            assert want[:lead] == (None,) * lead, (name, want)
            assert got == want[lead:], (arch, mesh_name, name, got, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_of_specs(mesh_name):
    """Placements have one entry per mesh dim: a dim over ("pod", "data") is
    Shard(d) on both mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = StubMesh(MESHES[mesh_name])
    names = list(MESHES[mesh_name])
    spec = sharding.param_pspec("periods.0.0.we_down", (128, 768, 2048), mesh)
    assert spec == ("model", None, "data")
    pl = sharding.placements(spec, mesh)
    assert len(pl) == len(names)
    assert list(pl) == [{"model": Shard(0), "data": Shard(2)}.get(a, Replicate()) for a in names]
    bspec = sharding.batch_spec((256, 4096), mesh)
    bpl = sharding.placements(bspec, mesh)
    assert all(p == Shard(0) for a, p in zip(names, bpl) if a in ("pod", "data"))
    assert all(p == Replicate() for a, p in zip(names, bpl) if a == "model")


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_shardings_equal_reference(arch, shape_name):
    want_specs = jax_registry.input_specs(JAX_ARCHS[arch], jax_get_shape(shape_name))
    got_specs = input_specs(ARCHS[arch], get_shape(shape_name))
    assert set(got_specs) == set(want_specs)
    for k in want_specs:
        assert tuple(got_specs[k].shape) == tuple(want_specs[k].shape)
        assert got_specs[k].device.type == "meta"
        assert str(got_specs[k].dtype).split(".")[-1] == str(want_specs[k].dtype)
    for mesh_name, shape in MESHES.items():
        mesh = StubMesh(shape)
        want = jax_sharding.batch_shardings(want_specs, mesh)
        got = sharding.batch_shardings(got_specs, mesh)
        for k in want_specs:
            assert _norm(got[k].spec) == _norm(want[k]), (mesh_name, k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_equal_reference(arch, shape_name):
    """Each port cache leaf's spec equals the trailing spec of the reference's
    leaves of the same name and trailing shape (the reference stacks)."""
    want_tree = jax_registry.cache_specs(JAX_ARCHS[arch], jax_get_shape(shape_name))
    got_tree = cache_specs(ARCHS[arch], get_shape(shape_name))
    flat = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    for mesh_name, shape in MESHES.items():
        mesh = StubMesh(shape)
        want_specs = jax.tree_util.tree_flatten_with_path(jax_sharding.cache_shardings(want_tree, mesh))[0]
        got_specs = sharding.cache_shardings(got_tree, mesh)
        ref = {}
        for (path, leaf), (_, spec) in zip(flat, want_specs):
            name = [getattr(e, "key", None) for e in path if isinstance(getattr(e, "key", None), str)][-1]
            ref.setdefault(name, []).append((tuple(leaf.shape), _norm(spec) + (None,) * (leaf.ndim - len(spec))))
        matched = 0
        for name, t in _leaves(got_tree):
            leaf = name.rsplit(".", 1)[-1]
            got = sharding.cache_pspec(name, t.shape, mesh)
            node = got_specs
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) else node[part]
            assert _norm(node.spec) == _norm(got)
            nd = t.ndim
            cands = [s for shp, s in ref.get(leaf, []) if shp[len(shp) - nd:] == tuple(t.shape)]
            assert cands, (arch, name)
            for spec in cands:
                assert spec[len(spec) - nd:] == _norm(got), (arch, mesh_name, name, got, spec)
                assert all(a is None for a in spec[:len(spec) - nd])
            matched += 1
        assert matched > 0


def test_cache_specs_are_meta_and_shaped_like_init_cache():
    cfg = ARCHS["zamba2-1.2b"].reduced()
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.registry import build_model

    spec = cache_specs(cfg, ShapeCfg("d", 64, 2, "decode"))
    real = build_model(cfg, device="cpu").init_cache(2, 64)
    got = dict(_leaves(spec))
    want = dict(_leaves(real))
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "meta" and got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert cache_specs(cfg, ShapeCfg("t", 64, 2, "train")) is None


@pytest.mark.parametrize("prefer_model", [1, 2, 4, 16])
def test_largest_mesh_equals_reference(prefer_model):
    for n in range(1, 65):
        assert largest_mesh(n, prefer_model=prefer_model) == jax_largest_mesh(n, prefer_model=prefer_model)
    assert largest_mesh(6, prefer_model=2) == (3, 2)


@pytest.mark.parametrize("mesh_name", ["4x2", "16x16", "2x16x16"])
def test_activation_constraint_shards_the_batch(mesh_name):
    """The constraint between blocks places (B, S, D) as the reference's
    ``P(("pod", "data"), "model", None)`` does: the batch over the batch
    axes, the sequence over model; a dim they do not divide (a decode step's
    S = 1, a batch of 3) is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = StubMesh(MESHES[mesh_name])
    mesh.mesh_dim_names, mesh.shape = tuple(MESHES[mesh_name]), tuple(MESHES[mesh_name].values())
    spec = sharding.default_act_pspec(mesh)
    got = sharding.fit_placements(spec, (512, 4096, 64), mesh)
    assert got == tuple(Shard(1) if a == "model" else Shard(0) for a in MESHES[mesh_name])
    got = sharding.fit_placements(spec, (3, 1, 64), mesh)
    assert got == tuple(Replicate() for _ in MESHES[mesh_name])


def test_default_act_pspec_and_modes():
    mesh = StubMesh(MESHES["2x16x16"])
    assert _norm(sharding.default_act_pspec(mesh)) == _norm(jax_sharding.default_act_pspec(mesh))
    with pytest.raises(ValueError):
        sharding.param_pspec("wq", (64, 64), mesh, "zero3")
    assert sharding.param_pspec("final_norm", (64,), mesh) == (None,)
