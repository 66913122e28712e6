"""The port's dry run on a fake process group, its collectives and its
roofline against the reference, on the CPU.

The fake group is process-global: the fixture below starts it for a test
and destroys it after."""

import inspect
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo import parse_collectives  # noqa: E402
from repro.analysis.roofline import count_params as jax_count_params  # noqa: E402
from repro.analysis.roofline import model_flops as jax_model_flops  # noqa: E402
from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.registry import get_shape as jax_get_shape  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.analysis.collectives import CollectiveStats, LocalCounter  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM, analyze, count_params, kernel_cost, model_flops  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_shape  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.models.registry import param_specs  # noqa: E402


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with dryrun.fake_process_group(256):
        yield
    assert not dist.is_initialized()


def test_sharded_matmul_counts_one_chips_share(fake_group):
    """FLOPs are counted on rank 0's local ops: 1/256 of 2·M·K·N on 16 × 16,
    where a counter above DTensor would see the global product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    M, K, N = 64, 768, 3072
    mesh = make_production_mesh()
    assert tuple(mesh.shape) == (16, 16) and mesh.mesh_dim_names == ("data", "model")
    assert mesh.device_type == "cpu"
    with FakeTensorMode():
        x = distribute_tensor(torch.randn(M, K), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.randn(K, N), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.randn(K, N), mesh, [Shard(0), Shard(1)])
        counter = LocalCounter()
        with counter:
            y = x @ w
        assert tuple(y.shape) == (M, N) and tuple(y._local_tensor.shape) == (M // 16, N // 16)
        assert counter.flops * 256 == 2 * M * K * N
        assert counter.collectives.total_wire_bytes == 0
        # A product that needs a collective: K sharded over data on w2, rows on x.
        counter = LocalCounter()
        with counter:
            x @ w2
    assert counter.flops * 256 == 2 * M * K * N
    assert sum(counter.collectives.ops.values()) >= 1
    assert counter.collectives.total_wire_bytes > 0


def test_collective_stats_equal_the_reference_parser():
    """The records equivalent to the reference's synthetic HLO module."""
    txt = """
  %all-reduce.1 = f32[1024]{0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%sum
  %ag = bf16[64,256]{1,0} all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={1}
  %all-gather-start.2 = (bf16[8,16]{1,0}, bf16[8,64]{1,0}) all-gather-start(%z), replica_groups=[4,4]<=[16]
  %all-gather-done.2 = bf16[8,64]{1,0} all-gather-done(%all-gather-start.2)
  %cp = f32[32]{0} collective-permute(%w), source_target_pairs={{0,1}}
"""
    want = parse_collectives(txt)
    got = CollectiveStats()
    got.add("all-reduce", 16, 1024 * 4)
    got.add("all-gather", 4, 64 * 256 * 2)
    got.add("all-gather", 4, 8 * 64 * 2)
    got.add("collective-permute", 2, 32 * 4)
    assert got.as_dict() == want.as_dict()
    assert got.wire_bytes["all-reduce"] == pytest.approx(2 * 15 / 16 * 4096)
    assert got.total_wire_bytes == want.total_wire_bytes
    for op, g in (("reduce-scatter", 8), ("all-to-all", 4)):
        s = CollectiveStats()
        s.add(op, g, 800)
        assert s.wire_bytes[op] == (g - 1) / g * 800
    with pytest.raises(ValueError):
        CollectiveStats().add("gather", 2, 8)


_REF: dict = {}


def _ref_params(arch):
    if arch not in _REF:
        model = JaxLM(JAX_ARCHS[arch])
        _REF[arch] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return _REF[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_count_params_equal_reference(arch):
    ref = _ref_params(arch)
    port = param_specs(ARCHS[arch])
    assert count_params(port) == jax_count_params(ref)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        got = model_flops(ARCHS[arch], get_shape(shape_name), port)
        want = jax_model_flops(JAX_ARCHS[arch], jax_get_shape(shape_name), ref)
        assert got == want, (arch, shape_name)


def test_analyze_terms_against_the_data_sheet():
    cfg, shape = ARCHS["granite-3-8b"], get_shape("train_4k")
    params = param_specs(cfg)
    trace = {"flops": 989e12, "bytes": 3.35e12, "wire": 450e9 * 2, "collectives": {}}
    r = analyze(trace, cfg, shape, 256, params)
    assert (r.compute_s, r.memory_s, r.collective_s, r.dominant) == (1.0, 1.0, 2.0, "collective")
    assert r.model_flops == model_flops(cfg, shape, params)
    assert r.roofline_fraction == pytest.approx(r.model_flops / 256 / H100_SXM["peak_flops_bf16"] / 2.0)
    assert H100_SXM == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}


def test_run_cell_on_a_reduced_cell(tmp_path, monkeypatch):
    """A reduced granite train_4k cell on the 16 × 16 fake mesh: positive
    terms, collectives of the FSDP/TP step, the calibration's depth-1/2
    extrapolation equal to the full trace, and the CLI's file."""
    import torch.distributed as dist

    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_arch", lambda name: ARCHS[name].reduced())
    art = dryrun.run_cell("granite-3-8b", "train_4k", False)
    assert not dist.is_initialized()
    r = art["roofline"]
    assert art["n_chips"] == 256 and art["kind"] == "train" and art["counts_not_times"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    assert set(r["collectives"]["ops"]) >= {"all-gather", "reduce-scatter"}
    cal = art["calibration"]
    assert cal["applied"] and cal["units"] == 4
    # FLOPs grow exactly a layer at a time; bytes and wire bytes from depth 2
    # on (depth 1's one block is both first and last: its gradients meet one
    # redistribution less), so the extrapolation lands within 1% (0.15% here).
    assert cal["extrapolated"]["flops"] == cal["traced"]["flops"]
    assert cal["rel_diff"]["bytes"] < 1e-2 and cal["rel_diff"]["wire"] < 1e-2
    assert art["bytes_per_device_est"] > art["resident_bytes"]["state_and_inputs"] > 0
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert dryrun.cell_path("a", "b", True) == tmp_path / "a__b__pod2.json"


def test_perf_variants_are_valid_run_cell_kwargs():
    """Every variant carries kwargs ``run_cell`` accepts; the reference's
    variants with no counterpart are named with their reason."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jax_perf
    finally:  # the reference module sets XLA_FLAGS at import
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    valid = set(inspect.signature(dryrun.run_cell).parameters)
    for name, kw in perf.VARIANTS.items():
        assert set(kw) <= valid, f"variant {name} has unknown kwargs"
        inspect.signature(dryrun.run_cell).bind("granite-3-8b", "train_4k", False, **kw)
        assert kw == jax_perf.VARIANTS[name]
    assert set(perf.VARIANTS) | set(perf.OMITTED) == set(jax_perf.VARIANTS)
    assert not set(perf.VARIANTS) & set(perf.OMITTED)
    assert all(kw.get("ssd_impl") == "chunked_scan" for name, kw in jax_perf.VARIANTS.items() if name in perf.OMITTED)
    assert np.all([isinstance(v, str) and v for v in perf.OMITTED.values()])


def test_with_depth_and_scan_units_equal_reference():
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    for arch in ARCHS:
        assert dryrun.scan_units(ARCHS[arch]) == jax_dryrun.scan_units(JAX_ARCHS[arch])
        for n in (1, 2):
            got, want = dryrun.with_depth(ARCHS[arch], n), jax_dryrun.with_depth(JAX_ARCHS[arch], n)
            assert (got.num_layers, got.encoder_layers) == (want.num_layers, want.encoder_layers)


def test_attention_forward_is_counted_at_the_kernels_cost():
    """Under a ``LocalCounter`` a ``flash_attention`` forward counts
    ``kernel_cost``'s FLOPs and bytes (q, k, v read once, o written once)
    and none of the plain ``mha_ref`` ops a CPU tensor runs in its place;
    an attention layer's forward beyond the kernel grows linearly in S (its
    second difference over S = 16, 32, 48 is 0), so no (S, S) tensor is
    counted."""
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.models.blocks import Attention

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 48, 32), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 48, 32), dtype=np.float32)) for _ in range(2))
    counter = LocalCounter()
    with counter:
        mha(q, k, v, causal=True)
    want = kernel_cost("flash_attention", B=2, Hq=4, Hkv=2, Sq=48, Sk=48, D=32, causal=True, window=None, itemsize=4)
    assert (counter.flops, counter.bytes) == want
    assert want[0] == 4 * 2 * 4 * 32 * (48 * 49 // 2)

    cfg = ARCHS["granite-3-8b"].reduced()
    layer = Attention(cfg, torch.Generator().manual_seed(0), with_mlp=False, device="cpu")
    dh = cfg.resolved_head_dim

    def beyond_the_kernel(S):
        x = torch.from_numpy(rng.standard_normal((1, S, cfg.d_model), dtype=np.float32))
        counter = LocalCounter()
        with torch.no_grad(), counter:
            layer(x, positions=torch.arange(S)[None])
        kf, kb = kernel_cost("flash_attention", B=1, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads, Sq=S, Sk=S, D=dh,
                             causal=True, window=None, itemsize=4)
        assert counter.flops_by_op["flash_attention"] == kf
        return counter.flops - kf, counter.bytes - kb

    (f1, b1), (f2, b2), (f3, b3) = (beyond_the_kernel(S) for S in (16, 32, 48))
    assert b3 - 2 * b2 + b1 == 0 and f3 - 2 * f2 + f1 == 0, (b1, b2, b3, f1, f2, f3)


def test_ssd_chunk_is_counted_at_the_kernels_cost():
    """``ssd_chunk`` on a CPU tensor under a ``LocalCounter``: the kernel's
    cost once, none of ``ssd_chunk_ref``'s ops."""
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk

    rng = np.random.default_rng(1)
    BH, S, L, N, P = 3, 64, 16, 8, 4
    xd = torch.from_numpy(rng.standard_normal((BH, S, P), dtype=np.float32))
    loga = torch.from_numpy(-rng.random((BH, S), dtype=np.float32))
    B, C = (torch.from_numpy(rng.standard_normal((BH, S, N), dtype=np.float32)) for _ in range(2))
    counter = LocalCounter()
    with counter:
        ssd_chunk(xd, loga, B, C, L)
    assert (counter.flops, counter.bytes) == kernel_cost("ssd_chunk", BH=BH, S=S, L=L, N=N, P=P, itemsize=4)
    assert counter.flops_by_op == {"ssd_chunk": counter.flops}


def test_query_heads_split_where_the_model_axis_divides_hq_only():
    """granite ``reduced()`` (4 query heads over 1 KV head) traced on a fake
    4 × 2 (data × model) group: the model axis divides Hq but not Hkv, so
    each rank's ``flash_attention`` runs Hq / |model| = 2 query heads on its
    B / 4 = 2 rows, counted at ``kernel_cost`` once a layer (no remat);
    with the heads gathered it would run all 4."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.steps import trace_cell

    cfg = ARCHS["granite-3-8b"].reduced()
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 1)
    with dryrun.fake_process_group(8):
        record, _ = trace_cell(cfg, ShapeCfg("t", 64, 8, "train"), make_debug_mesh(8, model=2), remat=False)
    assert not dist.is_initialized()
    want, _ = kernel_cost("flash_attention", B=2, Hq=2, Hkv=1, Sq=64, Sk=64, D=cfg.resolved_head_dim, causal=True,
                          window=None, itemsize=4)
    assert record["flops_by_op"]["flash_attention"] == cfg.num_layers * want
