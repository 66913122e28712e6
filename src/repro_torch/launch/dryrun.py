"""Multi-pod dry run: trace every (arch × shape × mesh) cell's sharded step
on a fake process group and count one chip's work (``repro.launch.dryrun``).

For each live cell (the long_500k cells of full-attention archs are skipped,
as in the reference):
  * start a ``fake`` process group of 256 (16 × 16) or 512 (2 × 16 × 16)
    ranks and build the production mesh on it;
  * run the cell's step once (train: the sharded train step over
    parameters, AdamW moments and batch; prefill: the forward; decode: the
    serve step over the caches) under ``FakeTensorMode`` with CPU fake
    tensors, so nothing is allocated and the kernels' plain versions trace
    (``parallel.steps.trace_cell``);
  * count rank 0's local ops: FLOPs, bytes, and the collectives' wire bytes
    by kind (``analysis.collectives``), and its resident bytes;
  * write the three roofline terms against the H100 SXM data sheet
    (``analysis.roofline``) to build/repro_torch/dryrun/<cell>.json.

These are counts on a fake mesh, not timings. A failed trace fails the cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  ... dryrun --arch qwen3-moe-30b-a3b --shape train_4k              # one cell
  ... dryrun --multi-pod / --single-pod                             # mesh select
  ... dryrun --force                                                # recompute
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"
_KEYS = ("flops", "bytes", "wire")


def with_depth(cfg, n_units: int):
    """Same-structure config with n_units scan repeats (remainders kept)."""
    if cfg.pattern_local:
        period = cfg.pattern_local + cfg.pattern_global
        rem = cfg.num_layers % period
        return dataclasses.replace(cfg, num_layers=n_units * period + rem)
    if cfg.attn_every:
        rem = cfg.num_layers % cfg.attn_every
        return dataclasses.replace(cfg, num_layers=n_units * cfg.attn_every + rem)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=n_units, encoder_layers=n_units)
    return dataclasses.replace(cfg, num_layers=n_units)


def scan_units(cfg) -> int:
    """The number of scanned blocks of the layer stack in the full config."""
    if cfg.pattern_local:
        return cfg.num_layers // (cfg.pattern_local + cfg.pattern_global)
    if cfg.attn_every:
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process is rank
    0; collectives do nothing), destroyed on exit. An initialised group of
    the same size is used as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; the cell needs {world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _quiet_dtensor_logs() -> None:
    """DTensor warns once per rank about CPU meshes lacking all-to-all and
    sequential all-reduces; the dry run reports its collectives itself."""
    for name in ("torch.distributed.tensor._redistribute", "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, remat: bool = True, sp: bool = True,
             donate: bool = True, calibrate: bool = True, shard_mode: str = "tp_fsdp", ssd_impl: str = "chunked",
             cfg_patch: dict | None = None) -> dict:
    """Trace one cell and return its record (the reference's keys, with the
    port's counts in place of XLA's cost and memory analyses).

    ``calibrate`` also traces the depth-1 and depth-2 variants and checks
    that base + (units − 1) · per-unit equals the full trace's count (the
    reference extrapolates from them because XLA counts a scan body once;
    the port traces every layer, so they are a cross-check)."""
    from ..analysis.roofline import H100_SXM, analyze
    from ..configs.registry import get_arch, get_shape
    from ..models.registry import param_specs
    from ..parallel.steps import trace_cell
    from .mesh import make_production_mesh

    cfg = get_arch(arch)
    if cfg_patch:
        cfg_patch = dict(cfg_patch)
        if "moe" in cfg_patch:
            moe = cfg_patch.pop("moe")
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        if cfg_patch:
            cfg = dataclasses.replace(cfg, **cfg_patch)
    shape = get_shape(shape_name)
    n_chips = 512 if multi_pod else 256
    opts = dict(remat=remat, sp=sp, donate=donate, shard_mode=shard_mode, ssd_impl=ssd_impl)
    _quiet_dtensor_logs()
    with fake_process_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        metrics, meta = trace_cell(cfg, shape, mesh, **opts)
        trace_s = time.time() - t0
        calib = {"applied": False}
        if calibrate:
            units = scan_units(cfg)
            m = {n: trace_cell(with_depth(cfg, n), shape, mesh, **opts)[0] for n in (1, 2)}
            per_unit = {k: m[2][k] - m[1][k] for k in _KEYS}
            base = {k: m[1][k] for k in _KEYS}
            extrapolated = {k: base[k] + per_unit[k] * (units - 1) for k in _KEYS}
            calib = {
                "applied": True,
                "units": units,
                "per_unit": per_unit,
                "base": base,
                "extrapolated": extrapolated,
                "traced": {k: metrics[k] for k in _KEYS},
                "rel_diff": {k: abs(extrapolated[k] - metrics[k]) / max(abs(metrics[k]), 1) for k in _KEYS},
            }
    roof = analyze(metrics, cfg, shape, n_chips, param_specs(cfg), hw=H100_SXM)
    resident = metrics["resident"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": meta["kind"],
        "n_params": meta["n_params"],
        "trace_s": round(trace_s, 2),
        "resident_bytes": resident,
        # Local parameters, moments, batch (and caches) + the activations
        # autograd saved during the forward, outside remat'd blocks.
        "bytes_per_device_est": resident["state_and_inputs"] + resident["saved_for_backward"],
        "hw": {"name": "H100 SXM data sheet", **H100_SXM},
        "roofline": roof.as_dict(),
        "flops_by_op": metrics["flops_by_op"],  # bmm: the routed experts and the attention backward's recompute
        "calibration": calib,
        "options": {"remat": remat, "sp": sp, "donate": donate, "shard_mode": shard_mode},
        "counts_not_times": True,
    }


def cell_path(arch: str, shape: str, multi_pod: bool) -> Path:
    mesh = "pod2" if multi_pod else "pod1"
    return OUT_DIR / f"{arch}__{shape}__{mesh}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    args = ap.parse_args(argv)

    from ..configs.registry import all_cells

    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.insert(0, False)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    # Cheapest first: the most coverage per wall-clock second.
    arch_order = [
        "whisper-tiny", "qwen2-vl-2b", "minicpm-2b", "zamba2-1.2b",
        "mamba2-2.7b", "granite-3-8b", "deepseek-moe-16b",
        "qwen3-moe-30b-a3b", "gemma3-27b", "command-r-35b",
    ]
    shape_order = ["decode_32k", "train_4k", "long_500k", "prefill_32k"]
    cells = sorted(all_cells(), key=lambda c: (shape_order.index(c[1]), arch_order.index(c[0])))
    for arch, shape, skipped in cells:
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        if skipped:
            print(f"SKIP {arch} × {shape} (full-attention arch at 500k)")
            continue
        for mp in meshes:
            path = cell_path(arch, shape, mp)
            if path.exists() and not args.force:
                print(f"CACHED {path.name}")
                continue
            label = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
            print(f"RUN {label} ...", flush=True)
            try:
                # The calibration's depth-1/-2 traces only on the single-pod
                # mesh, as in the reference; the multi-pod pass proves the
                # "pod" axis shards.
                art = run_cell(arch, shape, mp, remat=not args.no_remat, sp=not args.no_sp, calibrate=not mp)
                path.write_text(json.dumps(art, indent=1))
                r = art["roofline"]
                print(f"  OK trace={art['trace_s']}s dominant={r['dominant']} "
                      f"terms=({r['compute_s']:.3e},{r['memory_s']:.3e},{r['collective_s']:.3e})s "
                      f"frac={r['roofline_fraction']:.2f} (counts on a fake mesh, not timings)", flush=True)
            except Exception as e:
                failures.append((label, repr(e)))
                print(f"  FAIL {label}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        return 1
    print("\nAll requested dry-run cells passed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
