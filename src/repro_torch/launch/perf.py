"""Perf hillclimbing: run named variants of a cell's dry run, record
the three roofline terms per variant, append to
build/repro_torch/perf_log.json (``repro.launch.perf``).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3-27b \\
        --shape train_4k --variant no_sp --variant tp_only ...

Variants combine the framework's knobs:
    base        remat + SP activation constraint + TP/FSDP sharding
    no_sp       drop the sequence-parallel activation constraint
    no_remat    store activations instead of recomputing in backward
    tp_only     replicate params over data (no FSDP gathers)
    zero1       params replicated over data, optimizer moments sharded
    cf1         MoE capacity factor 1.0
    no_sp_tp_only, no_remat_no_sp, ...   combinations

The reference's ``ssd_scanned``, ``ssd_scanned_no_sp`` and
``ssd_scanned_no_remat`` pick its scan-over-chunks SSD; the port has one
SSD implementation, so they have no counterpart (``OMITTED``).
The terms are counts on a fake mesh against a data sheet, not timings.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

OUT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

VARIANTS = {
    "base": {},
    "no_sp": {"sp": False},
    "no_remat": {"remat": False},
    "tp_only": {"shard_mode": "tp_only"},
    "no_sp_tp_only": {"sp": False, "shard_mode": "tp_only"},
    "no_remat_no_sp": {"remat": False, "sp": False},
    "no_remat_tp_only": {"remat": False, "shard_mode": "tp_only"},
    # MoE: capacity factor 1.0 (20% less expert compute, more drops).
    "cf1": {"cfg_patch": {"moe": {"capacity_factor": 1.0}}},
    "cf1_no_sp": {"cfg_patch": {"moe": {"capacity_factor": 1.0}}, "sp": False},
    # ZeRO-1: params replicated over data, optimizer moments sharded.
    "zero1": {"shard_mode": "zero1"},
    "zero1_cf1": {"shard_mode": "zero1", "cfg_patch": {"moe": {"capacity_factor": 1.0}}},
    "zero1_no_remat": {"shard_mode": "zero1", "remat": False},
}

# The reference's variants with no counterpart here, and why.
OMITTED = {
    name: "the reference's scan-over-chunks SSD (ssd_impl='chunked_scan'); the port has one SSD implementation"
    for name in ("ssd_scanned", "ssd_scanned_no_sp", "ssd_scanned_no_remat")
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    from .dryrun import run_cell

    names = args.variant or list(VARIANTS)
    for name in names:
        if name in OMITTED:
            raise SystemExit(f"variant {name!r} has no counterpart in the port: {OMITTED[name]}")
    OUT.mkdir(parents=True, exist_ok=True)
    log_path = OUT / "perf_log.json"
    log = json.loads(log_path.read_text()) if log_path.exists() else []
    for name in names:
        kw = VARIANTS[name]
        label = f"{args.arch}×{args.shape}×{name}"
        print(f"VARIANT {label} ...", flush=True)
        t0 = time.time()
        try:
            art = run_cell(args.arch, args.shape, args.multi_pod, calibrate=False, **kw)
        except Exception as e:
            print(f"  FAIL {e}")
            log.append({"cell": f"{args.arch}×{args.shape}", "variant": name, "error": repr(e)[:300]})
            continue
        r = art["roofline"]
        log.append({
            "cell": f"{args.arch}×{args.shape}",
            "variant": name,
            "options": art["options"],
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "dominant": r["dominant"],
            "fraction": r["roofline_fraction"],
            "useful": r["useful_ratio"],
            "wall_s": round(time.time() - t0, 1),
        })
        print(f"  terms=({r['compute_s']:.3e},{r['memory_s']:.3e},{r['collective_s']:.3e}) dom={r['dominant']} "
              f"frac={r['roofline_fraction']:.3f}", flush=True)
        log_path.write_text(json.dumps(log, indent=1))


if __name__ == "__main__":
    main()
