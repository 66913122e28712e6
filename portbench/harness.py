"""The benchmark of the PyTorch port's schedule solver (``repro_torch``).

Everything that belongs to one cell sits in data files found by name: the
cell (``workloads/<cell>.json``: its configuration, traffic mix and limits),
the configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``, read by ``traffic/generators.py``), and one
reader a metric (``metrics/<metric>.py``). Which metrics a cell reports is
read from ``BENCHMARK.json`` beside this folder. The load is a closed
loop: one client submits a stack of ``batch`` matrices of the mix's pool,
built before the window, to ``solve_many`` and waits for every report.

After the window, every schedule is read by ``reference/replay.py`` against
its demand matrix: well formed, and covering the demand to within the
cell's ``cover_gap`` limit. On a sample drawn from the seed, its makespan is
held against the frozen reference's ``spectra`` of the same demand
(``makespan_excess``) and against the reference's LPT and EQUALIZE of the
program's own configurations (``schedule_excess``).
"""

from __future__ import annotations

import importlib.util
import json
import gc
import math
import shutil
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench.reference import replay  # noqa: E402
from portbench.traffic.generators import closed_loop_source, warm_matrices  # noqa: E402

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    sample: int  # schedules a run holds against the reference's makespans
    end_to_end: list[str]
    per_layer: list[str]


@dataclass
class Record:
    """One request of the window: its demand, what came back, and when."""

    D: np.ndarray
    report: Any = None          # the program's SolveReport
    switches: Any = None        # (perms, alphas) per switch, once read
    extras: dict = field(default_factory=dict)
    latency_s: float = math.inf
    error: str = ""
    profiled: bool = False      # solved inside the profiled part of the window
    reading: replay.Reading | None = None
    makespans: replay.Makespans | None = None  # for a sampled record


@dataclass
class Run:
    """What the metric readers see."""

    cell: Cell
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list[Record] = field(default_factory=list)
    spans: list = field(default_factory=list)
    device_trace: Any = None
    notes: list[str] = field(default_factory=list)

    @property
    def valid(self) -> list[Record]:
        return [r for r in self.records if r.reading is not None and not r.reading.invalid]


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def benchmark(root: Path = HERE) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = HERE) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    spec = load_json("workloads", name, root)
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"portbench: workloads/{name}.json and BENCHMARK.json disagree")

    def reported(metrics):
        return [m["name"] for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, load_json("configs", spec["config"], root), load_json("traffic", spec["traffic"], root),
                spec["limits"], int(spec["sample"]), reported(bench["end_to_end"]), reported(bench["per_layer"]))


def load_reader(metric: str, root: Path = HERE) -> Callable[[Run], float | None]:
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ the program
class Program:
    """The system under test, entered only through its public API."""

    def __init__(self, device: str | None):
        from repro_torch.api import SolveOptions, solve_many

        self.options = SolveOptions(extra={"device": device}) if device else SolveOptions()
        self._solve_many = solve_many

    def solve(self, Ds: list[np.ndarray], s: int, delta: float):
        return self._solve_many(Ds, s, delta, solver="spectra_torch", options=self.options)

    def counters(self) -> dict[str, int]:
        from repro_torch.kernels.auction_bid.ops import auction_rounds, masked_row_top2
        from repro_torch.kernels.auction_fused.ops import fused_auction, polish_2swap

        return {"auction_rounds": auction_rounds.launches, "masked_row_top2": masked_row_top2.launches,
                "auction_fused": fused_auction.launches, "auction_fused.cluster": fused_auction.cluster_launches,
                "polish_2swap": polish_2swap.launches}


def _switches_of(report) -> list:
    return replay.from_parallel_schedule(report.schedule)


class _Profiler:
    """``torch.profiler`` over one steady part of a traced window."""

    def __init__(self, enabled: bool, on_cuda: bool, path: Path):
        self.enabled, self.on_cuda, self.path = enabled, on_cuda, path
        self.prof = None
        self.active = False

    def _profile(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self, work: Callable[[], Any]) -> None:
        """Profile ``work`` once in set-up and discard it: the profiler's own
        first start (CUPTI's) then costs no time in the window."""
        if self.enabled:
            with self._profile():
                work()
        else:
            work()

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        self.prof = self._profile()
        t = time.perf_counter()
        self.prof.start()
        self.active = True
        self.t_start, self.start_s = time.perf_counter(), time.perf_counter() - t

    def stop(self):
        if self.active:
            t = time.perf_counter()
            self.prof.stop()
            self.active = False
            self.profiled_s, self.stop_s = t - self.t_start, time.perf_counter() - t

    def export(self) -> str:
        """Write the Chrome trace after the window; returns a note."""
        if self.prof is None:
            return "profiler: never started"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        self.prof.export_chrome_trace(str(self.path))
        return (f"profiler: {self.profiled_s:.3f} s profiled; start {self.start_s:.3f} s, stop {self.stop_s:.3f} s, "
                f"export {time.perf_counter() - t:.3f} s")


def _profile_span(seconds: float) -> tuple[float, float]:
    """(start, stop) of the profiled part of a window, in window seconds."""
    start = min(2.0, 0.25 * seconds)
    return start, start + min(3.0, 0.5 * seconds)


# ----------------------------------------------------------------- closed loop
def closed_loop(run: Run, prog: Program, seconds: float, prof: _Profiler, t_start: float) -> None:
    cfg, mix = run.cell.config, run.cell.traffic
    s, delta, B = int(cfg["s"]), float(cfg["delta"]), int(mix["batch"])
    matrix = closed_loop_source(cfg, mix, run.seed)
    stacks = [[matrix(j * B + b) for b in range(B)] for j in range(max(1, int(mix["pool"]) // B))]
    try:  # loads the kernel library and sizes the allocator
        prof.warm(lambda: prog.solve(warm_matrices(cfg, mix, B), s, delta))
    except Exception:  # the window's own calls will fail and say why
        run.notes.append("warm-up call failed: " + traceback.format_exc(limit=1).strip().splitlines()[-1])
    if prof.on_cuda:
        import torch

        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    p0, p1 = _profile_span(seconds)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    j = 0
    while True:
        if time.perf_counter() - t0 >= p0 and j and prof.prof is None:
            prof.start()
        Ds = stacks[j % len(stacks)]
        recs = [Record(D=D, profiled=prof.active) for D in Ds]
        t_call = time.perf_counter()
        try:
            reps = prog.solve(Ds, s, delta)
            t_done = time.perf_counter()
            for rec, rep in zip(recs, reps):
                rec.report, rec.latency_s = rep, t_done - t_call
        except Exception:  # a failed call is a failed answer for each of its requests
            t_done = time.perf_counter()
            for rec in recs:
                rec.error = traceback.format_exc(limit=3)
        run.records.extend(recs)
        j += 1
        if prof.active and t_done - t0 >= p1:
            prof.stop()
        if t_done - t0 >= seconds:
            break
    prof.stop()
    gc.unfreeze()
    run.window_s = t_done - t0
    lat = [r.latency_s for r in run.records if r.report is not None]
    if lat:
        q = np.quantile(lat, [0.5, 0.9, 0.95, 0.99, 1.0]) * 1e3
        run.notes.append("closed loop: ms a call p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}".format(*q))
    for rec in run.records:
        if rec.report is not None:
            rec.switches = _switches_of(rec.report)
            rec.extras = dict(rec.report.extras)


# ------------------------------------------------------------------- the check
def sample_of(run: Run) -> list[Record]:
    """The well-formed schedules whose makespans are held against the
    reference's: ``cell.sample`` distinct demand matrices, drawn from the
    seed."""
    firsts = {}
    for rec in run.records:
        if rec.reading is not None and not rec.reading.invalid:
            firsts.setdefault(id(rec.D), rec)
    recs = list(firsts.values())
    rng = np.random.default_rng([run.seed, 7])
    return [recs[i] for i in sorted(rng.choice(len(recs), size=min(run.cell.sample, len(recs)), replace=False))]


def check(run: Run) -> dict[str, dict[str, float]]:
    """Read every schedule of the window, and the sample's makespans; the
    compared numbers and their limits."""
    cfg, limits = run.cell.config, run.cell.limits
    s, delta = int(cfg["s"]), float(cfg["delta"])
    for rec in run.records:
        if rec.switches is not None:
            rec.reading = replay.read(rec.D, rec.switches, s, delta)
    for rec in sample_of(run):
        rec.makespans = replay.makespans(rec.D, rec.switches, s, delta)
    readings = [r.reading for r in run.records if r.reading is not None]
    gaps = [x.cover_gap for x in readings if not x.invalid]
    sampled = [r.makespans for r in run.records if r.makespans is not None]

    def worst(values):
        return max(values) if values else math.inf

    return {
        "cover_gap": {"value": worst(gaps), "limit": float(limits["cover_gap"])},
        "makespan_excess": {"value": worst([m.excess for m in sampled]), "limit": float(limits["makespan_excess"])},
        "schedule_excess": {"value": worst([m.schedule_excess for m in sampled]),
                            "limit": float(limits["schedule_excess"])},
        "invalid": {"value": sum(1 for x in readings if x.invalid), "limit": 0},
        "missing": {"value": sum(1 for r in run.records if r.reading is None), "limit": 0},
    }


def fails(rec: Record, checks: dict) -> bool:
    """Whether one request's answer breaks a limit."""
    if rec.reading is None or rec.reading.invalid or rec.reading.cover_gap > checks["cover_gap"]["limit"]:
        return True
    m = rec.makespans
    return m is not None and (m.excess > checks["makespan_excess"]["limit"]
                              or m.schedule_excess > checks["schedule_excess"]["limit"])


# ------------------------------------------------------------------------- run
def run_cell(name: str, seed: int, seconds: float, trace: bool, **kwargs) -> dict:
    """Run one cell and return its result line as a dict."""
    return execute(name, seed, seconds, trace, **kwargs)[1]


def execute(name: str, seed: int, seconds: float, trace: bool, *, device: str | None = None,
            root: Path = HERE, overrides: dict | None = None, t_start: float | None = None,
            out_dir: Path | None = None, log: Callable[[str], None] | None = None) -> tuple[Run, dict]:
    """Run one cell; returns the run and its result line. ``device=None`` is
    the card; ``device="cpu"`` with ``overrides`` (configuration keys, e.g. a
    small ``n``) is for tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(name, root)
    cell.config.update(overrides or {})
    readers = {m: load_reader(m, root) for m in (cell.per_layer if trace else cell.end_to_end)}
    import torch

    on_cuda = device is None
    prog = Program(device)
    t_imports = time.perf_counter()
    if on_cuda:
        torch.zeros(1, device="cuda").sum().item()  # the CUDA context
    t_context = time.perf_counter()
    out_dir = out_dir or root.parent / "portbench_out"
    prof = _Profiler(trace, on_cuda, out_dir / f"{name}.{seed}.trace.json")
    tracer = None
    if trace:
        from repro_torch.obs.trace import get_tracer

        tracer = get_tracer()
        tracer.reset()
        tracer.enable(device_sync=False)
    run = Run(cell, seed, trace)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    before = prog.counters()
    try:
        closed_loop(run, prog, seconds, prof, t_start)
    finally:
        if tracer is not None:
            run.spans = tracer.spans()
            tracer.disable()
    after = prog.counters()
    device_info: dict[str, Any] = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if on_cuda:
        torch.cuda.synchronize()
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                       "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    log(f"window: {len(run.records)} requests in {run.window_s:.3f} s; set-up {run.setup_s:.3f} s: imports "
        f"{t_imports - t_start:.3f} s, CUDA context {t_context - t_imports:.3f} s, inputs and warm-up "
        f"{t_start + run.setup_s - t_context:.3f} s")
    log("kernel launches in the run: " + json.dumps({k: after[k] - before[k] for k in after}))
    for note in run.notes:
        log(note)
    if trace:
        log(prof.export())
    if trace and prof.path.exists():
        from portbench.devtrace import read_trace

        run.device_trace = read_trace(prof.path, prof.profiled_s)
        if run.device_trace is not None:
            device_info.update(busy_s=run.device_trace.busy_s, window_s=run.device_trace.window_s)
            log(f"trace: {prof.path} ({prof.path.stat().st_size} bytes)")
    # The program's state goes before the reference runs.
    for rec in run.records:
        if rec.error:
            log(f"request failed: {rec.error.strip().splitlines()[-1]}")
            break
    if on_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(run)
    log(f"check and reference: {time.perf_counter() - t_check:.3f} s")
    metrics = {}
    bench = benchmark(root)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for metric, read in readers.items():
        value = read(run)
        if value is not None and math.isfinite(value):
            metrics[metric] = {"value": float(value), "unit": units[metric]}
        elif value is not None:
            log(f"{metric}: {value!r}, left out of the result")
    failed = sum(1 for r in run.records if fails(r, checks))
    correct = bool(run.records) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result: dict[str, Any] = {"correct": correct, "attempted": len(run.records), "failed": failed,
                              "metrics": metrics, "device": device_info}
    if trace and run.device_trace is not None:
        result["breakdown"] = {"device_ops": run.device_trace.device_ops,
                               "idle_gaps": run.device_trace.idle_gaps}
    result["checks"] = checks
    return run, result


def loaded_jax_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(JAX_NAMES))


def card_clocks() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:  # the card's clocks are a note, not a result
        return f"nvidia-smi: {exc!r}"
    return "nvidia-smi: " + out.stdout.strip().replace("\n", " | ")

