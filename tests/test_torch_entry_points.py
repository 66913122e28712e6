"""The port's entry points above the solver API against the reference's
benchmarks and examples, on the plain CPU path at small sizes.

``bench/runtime`` solves the reference's matrices and its quality column is
the port's device makespans over the reference's host ones; a device error
propagates with no row written. ``bench/serve``'s gates fail as the
reference's do, and its overload and cache experiments account for every
request. ``bench/online --fast`` equals the reference's host rows and its
``spectra_jax`` rows. ``bench/scenarios`` prints the reference's rows.
``bench/experiments`` tables synthetic artifacts with the port's keys. Each
example runs. No wall-clock gate is asserted here.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import benchmarks.bench_serve as ref_serve  # noqa: E402
from repro.api import Problem as RefProblem  # noqa: E402
from repro.api import SolveOptions as RefOptions  # noqa: E402
from repro.api import solve as ref_solve  # noqa: E402
from repro.scenarios import make_trace as ref_make_trace  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402

from repro_torch.api import solve_many  # noqa: E402
from repro_torch.bench import experiments, online, runtime, scenarios, serve  # noqa: E402
from repro_torch.bench.common import fast_options  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    batched_device_scheduling,
    moe_traffic_schedule,
    serve_decode,
    serve_loadtest,
)

REF_FAST = RefOptions(validate=False, compute_lb=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geomean(xs) -> float:
    return float(np.exp(np.mean(np.log(xs))))


# ----------------------------------------------------------------- runtime


@pytest.mark.parametrize("scenario", [w[1] for w in runtime.WORKLOADS])
def test_runtime_device_matrices_are_the_references(scenario):
    np.testing.assert_array_equal(runtime.device_matrices(scenario, 2),
                                  ref_make_trace(scenario, periods=2, seed=1000).demands)


def test_runtime_quality_is_port_device_over_reference_host():
    row = runtime.runtime_row("gpt_s4", "gpt", 4, reps=2, batch=2, device="cpu")
    Ds = runtime.device_matrices("gpt", 2)
    reps = solve_many(Ds, 4, 0.01, solver="spectra_torch", options=fast_options("cpu"))
    want = _geomean([r.makespan / ref_solve(RefProblem(D, 4, 0.01), solver="spectra", options=REF_FAST).makespan
                     for D, r in zip(Ds, reps)])
    assert row["device_quality_vs_host"] == pytest.approx(want, rel=1e-4)
    assert row["batch_size"] == 2 and row["batched_device_ms_per_instance"] > 0
    assert math.isfinite(row["mean_ms"]) and row["p95_ms"] >= 0


def test_runtime_rows_have_the_references_columns_and_names(monkeypatch, tmp_path):
    import benchmarks.common as ref_common
    import benchmarks.runtime_table as ref_rt

    want_rows = []
    monkeypatch.setattr(ref_common, "scenario_matrices", lambda scenario, seeds, **kw: [np.eye(4)] * seeds)
    monkeypatch.setattr(ref_rt, "_batched_device", lambda *a: (1.0, 1.0))
    monkeypatch.setattr(ref_rt, "write_csv", lambda path, rows: want_rows.extend(rows))
    monkeypatch.setattr(ref_rt, "FAST", False)
    want_out = ref_rt.run()
    monkeypatch.setattr(runtime, "scenario_matrices", lambda scenario, seeds, **kw: [np.eye(4)] * seeds)
    monkeypatch.setattr(runtime, "batched_device", lambda *a: (1.0, 1.0))
    got_rows, got_out = runtime.run(device="cpu", out_dir=tmp_path)
    header = (tmp_path / "runtime.csv").read_text().splitlines()[0].split(",")
    assert header == list(want_rows[0].keys()) == list(got_rows[0].keys())
    assert [r["name"] for r in got_out] == [r["name"] for r in want_out]
    # The derived column past its p95 (a host timing) is the reference's.
    assert [r["derived"].split(" ", 1)[1] for r in got_out] == [r["derived"].split(" ", 1)[1] for r in want_out]
    assert len(runtime.run(fast=True, device="cpu", out_dir=tmp_path)[0]) == 4  # --fast: no n = 512 row


def test_runtime_device_error_propagates_and_writes_no_row(monkeypatch, tmp_path):
    def broken(*a, **kw):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(runtime, "solve_many", broken)
    with pytest.raises(RuntimeError, match="injected device failure"):
        runtime.run(device="cpu", workloads=runtime.WORKLOADS[:1], out_dir=tmp_path)
    assert not (tmp_path / "runtime.csv").exists()


# ------------------------------------------------------------------- serve

_PASSING = [
    {"experiment": "speedup", "speedup": 1.5, "solve_ms": 12.0},
    {"experiment": "cache", "profile": "tiny", "cache_hit_rate": 0.8, "schedules_per_sec": 50.0, "p99_e2e_s": 0.2},
    {"experiment": "cache", "profile": "mixed", "cache_hit_rate": 0.1, "schedules_per_sec": 1.0, "p99_e2e_s": 9.0},
    {"experiment": "overload", "shed": 3, "max_depth": 8, "max_queue": 8, "accounted": 40, "requests": 40},
]
_TRIPS = {
    "none": {},
    "speedup": {0: {"speedup": 1.1}},
    "hit_rate": {1: {"cache_hit_rate": 0.5}},
    "throughput": {1: {"schedules_per_sec": 9.5}},
    "p99": {1: {"p99_e2e_s": 2.5}},
    "shed": {3: {"shed": 0}},
    "depth": {3: {"max_depth": 9}},
    "accounted": {3: {"accounted": 39}},
}


@pytest.mark.parametrize("trip", sorted(_TRIPS))
def test_serve_check_fails_as_the_reference(trip):
    rows = [{**r, **_TRIPS[trip].get(i, {})} for i, r in enumerate(_PASSING)]
    got = serve.check(rows)
    assert got == ref_serve.check(rows)
    assert len(got) == (0 if trip == "none" else 1)


def test_serve_overload_sheds_stays_bounded_and_accounts_for_every_ticket():
    r = serve.bench_overload(device="cpu")
    assert r["shed"] > 0 and r["max_depth"] <= r["max_queue"] == 8
    assert r["accounted"] == r["requests"] == r["admitted"] + r["shed"] == r["completed"] + r["shed"]
    assert not [f for f in serve.check([r])]


def test_serve_cache_tiny_serves_every_request():
    r = serve.bench_cache("tiny", 0.6, 60.0, device="cpu")
    assert r["metrics"]["schedules"] == r["requests"] == sum(r["served_from"].values())
    assert r["served_from"]["cache"] > 0 and r["served_from"]["device"] > 0
    assert 0.0 < r["cache_hit_rate"] <= 1.0


# ------------------------------------------------------------------ online


@pytest.fixture(scope="module")
def online_fast(tmp_path_factory):
    return online.run(fast=True, device="cpu", out_dir=tmp_path_factory.mktemp("online"))


def _summary(data: dict) -> dict:
    return {k: data[k] for k in ("stateless_total_makespan", "online_total_makespan", "delta_paid",
                                 "delta_avoided", "reuse")}


def test_online_fast_rows_and_names(online_fast):
    data, rows = online_fast
    want = [f"fig_online_{n}_T{T}_{s}" for n in ("gpt", "moe", "benchmark") for T in (3, 6)
            for s in ("spectra", "spectra_torch")]
    assert [r["name"] for r in rows] == want
    assert {d["online_backend"] for d in data if d["solver"] == "spectra_torch"} == {"scan"}
    assert all(d["ratio"] <= 1 + 1e-6 for d in data)


@pytest.mark.parametrize("name, T", [(n, T) for n in ("gpt", "moe", "benchmark") for T in (3, 6)])
def test_online_host_rows_equal_the_reference(online_fast, name, T):
    got = next(d for d in online_fast[0] if (d["scenario"], d["T"], d["solver"]) == (name, T, "spectra"))
    s = ref_run_scenario(name, solver="spectra", online=True, periods=T, n=8, options=REF_FAST).online_summary()
    want = {"stateless_total_makespan": s["stateless_total_makespan"],
            "online_total_makespan": s["online_total_makespan"], "delta_paid": s["total_delta_paid"],
            "delta_avoided": s["total_delta_avoided"], "reuse": s["total_reuse"]}
    g = _summary(got)
    assert g["reuse"] == want["reuse"]
    for k in want:
        assert g[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k


def test_online_device_rows_equal_spectra_jax(online_fast):
    got = next(d for d in online_fast[0] if (d["scenario"], d["T"], d["solver"]) == ("gpt", 3, "spectra_torch"))
    s = ref_run_scenario("gpt", solver="spectra_jax", online=True, periods=3, n=8, options=REF_FAST).online_summary()
    assert got["reuse"] == s["total_reuse"]
    for k, w in (("stateless_total_makespan", s["stateless_total_makespan"]),
                 ("online_total_makespan", s["online_total_makespan"]),
                 ("delta_paid", s["total_delta_paid"]), ("delta_avoided", s["total_delta_avoided"])):
        assert got[k] == pytest.approx(w, rel=1e-4, abs=1e-7), k


@pytest.mark.parametrize("entry", ["online", "scenarios"])
def test_a_device_failure_propagates(monkeypatch, tmp_path, entry):
    """The reference's fig_online skips its device backend without JAX and
    run.py turns a scenario's exception into an ERROR row; the twins raise."""
    import repro_torch.scenarios as port_scenarios
    from repro_torch.obs import get_tracer

    real = port_scenarios.run_scenario

    def broken(name, *, solver, **kw):
        if solver == "spectra_torch":
            raise RuntimeError("injected device failure")
        return real(name, solver=solver, **kw)

    with pytest.raises(RuntimeError, match="injected device failure"):
        if entry == "online":
            monkeypatch.setattr(online, "run_scenario", broken)
            online.run(fast=True, device="cpu", out_dir=tmp_path)
        else:
            monkeypatch.setattr(port_scenarios, "run_scenario", broken)
            scenarios.main("--fast --scenario gpt --solver spectra_torch --obs --device cpu".split(), out_dir=tmp_path)
    assert not list(tmp_path.iterdir())  # no CSV row, no trace
    assert not get_tracer().enabled


# --------------------------------------------------------------- scenarios


def _rows(text: str) -> dict:
    """{name: {key: value}} of the ``name,us_per_call,derived`` lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith(("scenario_", "obs_")):
            name, _, derived = line.split(",", 2)
            out[name] = dict(kv.split("=", 1) for kv in derived.split(";"))
    return out


def test_scenario_mode_device_exits_zero_with_the_references_names(capsys, tmp_path):
    argv = "--fast --scenario gpt moe --online --flowsim --obs --solver spectra_torch --device cpu".split()
    assert scenarios.main(argv, out_dir=tmp_path) == 0
    rows = _rows(capsys.readouterr().out)
    want = {f"{kind}_{n}_{s}" for kind in ("scenario", "obs") for n in ("gpt", "moe")
            for s in ("spectra_torch", "rotor_vlb")} | {"obs_trace"}
    assert set(rows) == want
    assert all(rows[f"scenario_{n}_spectra_torch"]["conserved"] == "True" for n in ("gpt", "moe"))
    doc = json.loads((tmp_path / "TRACE_scenarios.json").read_text())
    assert doc["traceEvents"]
    from repro_torch.obs import get_tracer

    assert not get_tracer().enabled and not get_tracer().events  # the run leaves the tracer off and empty


def test_scenario_mode_host_rows_equal_the_references(capsys, tmp_path):
    from benchmarks.run import _run_one_scenario

    argv = "--fast --scenario gpt moe --online --flowsim --obs --device cpu".split()
    assert scenarios.main(argv, out_dir=tmp_path) == 0
    got = _rows(capsys.readouterr().out)
    for name in ("gpt", "moe"):
        for sv in ("spectra", "rotor_vlb"):
            assert _run_one_scenario(ref_run_scenario, name, sv, {"n": 8, "periods": 3}, online=True, flowsim=True,
                                     obs=True) == 0
    want = _rows(capsys.readouterr().out)
    assert set(got) == set(want) | {"obs_trace"}
    for name, kv in want.items():
        assert got[name].keys() == kv.keys(), name
        for k, w in kv.items():
            try:
                assert float(got[name][k]) == pytest.approx(float(w), rel=1e-3, abs=1e-9), (name, k)
            except ValueError:
                assert got[name][k] == w, (name, k)


# ------------------------------------------------------------- experiments


def _artifact(arch: str, shape: str, kind: str, dominant: str, n_chips: int = 256) -> dict:
    from repro_torch.analysis.roofline import H100_SXM

    return {
        "arch": arch, "shape": shape, "kind": kind, "n_chips": n_chips, "trace_s": 1.5,
        "bytes_per_device_est": 3.0e9, "hw": {"name": "H100 SXM data sheet", **H100_SXM},
        "roofline": {
            "compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.05, "dominant": dominant, "model_flops": 1e15,
            "useful_ratio": 0.5, "roofline_fraction": 0.25,
            "collectives": {"ops": {"all-gather": 3, "all-reduce": 2},
                            "wire_bytes": {"all-gather": 2e9, "all-reduce": 1e9, "all-to-all": 5e8}},
        },
    }


def test_experiments_tables_from_the_ports_artifacts(capsys, tmp_path, monkeypatch):
    import benchmarks.gen_experiments as ref_gen
    import benchmarks.roofline_table as ref_roof

    cells = [("whisper-tiny", "train_4k", "train", "memory", "pod1"), ("zamba2-1.2b", "decode_32k", "decode",
                                                                      "collective", "pod1"),
             ("whisper-tiny", "train_4k", "train", "memory", "pod2")]
    for arch, shape, kind, dominant, mesh in cells:
        art = _artifact(arch, shape, kind, dominant, 512 if mesh == "pod2" else 256)
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(art))
    monkeypatch.setattr(experiments, "DRYRUN", tmp_path)
    monkeypatch.setattr(experiments, "OUT_DIR", tmp_path)
    assert experiments.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "### §Dry-run tables" in out and "### §Roofline table" in out
    assert "H100 SXM data sheet: 989 TF/s bf16, 3350 GB/s HBM, 450 GB/s NVLink" in out and "TPU" not in out
    assert "| arch | shape | kind | params | trace_s | bytes/device | collective ops |" in out
    dry = experiments.dryrun_section(tmp_path)
    assert dry.count("| whisper-tiny | train_4k | train |") == 2 and "| zamba2-1.2b | decode_32k | decode |" in dry
    assert experiments.roofline_section(tmp_path).count("| **") == 2  # single-pod cells only
    # Parameters: count_params on param_specs equals the reference's jax.eval_shape count.
    assert experiments.true_params("whisper-tiny") == ref_gen._true_params("whisper-tiny")
    # The OCS column equals the reference's on the same artifacts; the device column matches the host's.
    monkeypatch.setattr(ref_roof, "DRYRUN", tmp_path)
    monkeypatch.setattr(ref_roof, "OUT", tmp_path / "ref")
    (tmp_path / "ref").mkdir()
    ref_roof.run()
    want = [line.split(",") for line in (tmp_path / "ref" / "roofline_table.csv").read_text().splitlines()]
    got = [line.split(",") for line in (tmp_path / "roofline_table.csv").read_text().splitlines()]
    assert got[0][:8] == want[0] and got[0][8] == "ocs_cct_device" and len(got) == len(want) == 3
    for g, w in zip(got[1:], want[1:]):
        assert g[:8] == w and "n/a" not in g
        assert float(g[8].split("(x")[1].rstrip(")")) == pytest.approx(1.0, abs=0.02), g[8]


def test_experiments_raise_on_a_scheduling_error(tmp_path, monkeypatch):
    (tmp_path / "whisper-tiny__train_4k__pod1.json").write_text(json.dumps(_artifact("whisper-tiny", "train_4k",
                                                                                      "train", "memory")))

    def broken(art, **kw):
        raise ValueError("injected scheduling failure")

    monkeypatch.setattr("repro_torch.traffic.hlo_traffic.schedule_cell_demand", broken)
    with pytest.raises(ValueError, match="injected scheduling failure"):
        experiments.roofline_table(tmp_path, tmp_path, "cpu")
    monkeypatch.setattr(experiments, "DRYRUN", tmp_path / "none")
    monkeypatch.setattr(experiments, "OUT_DIR", tmp_path)
    assert experiments.main(["--device", "cpu"]) == 1


# ---------------------------------------------------------------- examples


def test_example_batched_device_scheduling():
    from repro.api import solve_many as ref_solve_many

    out = batched_device_scheduling.main(["auction", "1", "--device", "cpu"])
    assert 0.9 < out["worst"] <= 1.05
    # The reference's example: the same matrices through spectra_jax with the same matcher and sweeps.
    mats = ref_make_trace("benchmark", n=32, m=8, num_big=4, periods=4).demands
    want = ref_solve_many(mats, 4, 0.01, solver="spectra_jax",
                          options=RefOptions(extra={"matcher": "auction", "repair_rounds": 1}))
    np.testing.assert_allclose([r.makespan for r in out["reports"]], [r.makespan for r in want], rtol=1e-4)


def test_example_serve_loadtest():
    out = serve_loadtest.main(["--device", "cpu"])
    assert out["open_loop"]["schedules"] == out["arrivals"] and out["open_loop"]["shed"] == 0
    assert out["shed"] > 0 and out["served"] + out["shed"] == out["overload"]


def test_example_serve_decode():
    out = serve_decode.main(["--new-tokens", "2", "--device", "cpu"])
    assert set(out["tokens"]) == set(serve_decode.ARCHS)
    assert all(t.shape == (4, 18) for t in out["tokens"].values())
    assert [r.solver for r in out["reports"]] == ["spectra"] * 3
    # The reference's SolverService on the same moe_workload seeds.
    from repro.serve.engine import SolverService as RefSolverService
    from repro.traffic.workloads import moe_workload as ref_moe_workload

    svc = RefSolverService(s=4, delta=0.01, solver="spectra")
    tickets = [svc.submit(ref_moe_workload(rng=np.random.default_rng(seed)) / 64) for seed in range(3)]
    want = svc.flush()
    for got, t in zip(out["reports"], tickets):
        w = want[t]
        assert (got.num_configs, got.backend) == (w.num_configs, w.backend)
        assert got.makespan == pytest.approx(w.makespan, rel=1e-12)
        assert got.optimality_gap == pytest.approx(w.optimality_gap, rel=1e-12)


def test_example_moe_traffic_schedule():
    out = moe_traffic_schedule.main(["--steps", "1", "--device", "cpu"])
    load = out["load"]
    assert len(load) == 8 and load.sum() > 0
    assert all(bl >= mk * (1 - 1e-9) for _, _, mk, bl in out["measured"])
    want = ref_run_scenario("moe", solver="spectra")
    np.testing.assert_allclose(out["trace"].makespans, want.makespans, rtol=1e-12)
