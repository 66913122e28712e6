"""The readers of the program's stage spans and host-read counts, on
hand-built runs: the mean a call, the set-up's warm call (the first) left
out, and nothing read where the program has no such span or count."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness


def _span(name, start, end, **args):
    return SimpleNamespace(name=name, start=start, end=end, duration=end - start, args=args or None)


def _call(t0, decompose, lpt, equalize, bound, reads=None):
    """One ``solve_many`` call from ``t0``, its stages' seconds in turn; with
    ``reads`` (dispatch, collect), the spans' host reads."""
    dispatch, collect = ({"host_reads": r} for r in reads) if reads else ({}, {})
    spans, t = [], t0 + 0.001
    for name, sec in (("e2e.decompose", decompose), ("e2e.lpt", lpt), ("e2e.equalize", equalize),
                      ("e2e.bound", bound)):
        spans.append(_span(name, t, t + sec))
        t += sec
    spans.insert(0, _span("torch.dispatch", t0 + 0.0005, t, B=16, **dispatch))
    spans.append(_span("torch.collect", t, t + 0.002, B=16, **collect))
    return [_span("solve_many", t0, t + 0.003), _span("bucket", t0, t + 0.003)] + spans


def _run(*calls):
    run = harness.Run(harness.load_cell("moe64.batch16"), 1, True)
    run.spans = [sp for c in calls for sp in c]
    return run


WARM = _call(0.0, 9.0, 1.0, 1.0, 1.0, reads=(900, 90))
CALLS = [_call(20.0, 0.200, 0.003, 0.010, 0.001, reads=(150, 12)),
         _call(21.0, 0.180, 0.005, 0.020, 0.003, reads=(160, 12))]


@pytest.mark.parametrize("cell", ["batch", "single"])
@pytest.mark.parametrize("metric, want", [
    ("decompose_ms", 190.0),                 # (200 + 180) / 2 ms; the warm call's 9 s left out
    ("schedule_ms", (14.0 + 28.0) / 2),      # lpt + equalize + bound a call
    ("host_reads", (162 + 172) / 2),         # dispatch + collect a call
])
def test_reader_means_a_call_without_the_warm_call(cell, metric, want):
    read = harness.load_reader(f"{metric}.{cell}")
    assert read(_run(WARM, *CALLS)) == pytest.approx(want)
    # Spans out of order read the same.
    assert read(_run(*reversed(CALLS), WARM)) == pytest.approx(want)


@pytest.mark.parametrize("cell", ["batch", "single"])
@pytest.mark.parametrize("metric", ["decompose_ms", "schedule_ms", "host_reads"])
def test_reader_reads_nothing_without_its_spans(cell, metric):
    read = harness.load_reader(f"{metric}.{cell}")
    # The parent program's spans: solve_many, bucket, dispatch and collect, no stage, no count.
    bare = [[sp for sp in c if not sp.name.startswith("e2e.")] for c in (WARM, *CALLS)]
    for sp in (sp for c in bare for sp in c):
        sp.args = {k: v for k, v in (sp.args or {}).items() if k != "host_reads"} or None
    assert read(_run(*bare)) is None
    assert read(_run()) is None
    # The warm call alone leaves no call to read.
    assert read(_run(WARM)) is None
