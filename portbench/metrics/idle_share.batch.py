"""Share of the traced window in which no operation ran on the card (the
``torch.profiler`` timeline)."""


def read(run):
    t = run.device_trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
