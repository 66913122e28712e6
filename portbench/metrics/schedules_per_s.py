"""Schedules returned and found well formed, over the window's seconds."""


def read(run):
    return len(run.valid) / run.window_s if run.window_s > 0 else None
