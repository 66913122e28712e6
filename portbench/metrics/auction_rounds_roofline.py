"""Share of the least time for DECOMPOSE's matcher calls (``degree(D)`` a
matrix, each reading n x n float32 weights once) in the device time of the
``auction_rounds`` kernel (csrc/auction_rounds.cu), over the profiled part
of the window."""

from portbench.roofline import matcher_roofline_pct

KERNELS = ("auction_rounds_kernel",)


def read(run):
    if run.device_trace is None:
        return None
    calls = [(x.D.shape[0], x.reading.k_ref) for x in run.valid if x.profiled]
    return matcher_roofline_pct(calls, run.device_trace.kernel_seconds(KERNELS)) if calls else None
