"""device_idle_pct: the share of the traced window in which the device ran
no operation (kernel, copy or set), from the profiler's device timeline."""

from benchmarks import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    lo, hi = ctx.trace.window()
    return 100.0 * (1.0 - tr.busy_seconds(ctx.trace) / (hi - lo))
