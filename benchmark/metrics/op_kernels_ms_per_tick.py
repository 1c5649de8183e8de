"""op_kernels_ms_per_tick (layer: torch-op kernels of the tick; device
trace): their device time per traced tick."""
from benchmark.metrics._kinds import op

ACROSS = "mean"


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * ctx.trace.seconds(op) / ctx.trace.ticks
