"""op_kernels_per_tick (layer: torch-op kernels of the tick; device trace):
kernels per traced tick that are neither substep nor NCCL kernels."""
from benchmark.metrics._kinds import op

ACROSS = "mean"


def read(ctx):
    if ctx.trace is None:
        return None
    return len(ctx.trace.kernels(op)) / ctx.trace.ticks
