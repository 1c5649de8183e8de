"""substep_ms_per_tick (layer: substep kernels; device trace): device time
per traced tick of the kernels named ``substep_*``."""
from benchmark.metrics._kinds import substep

ACROSS = "mean"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels(substep):
        return None
    return 1e3 * ctx.trace.seconds(substep) / ctx.trace.ticks
