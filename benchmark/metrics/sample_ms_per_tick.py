"""sample_ms_per_tick (layer: MPPI noise; program span): device ms of the
program's ``mppi.sample`` span in a replayed tick, the noise shaping and
clipping of the K candidate plans (``sample_candidates``): the timing
events the span records into the tick's CUDA graph, read after each replay;
the median over the untraced ticks."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "mppi.sample")
