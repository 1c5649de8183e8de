"""plant_ms_per_tick (layer: plant (on terrain the op-graph step); program
span): device ms of the program's ``mpc.plant`` span in a replayed tick,
the plant step and the control queue (``plant_step``: K1 at K=1 on Go1, the
exact op-graph step on terrain): the timing events the span records into
the tick's CUDA graph, read after each replay; the median over the untraced
ticks."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "mpc.plant")
