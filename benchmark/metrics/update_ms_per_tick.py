"""update_ms_per_tick (layer: MPPI update; program span): device ms of the
program's ``mppi.update`` span in a replayed tick, the softmax-weighted
update and the receding shift (``weighted_update``; on a mesh with its all-
reduces): the timing events the span records into the tick's CUDA graph,
read after each replay; the median over the untraced ticks."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "mppi.update")
