"""allreduce_ms_per_tick (layer: multi-device; program span): device ms of
the program's ``collectives.all_reduce`` spans in a replayed tick (the
update's pmin and psum), from the timing events around each ``all_reduce``
in the tick's CUDA graph, summed over the tick; the median over the
untraced ticks, the most over the ranks.  It includes each rank's wait for
the slowest rank, which the traced ``nccl_ms_per_tick`` (the least over the
ranks) leaves out."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "collectives.all_reduce")
