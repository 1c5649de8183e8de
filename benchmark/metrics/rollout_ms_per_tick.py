"""rollout_ms_per_tick (layer: rollouts and cost; program span): device ms of
the program's ``mppi.rollout`` span in a replayed tick, the K rollouts and
their cost, the anchor term and the NaN guard (``rollout_costs``): the
timing events the span records into the tick's CUDA graph, read after each
replay; the median over the untraced ticks."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "mppi.rollout")
