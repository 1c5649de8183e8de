"""planes_ms_per_tick (layer: rollouts and cost; program span): device ms
of the program's ``mppi.planes`` span in a replayed tick, the rollouts'
contact planes built from the solve-from state (per geom: the forward
kinematics and the heightfield under every collision sphere): the timing
events the span records into the tick's CUDA graph, read after each
replay; the median over the untraced ticks.  None for a program without
the span."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    return device_median(ctx, "mppi.planes")
