"""off_graph_pct (layer: device; program span): the share of the device's
tick period outside the tick's CUDA graph, untraced: 100 x (1 - the median
device span of a replay (timing events around ``graph.replay()`` on the
stream) / the median period from one replay's start on the device to the
next).  The rest of the period is the device's idle time between graphs and
the harness's own work there (the noise draw, the copies)."""
from benchmark.metrics._spans import device_median

ACROSS = "max"


def read(ctx):
    span = device_median(ctx, "graph.replay")
    period = device_median(ctx, "graph.period")
    if span is None or not period:
        return None
    return 100.0 * (1.0 - span / period)
