"""replay_launch_ms_per_tick (layer: MPC loop and CUDA graph; program span):
host ms of the program's ``graph.replay`` span, which covers a replayed
tick's call of ``GraphedTick``: the input copies into the graph's buffers
and the graph's launch; the median over the untraced ticks."""
import numpy as np

from benchmark.metrics._spans import store, untraced

ACROSS = "max"


def read(ctx):
    spans = store()
    if spans is None:
        return None
    ms = untraced(ctx, [(s, (e - s) * 1e-6)
                        for s, e in spans.host("graph.replay")])
    return float(np.median(ms)) if ms else None
