"""launch_idle_pct (layer: MPC loop and CUDA graph; program span and device
trace): within the traced window, the share of the device's idle time
(the gaps between its activities, ``stats.gaps_ns`` over the trace) whose
gap's midpoint lies inside a program ``graph.replay`` span: the idle time
the device spends while the host copies the inputs and launches the graph.
The span and the trace are on one clock, the profiler's."""
from benchmark.harness.stats import gaps_ns
from benchmark.metrics._spans import store

ACROSS = "max"


def read(ctx):
    spans = store()
    if spans is None or ctx.trace is None:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    replays = sorted((s, e) for s, e in spans.host("graph.replay")
                     if e >= lo and s <= hi)
    if not replays:
        return None
    gaps = gaps_ns([(s, e) for _, _, s, e in ctx.trace.device], lo, hi)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    inside = 0
    for a, b in gaps:
        mid = (a + b) // 2
        if any(s <= mid <= e for s, e in replays):
            inside += b - a
    return 100.0 * inside / idle
