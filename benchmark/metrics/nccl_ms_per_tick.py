"""nccl_ms_per_tick (layer: multi-device; device trace): device time per
traced tick of the NCCL kernels at the slowest rank.  An NCCL kernel spins
until every rank has arrived, so a rank that arrives early reads its wait
as well; the slowest rank, the last to arrive, reads the collective's own
time: the least over the ranks."""
from benchmark.metrics._kinds import nccl

ACROSS = "min"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels(nccl):
        return None
    return 1e3 * ctx.trace.seconds(nccl) / ctx.trace.ticks
