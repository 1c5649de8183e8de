"""substep_roofline (layer: substep kernels; device trace and the frozen
table): the least time of the traced tick's substep launches (each the
larger of its operations over 67 TFLOP/s and its bytes over 3.35 TB/s;
operations from ``optable.json``, bytes: each input row read once, qpos
and qvel written once, 4 B each) over their measured device time, in %."""
from benchmark.harness.stats import bound_s
from benchmark.metrics._kinds import substep
from benchmark.metrics._work import substep_launches

ACROSS = "mean"


def read(ctx):
    if ctx.trace is None:
        return None
    measured = ctx.trace.seconds(substep) / ctx.trace.ticks
    launches = substep_launches(ctx)
    if not measured or not launches:
        return None
    least = sum(n * bound_s(ops, nbytes) for n, ops, nbytes in launches)
    return 100.0 * least / measured
