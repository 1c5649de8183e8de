"""pergeom_roofline (layer: substep kernels; device trace, counter
``LAUNCHES`` and the frozen table ``optable_pergeom.json``): the least time
of the traced tick's per-geom launches (``substep_pergeom`` by shape from
the counter; each the larger of its operations over 67 TFLOP/s and its
bytes over 3.35 TB/s, counted as ``_work.py`` counts them: each input row
read once, qpos and qvel written once, 4 B each) over the measured device
time of the kernels named ``substep_pergeom*``, in %."""
import json
import os

from benchmark.harness.stats import bound_s
from benchmark.metrics._work import _KEY
from benchmark.metrics.pergeom_ms_per_tick import pergeom

ACROSS = "mean"

_TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "reference", "optable_pergeom.json")


def launches(ctx):
    """[(launches per tick, ops, bytes)] of each per-geom shape the traced
    ticks launched; None where the table lacks the robot."""
    with open(_TABLE) as f:
        sub = json.load(f)["substep"].get(ctx.facts["robot"])
    if sub is None:
        return None
    out = []
    for key, per_tick in ctx.counters.items():
        m = _KEY.match(key)
        if m is None or m.group(1) not in sub or per_tick <= 0:
            continue
        row = sub[m.group(1)]
        K, n = int(m.group(2)), int(m.group(3))
        out.append((per_tick, row["ops_per_lane_substep"] * K * n,
                    4 * K * (row["rows_in"] + row["rows_out"])))
    return out


def read(ctx):
    if ctx.trace is None or not ctx.counters:
        return None
    measured = ctx.trace.seconds(pergeom) / ctx.trace.ticks
    work = launches(ctx)
    if not measured or not work:
        return None
    least = sum(n * bound_s(ops, nbytes) for n, ops, nbytes in work)
    return 100.0 * least / measured
