"""The work of a traced tick from the frozen table
(``benchmark/reference/optable.json``): each substep launch's operations
and bytes.  The program's counter of launches (``ops.cuda_step.LAUNCHES``,
by kernel and shape) says which launches a tick made; the table, not the
program, says what each costs."""
import json
import os
import re

_TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "reference", "optable.json")
_KEY = re.compile(r"^launches (\w+) K=(\d+) x(\d+)$")


def table():
    with open(_TABLE) as f:
        return json.load(f)


def substep_launches(ctx):
    """[(launches per tick, ops, bytes)] of each substep kernel and shape
    the traced ticks launched; None where the table lacks a kernel."""
    sub = table()["substep"][ctx.facts["robot"]]
    out = []
    for key, per_tick in ctx.counters.items():
        m = _KEY.match(key)
        if m is None or per_tick <= 0:
            continue
        name, K, n = m.group(1), int(m.group(2)), int(m.group(3))
        if name not in sub:
            return None
        row = sub[name]
        out.append((per_tick, row["ops_per_lane_substep"] * K * n,
                    4 * K * (row["rows_in"] + row["rows_out"])))
    return out

