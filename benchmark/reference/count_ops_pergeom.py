"""Regenerates ``optable_pergeom.json``: the work of one lane and one
substep of the per-geom kernel (``substep_pergeom``, K4) that
``pergeom_roofline`` divides by, counted once on the frozen copies beside
this file, as ``count_ops`` counts ``optable.json``'s rows.  Run from the
repository root:

    python3 -m benchmark.reference.count_ops_pergeom   # prints the table

A lane reads its state, its control and 4 plane rows a collision sphere,
and writes its state.
"""
from __future__ import annotations

import json

from .assets import load_robot
from .scalar_core import count_substep_ops

KERNEL = "substep_pergeom"
# the commit the frozen copies were taken at (``count_ops``'s)
COMMIT = "9b29168ec2c43eefc0e6d4c68a52cf222147e4e6"


def table() -> dict:
    model = load_robot("opendog", "terrain")
    row = dict(ops_per_lane_substep=count_substep_ops(model, 0.01,
                                                      "per_geom"),
               rows_in=model.nq + model.nv + model.nu + 4 * model.ngeom,
               rows_out=model.nq + model.nv)
    return {"commit": COMMIT,
            "substep": {"opendog": {KERNEL: row}}}


if __name__ == "__main__":
    print(json.dumps(table(), indent=1))
