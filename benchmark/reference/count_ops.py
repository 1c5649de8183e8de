"""Regenerates ``optable.json``: the work of one lane and one substep that
``substep_roofline`` divides by, counted once on the frozen copies beside
this file (they were taken at commit 9b29168, so the table reads as the
program's own count at that commit).  Run from the repository root:

    python3 -m benchmark.reference.count_ops      # prints the table

The operations are ``scalar_core.count_substep_ops``'s: every elementwise
operation of the plain substep on one lane, transcendentals weighted.
"""
from __future__ import annotations

import json

from .assets import load_robot
from .scalar_core import count_substep_ops

# (robot, scene, kernel, plane mode) of the kernels the cells launch
KERNELS = (("go1", "flat", "substep_flat", False),
           ("opendog", "terrain", "substep_plane", True))


def table() -> dict:
    sub = {}
    for robot, scene, kernel, plane in KERNELS:
        model = load_robot(robot, scene)
        sub.setdefault(robot, {})[kernel] = dict(
            ops_per_lane_substep=count_substep_ops(model, 0.01, plane),
            rows_in=model.nq + model.nv + model.nu + (4 if plane else 0),
            rows_out=model.nq + model.nv)
    return {"commit": "9b29168ec2c43eefc0e6d4c68a52cf222147e4e6",
            "substep": sub}


if __name__ == "__main__":
    print(json.dumps(table(), indent=1))
