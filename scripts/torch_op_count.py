#!/usr/bin/env python3
"""Count the PyTorch operations that one substep of the port's op-graph
step (``opendog_tpu_torch.physics.dynamics.step``) dispatches, in total and
by function.  Each counted operation is one kernel launch on the card
(views, reshapes and other aliasing operations are not counted), so the
count predicts how a step's eager and replayed times scale.

Usage, from the root of a checkout (runs on the CPU, no card needed):

    python3 scripts/torch_op_count.py [go1 | go1_jump | opendog |
                                       opendog_terrain]

The default is OpenDOG on a generated terrain (torch seed 0), the exact
plant of bench 2c, at its home keyframe and control.  A function's count
includes the functions it calls (``contact_terms`` holds
``_contact_geometry``, which holds ``_terrain_height_normal``;
``arrow_solve`` holds ``_chol_solve_unrolled``).  Prints one JSON line.
It imports no JAX.
"""
import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opendog_tpu_torch import assets  # noqa: E402
from opendog_tpu_torch.physics import dynamics, make_state  # noqa: E402
from opendog_tpu_torch.physics import terrain as terrain_lib  # noqa: E402

# operations that alias their input and launch nothing
ALIASES = {"view", "expand", "select", "slice", "unsqueeze", "squeeze", "t",
           "transpose", "detach", "alias", "_unsafe_view", "permute",
           "diagonal", "unbind", "split", "as_strided"}
FUNCTIONS = ("fk", "motion_subspace", "body_velocities", "_spatial_inertias",
             "mass_matrix", "bias_forces", "actuator_forces", "passive_terms",
             "contact_terms", "_contact_geometry", "_terrain_height_normal",
             "arrow_solve", "_chol_solve_unrolled", "integrate")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in ALIASES:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def count(case: str = "opendog_terrain") -> dict:
    terr = None
    if case.startswith("go1"):
        m = assets.load_go1("jump" if case == "go1_jump" else "flat",
                            device="cpu")
    else:
        m = assets.load_opendog("terrain" if case == "opendog_terrain"
                                else "flat", device="cpu")
        if case == "opendog_terrain":
            terr = terrain_lib.generate_terrain(
                m, torch.Generator().manual_seed(0))
    state, ctrl = make_state(m, "home"), m.key_ctrl[0]
    dynamics.step(m, state, ctrl, terr)  # builds the plans, uncounted
    counter = _Counter()
    by_function = collections.Counter()
    originals = {name: getattr(dynamics, name) for name in FUNCTIONS}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            before = sum(counter.ops.values())
            out = fn(*args, **kwargs)
            by_function[name] += sum(counter.ops.values()) - before
            return out
        return wrapper

    try:
        for name, fn in originals.items():
            setattr(dynamics, name, counted(name, fn))
        with counter:
            dynamics.step(m, state, ctrl, terr)
    finally:
        for name, fn in originals.items():
            setattr(dynamics, name, fn)
    return {"case": case, "ops_per_substep": sum(counter.ops.values()),
            "by_function": dict(by_function.most_common()),
            "by_op": dict(counter.ops.most_common(12))}


if __name__ == "__main__":
    print(json.dumps(count(*sys.argv[1:2])))
