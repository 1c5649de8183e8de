"""Driver of closed-loop MPC ticks with per-geom contact planes: the
closed-loop driver of ``mpc_closed_loop`` (the program's ``make_mpc`` tick
with ``plane_mode="per_geom"`` and ``terrain_plant="kernel"``, replayed
from its CUDA graph), judged against the plain per-geom tick
(``benchmark/reference/pergeom.py``) instead of the trunk-plane one.  The
compared outputs and their names are ``mpc_closed_loop``'s."""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.drivers.mpc_closed_loop import (COMPARED, Driver,  # noqa: F401
                                               _cost_spec, gaps)


def reference_outputs(config: Dict, traffic: Dict, rec: Dict,
                      tf32: bool = False, device="cpu") -> Dict:
    """The plain per-geom reference's outputs of the sampled ticks ``rec``
    (rank 0's records), from their inputs, on ``device`` (the card in a
    run), on the CPU."""
    from benchmark.reference import mppi as rmppi, pergeom
    from benchmark.reference.assets import load_robot
    from benchmark.reference.physics import Terrain
    if (config["plant"]["terrain_plant"] != "kernel"
            or config["mppi"]["plane_mode"] != "per_geom"
            or rec["heights"] is None):
        raise ValueError("the per-geom reference has per-geom rollouts and "
                         "the per-geom kernel plant on a terrain, nothing "
                         "else")
    model = load_robot(config["robot"], config["scene"], device)
    terrain = Terrain(height=rec["heights"].to(device))
    cost = rmppi.cost_of(model, _cost_spec(config, rec["target_height"]))
    m = dict(config["mppi"], num_samples=traffic["num_samples"],
             horizon=traffic.get("horizon", config["mppi"]["horizon"]))
    tick = pergeom.build_tick(model, cost, m, config["plant"]["substeps"],
                              terrain)
    on = {k: rec[k].to(device) for k in ("qpos", "qvel", "time", "nominal",
                                         "normals")}
    with torch.inference_mode():
        out = tick(on["qpos"], on["qvel"], on["time"], on["nominal"],
                   on["normals"], tf32=tf32)
    return {k: v.cpu() for k, v in out.items()}


def check(config: Dict, traffic: Dict, records: List[Dict],
          tf32: bool = False, device="cpu") -> Dict[str, float]:
    """The numbers compared: each output's widest gap from the per-geom
    reference over the sampled ticks (one rank).  With ``tf32`` the
    reference in TF32 takes the program's place: the control's readings."""
    if len(records) != 1:
        raise ValueError("the per-geom cell runs on one rank")
    rec = records[0]
    ref = reference_outputs(config, traffic, rec, device=device)
    if tf32:
        served = reference_outputs(config, traffic, rec, tf32=True,
                                   device=device)
        rec = dict(rec, **{pk: served[rk] for _, rk, pk in COMPARED})
    return gaps(ref, rec)
