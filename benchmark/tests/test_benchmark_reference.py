"""The plain reference against the program on the CPU at a small size
(K=8, H=2, one tick from a perturbed start), for the Go1 flat tick and the
OpenDOG tick on rough terrain with the exact plant: the same inputs give
the same outputs.  On the CPU the program runs the plain substep, so the
flat tick agrees bit for bit; the terrain tick's plant runs one state in
the program and a batch of them in the reference, which may round the
op-graph step's products differently (1e-6 allows for that and for
nothing more).  Also: the frozen op table regenerates from the frozen
copies."""
import json
import os

import pytest
import torch

from benchmark.drivers import mpc_closed_loop as drv
from benchmark.harness import spec
from benchmark.reference import count_ops

SMALL = dict(num_samples=8, horizon=2, warmup_s=0, estimate_ticks=1, check_ticks=1)


def _program_tick(cell, inputs, normals):
    from opendog_tpu_torch import assets
    from opendog_tpu_torch.physics import State, Terrain
    from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
    c, m = cell.config, cell.config["mppi"]
    load = {"go1": assets.load_go1, "opendog": assets.load_opendog}
    model = load[c["robot"]](c["scene"], device="cpu")
    spec_ = drv._cost_spec(c, inputs["target_height"])
    home = model.key_qpos[0, 7:]
    if spec_["name"] == "trot":
        cost = costs.trot_cost(model, costs.TrotCostParams(
            desired_vel_xy=tuple(spec_["desired_vel_xy"]),
            target_height=spec_["target_height"]), home, legs=spec_["legs"])
    else:
        cost = costs.standing_cost(model, spec_["target_height"], home)
    cfg = MPPIConfig(horizon=2, num_samples=8, temperature=m["temperature"],
                     noise_sigma=m["noise_sigma"], n_substeps=m["n_substeps"],
                     rollout_dt=m["rollout_dt"],
                     smooth_alpha=m["smooth_alpha"], gamma=m["gamma"])
    terrain = (None if inputs["heights"] is None
               else Terrain(height=inputs["heights"]))
    init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                             device="cpu", terrain=terrain)
    carry = init(None, State(qpos=inputs["qpos"], qvel=inputs["qvel"],
                             time=torch.zeros(())))
    nominal = carry.solver.nominal.clone()
    carry, out = tick(carry, normals)
    return nominal, carry, out


@pytest.mark.parametrize("cell_name,tol", [("go1_trot_k256", 0.0),
                                           ("opendog_terrain_exact", 1e-6)])
def test_reference_matches_the_program(cell_name, tol):
    cell = spec.Cell(cell_name)
    traffic = dict(cell.traffic, **SMALL)
    inputs = drv.make_inputs(cell.config, traffic, 2 ** 31 + 11)
    nu = {"go1": 12, "opendog": 8}[cell.config["robot"]]
    normals = torch.randn((8, 2, nu), generator=torch.Generator()
                          .manual_seed(5))
    nominal, carry, out = _program_tick(cell, inputs, normals)
    rec = dict(qpos=inputs["qpos"][None], qvel=inputs["qvel"][None],
               time=torch.zeros(1), nominal=nominal[None],
               normals=normals[None], heights=inputs["heights"],
               target_height=inputs["target_height"],
               out_ctrl=out["ctrl"][None],
               out_nominal=carry.solver.nominal[None],
               out_qpos=carry.plant.qpos[None],
               out_qvel=carry.plant.qvel[None])
    readings = drv.check(cell.config, traffic, [rec])
    assert set(readings) == {"ctrl_gap", "nominal_gap", "qpos_gap",
                             "qvel_gap"}
    for name, value in readings.items():
        assert value <= tol, (name, value)
    ref = drv.reference_outputs(cell.config, traffic, rec)
    assert torch.allclose(ref["best_cost"], out["best_cost"][None],
                          rtol=1e-6, atol=0)


def test_inputs_follow_the_seed_and_only_the_seed():
    cell = spec.Cell("opendog_terrain_exact")
    a = drv.make_inputs(cell.config, cell.traffic, 2 ** 31 + 5)
    b = drv.make_inputs(cell.config, cell.traffic, 2 ** 31 + 5)
    c = drv.make_inputs(cell.config, cell.traffic, 2 ** 31 + 6)
    assert torch.equal(a["heights"], b["heights"])
    assert torch.equal(a["qpos"], b["qpos"])
    assert not torch.equal(a["heights"], c["heights"])
    relief = float(a["heights"].max() - a["heights"].min())
    assert relief > 0.05          # the rough branch, every seed


def test_the_op_table_regenerates_from_the_frozen_copies():
    path = os.path.join(spec.BENCH, "reference", "optable.json")
    with open(path) as f:
        assert count_ops.table() == json.load(f)
