"""The control, at a size a test run holds: the plain reference with its
products in TF32 (the precision below the configurations' float32 with
TF32 off), put in the program's place, must come out not correct against
every cell's committed limits.  On the chip the same control is read at
each cell's own size (``python3 -m benchmark.tools.control``); PERF.md
gives those readings."""
import pytest
import torch

from benchmark.drivers import mpc_closed_loop as drv
from benchmark.harness import spec
from benchmark.reference.mppi import round_tf32
from benchmark.tests.test_benchmark_reference import SMALL, _program_tick


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -13])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                      -3.0 - 2 ** -9]


@pytest.mark.parametrize("cell_name", ["go1_trot_k4096", "go1_trot_k256",
                                       "opendog_terrain_exact",
                                       "go1_trot_k4096_x4"])
def test_the_control_is_not_correct(cell_name):
    cell = spec.Cell(cell_name)
    traffic = dict(cell.traffic, **SMALL)
    inputs = drv.make_inputs(cell.config, traffic, 2 ** 31 + 23)
    nu = {"go1": 12, "opendog": 8}[cell.config["robot"]]
    normals = torch.randn((8, 2, nu), generator=torch.Generator()
                          .manual_seed(9))
    nominal, carry, out = _program_tick(cell, inputs, normals)
    rec = dict(qpos=inputs["qpos"][None], qvel=inputs["qvel"][None],
               time=torch.zeros(1), nominal=nominal[None],
               normals=normals[None], heights=inputs["heights"],
               target_height=inputs["target_height"],
               out_ctrl=out["ctrl"][None],
               out_nominal=carry.solver.nominal[None],
               out_qpos=carry.plant.qpos[None],
               out_qvel=carry.plant.qvel[None])
    program = drv.check(cell.config, traffic, [rec])
    control = drv.check(cell.config, traffic, [rec], tf32=True)
    limits = cell.limits
    assert all(program[k] <= limits[k] for k in program), program
    assert any(control[k] > limits[k] for k in control), control
