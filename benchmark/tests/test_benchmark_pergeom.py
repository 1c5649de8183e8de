"""The per-geom cell (``opendog_terrain_pergeom_k4096``) on the CPU at a
small size (K=8, H=2, one tick from a perturbed start): the program's
per-geom tick (``make_mpc`` with ``plane_mode="per_geom"`` and
``terrain_plant="kernel"``) against the plain per-geom reference
(``benchmark/reference/pergeom.py``); the reference in TF32 put in the
program's place, and the program broken underneath, come out not correct;
the cell's configuration, traffic, limits and driver load as every cell's
do; its three readers on a synthetic trace, counter and span store, and
None where a program lacks the span; the per-geom op table regenerates
from the frozen copies.  The manifest and isolation tests cover the new
files as they stand."""
import json
import os
import time
import types

import pytest
import torch

from benchmark.drivers import mpc_pergeom as drv
from benchmark.drivers.mpc_closed_loop import make_inputs
from benchmark.harness import cli, spec, stats
from benchmark.harness.trace import TraceData
from benchmark.reference import count_ops_pergeom
from benchmark.tests.test_benchmark_faults import (SMALL, control_altered,
                                                   half_the_rollouts,
                                                   plant_unchanged)

CELL = "opendog_terrain_pergeom_k4096"


def _program_tick(cell, inputs, normals):
    from opendog_tpu_torch import assets
    from opendog_tpu_torch.physics import State, Terrain
    from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
    c, m = cell.config, cell.config["mppi"]
    model = assets.load_opendog(c["scene"], device="cpu")
    cost = costs.standing_cost(model, inputs["target_height"],
                               model.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=2, num_samples=8, temperature=m["temperature"],
                     noise_sigma=m["noise_sigma"], n_substeps=m["n_substeps"],
                     rollout_dt=m["rollout_dt"],
                     smooth_alpha=m["smooth_alpha"], gamma=m["gamma"])
    init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                             device="cpu",
                             terrain=Terrain(height=inputs["heights"]),
                             terrain_plant=c["plant"]["terrain_plant"],
                             plane_mode=m["plane_mode"])
    carry = init(None, State(qpos=inputs["qpos"], qvel=inputs["qvel"],
                             time=torch.zeros(())))
    nominal = carry.solver.nominal.clone()
    carry, out = tick(carry, normals)
    return nominal, carry, out


def _record(seed, normals_seed):
    cell = spec.Cell(CELL)
    traffic = dict(cell.traffic, **SMALL)
    inputs = make_inputs(cell.config, traffic, seed)
    normals = torch.randn((8, 2, 8), generator=torch.Generator()
                          .manual_seed(normals_seed))
    nominal, carry, out = _program_tick(cell, inputs, normals)
    rec = dict(qpos=inputs["qpos"][None], qvel=inputs["qvel"][None],
               time=torch.zeros(1), nominal=nominal[None],
               normals=normals[None], heights=inputs["heights"],
               target_height=inputs["target_height"],
               out_ctrl=out["ctrl"][None],
               out_nominal=carry.solver.nominal[None],
               out_qpos=carry.plant.qpos[None],
               out_qvel=carry.plant.qvel[None])
    return cell, traffic, rec, out


def test_reference_matches_the_program():
    """On the CPU the program's per-geom substep is the plain one and its
    planes are built at the reference's shapes: bit for bit."""
    cell, traffic, rec, out = _record(2 ** 31 + 11, 5)
    readings = drv.check(cell.config, traffic, [rec])
    assert set(readings) == {"ctrl_gap", "nominal_gap", "qpos_gap",
                             "qvel_gap"}
    for name, value in readings.items():
        assert value == 0.0, (name, value)
    ref = drv.reference_outputs(cell.config, traffic, rec)
    assert torch.equal(ref["best_cost"], out["best_cost"][None])


def test_the_control_is_not_correct():
    cell, traffic, rec, _ = _record(2 ** 31 + 23, 9)
    program = drv.check(cell.config, traffic, [rec])
    control = drv.check(cell.config, traffic, [rec], tf32=True)
    assert all(program[k] <= cell.limits[k] for k in program), program
    assert any(control[k] > cell.limits[k] for k in control), control


def test_the_reference_takes_only_its_own_grounds():
    cell, traffic, rec, _ = _record(2 ** 31 + 11, 5)
    exact = dict(cell.config, plant=dict(cell.config["plant"],
                                         terrain_plant="exact"))
    with pytest.raises(ValueError, match="per-geom"):
        drv.reference_outputs(exact, traffic, rec)


def _run(seed=2 ** 31 + 7):
    return cli.run_cell(spec.Cell(CELL), seed, 1.0, False, time.time(),
                        device="cpu", overrides=SMALL)


def test_an_unbroken_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [plant_unchanged, half_the_rollouts,
                                   control_altered])
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]


def test_the_cell_loads_as_every_cell_does():
    cell = spec.Cell(CELL)
    assert cell.chips == 1 and cell.traffic["num_samples"] == 4096
    assert cell.config["mppi"]["plane_mode"] == "per_geom"
    assert cell.config["plant"]["terrain_plant"] == "kernel"
    assert cell.driver() is drv
    assert set(cell.limits) == {"ctrl_gap", "nominal_gap", "qpos_gap",
                                "qvel_gap"}
    assert {m["name"] for m in cell.per_layer} == {
        "pergeom_ms_per_tick", "pergeom_roofline", "planes_ms_per_tick"}


def _synthetic_ctx():
    """Two traced ticks of 10 ms: 25 rollout launches of 0.2 ms and the
    plant's one of 0.19 ms, a trunk-plane kernel that is not K4, 50 op
    kernels of 10 us; the counter as the cell's tick counts it."""
    dev, t = [], 0
    for _ in range(2):
        for _ in range(25):
            dev.append(("kernel", "substep_pergeom", t, t + 200_000))
            t += 210_000
        dev.append(("kernel", "substep_plane", t, t + 50_000))
        t += 60_000
        for _ in range(50):
            dev.append(("kernel", "elementwise_kernel", t, t + 10_000))
            t += 12_000
        dev.append(("kernel", "substep_pergeom", t, t + 190_000))
        t = (t // 10_000_000 + 1) * 10_000_000
    return types.SimpleNamespace(
        trace=TraceData(dev, [], 0, 20_000_000, 2),
        counters={"launches substep_pergeom K=4096 x2": 25.0,
                  "launches substep_pergeom K=1 x10": 1.0,
                  "launches substep_plane K=256 x2": 0.0},
        facts=dict(robot="opendog", world=1, collective_bytes_per_tick=0),
        setup={})


def test_the_pergeom_readers_on_a_synthetic_tick():
    ctx = _synthetic_ctx()
    read = lambda name: spec.reader(name).read(ctx)
    assert read("pergeom_ms_per_tick") == pytest.approx(25 * 0.2 + 0.19)
    # OpenDOG: nq 15, nv 14, nu 8, 24 spheres of 4 plane rows
    ops = 27757
    with open(os.path.join(spec.BENCH, "reference",
                           "optable_pergeom.json")) as f:
        row = json.load(f)["substep"]["opendog"]["substep_pergeom"]
    assert row == dict(ops_per_lane_substep=ops, rows_in=133, rows_out=29)
    least = (25 * stats.bound_s(ops * 4096 * 2, 4 * 4096 * 162)
             + stats.bound_s(ops * 10, 4 * 162))
    assert read("pergeom_roofline") == pytest.approx(
        100 * least / (5.19e-3))
    assert 0 < read("pergeom_roofline") <= 100
    go1 = dict(ctx.facts, robot="go1")
    assert spec.reader("pergeom_roofline").read(
        types.SimpleNamespace(**dict(vars(ctx), facts=go1))) is None
    untraced = types.SimpleNamespace(**dict(vars(ctx), trace=None,
                                            counters=None))
    for name in ("pergeom_ms_per_tick", "pergeom_roofline",
                 "planes_ms_per_tick"):
        assert spec.reader(name).read(untraced) is None, name


def test_planes_reads_the_span_and_nothing_without_it(monkeypatch):
    from opendog_tpu_torch.utils import profiling
    ctx = types.SimpleNamespace(trace=TraceData([], [], 4, 6, 1))
    store = profiling.SpanStore()
    for at, ms in ((1, 0.5), (2, 0.7), (5, 9.0), (8, 0.6)):
        store.add_device("mppi.planes", at, ms)
        store.add_device("mppi.rollout", at, 10 * ms)
    monkeypatch.setattr(profiling, "SPANS", store)
    read = spec.reader("planes_ms_per_tick").read
    assert read(ctx) == pytest.approx(0.6)     # the traced 5 ns left out
    # a program without the span (an earlier commit) reads None
    monkeypatch.setattr(profiling, "SPANS", profiling.SpanStore())
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "SPANS")
    assert read(ctx) is None


def test_the_pergeom_op_table_regenerates_from_the_frozen_copies():
    path = os.path.join(spec.BENCH, "reference", "optable_pergeom.json")
    with open(path) as f:
        assert count_ops_pergeom.table() == json.load(f)
