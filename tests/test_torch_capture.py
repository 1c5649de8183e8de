"""What a CUDA graph capture of a tick needs, held where there is no card:
after its first call a tick or solve builds no tensor from host data (a
capture refuses the pageable host-to-device copy that such a tensor costs
on the card), and GraphedTick refuses a device other than CUDA.

This file imports no JAX.
"""
import pytest
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state, terrain as terrain_lib
from opendog_tpu_torch.solvers import (GraphedTick, MPPIConfig, costs,
                                       make_mpc, mppi)

torch.set_num_threads(1)

CFG = MPPIConfig(horizon=2, num_samples=4, n_substeps=1, rollout_dt=0.01,
                 noise_sigma=0.05)


def _refuse_host_data(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tick built a tensor from host data")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)


def _mpc(path, lag):
    """(model, init, tick) of make_mpc: Go1 on flat ground, or OpenDOG on a
    generated terrain with per-geom planes or one trunk plane (kernel
    plant), or with one trunk plane and the exact plant ("exact", the
    default)."""
    if path == "flat":
        m = assets.load_go1("flat", device="cpu")
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
        init, tick, _ = make_mpc(m, cost, CFG, plant_substeps=2,
                                 ctrl_lag=lag, lag_compensation=lag > 0,
                                 device="cpu")
        return m, init, tick
    m = assets.load_opendog("terrain", device="cpu")
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    if path == "exact":
        init, tick, _ = make_mpc(m, cost, CFG, plant_substeps=2,
                                 ctrl_lag=lag, lag_compensation=lag > 0,
                                 device="cpu", terrain=terr)
        return m, init, tick
    init, tick, _ = make_mpc(m, cost, CFG, plant_substeps=2, device="cpu",
                             terrain=terr, terrain_plant="kernel",
                             plane_mode=path)
    return m, init, tick


@pytest.mark.parametrize("path,lag", [("flat", 0), ("flat", 2),
                                      ("per_geom", 0), ("trunk", 0),
                                      ("exact", 0), ("exact", 2)])
def test_tick_builds_no_tensor_from_host_data(monkeypatch, path, lag):
    """An eager make_mpc tick, on flat ground (Go1, lag-free and with a
    compensated lag of 2) and on a terrain (OpenDOG, per-geom planes or
    one trunk plane with the kernel plant; the exact plant, lag-free and
    with a compensated lag of 2)."""
    m, init, tick = _mpc(path, lag)
    carry = init(torch.Generator().manual_seed(0), make_state(m, "home"))
    carry, _ = tick(carry)
    _refuse_host_data(monkeypatch)
    carry, out = tick(carry)
    assert torch.isfinite(out["qpos"]).all()


@pytest.mark.parametrize("plane_mode,payload", [
    (None, 1.5), (None, "tensor"), ("per_geom", 0.5)])
def test_payload_solve_builds_no_tensor_from_host_data(monkeypatch,
                                                       plane_mode, payload):
    """A payload solve (Go1 on flat ground, with a float payload or a
    one-element tensor; OpenDOG on per-geom planes)."""
    if plane_mode is None:
        m = assets.load_go1("flat", device="cpu")
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
        solve = mppi.make_solver(m, cost, CFG, device="cpu",
                                 with_payload=True)
    else:
        m = assets.load_opendog("terrain", device="cpu")
        terr = terrain_lib.generate_terrain(m,
                                            torch.Generator().manual_seed(0))
        cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
        solve = mppi.make_solver(m, cost, CFG, device="cpu", terrain=terr,
                                 plane_mode=plane_mode, with_payload=True)
    if payload == "tensor":
        payload = torch.full((), 1.5)
    st, ms = make_state(m, "home"), mppi.init_state(m, CFG)
    gen = torch.Generator().manual_seed(0)
    want = solve(st, ms, torch.Generator().manual_seed(1), None, payload)
    _refuse_host_data(monkeypatch)
    solve(st, ms, gen, None, payload)
    got = solve(st, ms, torch.Generator().manual_seed(1), None, payload)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].nominal, want[1].nominal)


@pytest.mark.parametrize("scene", ["flat", "jump", "terrain"])
def test_ops_engine_builds_no_tensor_from_host_data(monkeypatch, scene):
    """An ``engine="ops"`` solve (Go1 on flat ground and on the jump box,
    OpenDOG on a generated terrain) and an ops-engine MPC tick, whose plant
    is the op-graph step too."""
    terr = None
    if scene == "terrain":
        m = assets.load_opendog("terrain", device="cpu")
        terr = terrain_lib.generate_terrain(m,
                                            torch.Generator().manual_seed(0))
        cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    else:
        m = assets.load_go1(scene, device="cpu")
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=2, num_samples=4, n_substeps=1, rollout_dt=0.01,
                     noise_sigma=0.05, engine="ops")
    solve = mppi.make_solver(m, cost, cfg, device="cpu", terrain=terr)
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=2, device="cpu",
                             terrain=terr)
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    want = solve(st, ms, torch.Generator().manual_seed(1))
    carry = init(torch.Generator().manual_seed(0), st)
    carry, _ = tick(carry)
    _refuse_host_data(monkeypatch)
    got = solve(st, ms, torch.Generator().manual_seed(1))
    carry, out = tick(carry)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].nominal, want[1].nominal)
    assert torch.isfinite(out["qpos"]).all()


def test_graphed_tick_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        GraphedTick(lambda x: x + 1, (torch.zeros(3),), "cpu")
