"""What a CUDA graph capture of a tick needs, held where there is no card:
after its first call a tick or solve builds no tensor from host data (a
capture refuses the pageable host-to-device copy that such a tensor costs
on the card), and GraphedTick refuses a device other than CUDA.  The iLQR
cycle also reads nothing back to the host, and its pieces, replayed from
static buffers as a graph replays them, give the eager cycle bit for bit.

This file imports no JAX.
"""
import pytest
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state, terrain as terrain_lib
from opendog_tpu_torch.physics import dynamics
from opendog_tpu_torch.solvers import (GraphedTick, ILQRConfig, MPPIConfig,
                                       costs, ilqr, make_ilqr,
                                       make_ilqr_tracker, make_mpc, mppi)

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


def _refuse_host_reads(mp):
    def refuse(*args, **kwargs):
        raise AssertionError("the cycle read a tensor on the host")

    for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__", "__index__"):
        mp.setattr(torch.Tensor, name, refuse)


def _ilqr_cycle(riccati, u_ref):
    """Go1 trotting under the contact schedule (bench 3b in miniature): 3
    stages of 2 substeps, 2 iterations, 2 tracked ticks of 2 substeps."""
    m = assets.load_go1("flat", device="cpu")
    home = m.key_qpos[0, 7:]
    pc = costs.TrotCostParams()
    cost = costs.contact_schedule_cost(m, costs.trot_schedule(pc), pc, home)
    cfg = ILQRConfig(horizon=3, n_substeps=2, rollout_dt=0.002,
                     iterations=2, riccati=riccati)
    cycle = make_ilqr_tracker(
        m, cost, cfg, track_ticks=2, plant_substeps=2, device="cpu",
        u_ref_fn=costs.trot_gait_ref(m, pc, home) if u_ref else None)
    st, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                          n_substeps=20)
    return cycle, st, m.key_ctrl[0][None].repeat(3, 1)


def _outputs(plant, U, traj, stats):
    return dict(qpos=plant.qpos, qvel=plant.qvel, time=plant.time, U=U,
                **{f"traj_{k}": v for k, v in traj.items()}, **stats)


@pytest.mark.parametrize("riccati,u_ref", [("scan", False), ("scan", True),
                                           ("associative", False)])
def test_ilqr_cycle_needs_no_host_data_or_reads(monkeypatch, riccati,
                                                u_ref):
    """After its first call an iLQR cycle (solve and tracked ticks) builds
    no tensor from host data and reads no tensor on the host (no .item(),
    no Python branch on a tensor, no 0-d tensor index), and computes what
    it computed before."""
    cycle, st, U0 = _ilqr_cycle(riccati, u_ref)
    want = _outputs(*cycle(st, U0), cycle.stats)
    with monkeypatch.context() as mp:
        _refuse_host_data(mp)
        _refuse_host_reads(mp)
        plant, U, traj = cycle(st, U0)
    got = _outputs(plant, U, traj, cycle.stats)
    for k in want:
        assert torch.equal(got[k], want[k]), k


class _StaticReplay:
    """A stand-in for GraphedTick on the CPU: static input buffers, and the
    first call's outputs overwritten by every later call, as a replay
    overwrites them."""

    def __init__(self, fn, example_inputs, device):
        self.fn = fn
        self.inputs = tuple(x.clone() for x in example_inputs)
        self.outputs = None

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            if x is not buf:
                buf.copy_(x)
        out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        elif isinstance(out, tuple):
            for o, n in zip(self.outputs, out):
                o.copy_(n)
        else:
            self.outputs.copy_(out)
        return self.outputs


def test_ilqr_pieces_from_static_buffers_equal_eager(monkeypatch):
    """Two cycles with every piece replayed from static buffers equal two
    eager cycles bit for bit: the solve and the tracker copy what they keep
    before a piece runs again."""
    monkeypatch.setattr(ilqr, "GraphedTick", _StaticReplay)
    runs = []
    for graphs in (False, True):
        cycle, st, U = _ilqr_cycle("scan", True)
        cycle.pieces.graphs = cycle.solve.pieces.graphs = graphs
        outs = []
        for _ in range(2):
            st, U, traj = cycle(st, U)
            outs.append(_outputs(st, U, traj, cycle.stats))
        runs.append(outs)
        if graphs:
            assert len(cycle.solve.pieces.captured) == 6
            assert len(cycle.pieces.captured) == 1
    for eager, replayed in zip(*runs):
        for k in eager:
            assert torch.equal(eager[k], replayed[k]), k


def test_ilqr_graphs_need_cuda():
    m = assets.load_opendog("flat", device="cpu")
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    with pytest.raises(ValueError, match="CUDA"):
        make_ilqr(m, cost, ILQRConfig(horizon=2), device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        make_ilqr_tracker(m, cost, ILQRConfig(horizon=2), track_ticks=2,
                          device="cpu", graphs=True)
