"""Terrain and payload MPPI and the terrain MPC loop of the port against the
JAX package's, with shared noise.

As in tests/test_torch_mppi_mpc.py, the JAX noise is drawn exactly as the
JAX solver draws it and handed to the port as ``normals``.  The go1 and
opendog kernels are too slow to trace in Pallas interpret mode on the CPU,
so there the JAX solver runs its scalar core eagerly; mini runs the Pallas
kernel in interpret mode.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.ops import scalar_core as jax_scalar_core
from opendog_tpu.physics import Terrain as JaxTerrain
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.physics import terrain as jax_terrain
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import make_mpc as jax_make_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import dynamics, make_state, terrain_from_numpy
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc, mppi

torch.set_num_threads(1)


def _solve_normals(key, K, H, nu):
    """The (K, H, nu) standard normals one JAX solve draws from ``key``."""
    keys = jax.random.split(key, K)
    return np.array(jax.vmap(
        lambda k: jax.random.normal(k, (H, nu), dtype=jnp.float32))(keys))


def _tick_normals(key, n_ticks, K, H, nu):
    """The normals of ``n_ticks`` JAX MPC ticks started from ``key``."""
    out = []
    for _ in range(n_ticks):
        key, sub = jax.random.split(key)
        out.append(_solve_normals(sub, K, H, nu))
    return np.stack(out)


def _eager_scalar_core_step(model, dt, k_tile=256, n_substeps=1,
                            with_plane=False, with_payload=False, **_):
    """A stand-in for build_pallas_substep that runs the JAX scalar core
    eagerly, in any mode: the opendog and go1 kernel graphs take minutes
    to compile on the CPU."""
    sub = jax_scalar_core.build_substep(model, dt, with_plane=with_plane,
                                        with_payload=with_payload)

    def step(qpos, qvel, ctrl, plane=None, payload=None):
        qp = tuple(qpos[i] for i in range(model.nq))
        qv = tuple(qvel[i] for i in range(model.nv))
        ct = tuple(ctrl[i] for i in range(model.nu))
        pl = None if plane is None else tuple(plane[i]
                                              for i in range(plane.shape[0]))
        py = None if payload is None else payload[0]
        for _ in range(n_substeps):
            qp, qv = sub(qp, qv, ct, pl, py)
        return jnp.stack(qp), jnp.stack(qv)

    return step


def _interpret(monkeypatch):
    orig = jax_pallas_step.build_pallas_substep
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("plane_mode", ["trunk", "per_geom"])
def test_opendog_terrain_solve_matches_jax(monkeypatch, plane_mode):
    """opendog at full width on a generated terrain (JAX's heights carried
    across), standing with its feet on the ground: one MPPI solve of the
    terrain configuration at K=8, H=3 (2 substeps of 10 ms) against the
    JAX solver on its scalar core with the same noise, in both plane
    modes.  Tolerances as for the flat go1 solve: ctrl and nominal 1e-4
    abs, best_cost and mean_cost 5e-5 relative, ess 5e-4 relative."""
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        _eager_scalar_core_step)
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jt = jax_terrain.generate_terrain(jax.random.PRNGKey(0), jm)
    t = terrain_from_numpy(np.asarray(jt.height), "cpu")
    h0 = float(dynamics._terrain_height_normal(m, t, torch.zeros(1, 2))[0])
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=3, num_samples=8, n_substeps=2, rollout_dt=0.01,
                noise_sigma=0.08, temperature=0.3)
    # the keyframe's feet are 0.13 m above its ground: set them on the
    # terrain, 0.0694 m of trunk height above it
    lift = h0 + 0.0694 - float(jm.key_qpos[0][2])
    jst = jax_make_state(jm, "home")
    jst = jst.replace(qpos=jst.qpos.at[2].add(lift))
    st = make_state(m, "home")
    st.qpos[2] += lift
    jcfg = JaxMPPIConfig(engine="pallas", **base)
    jsolve = jax_mppi.make_solver(
        jm, jax_costs.standing_cost(jm, 0.0694 + h0, home), jcfg,
        terrain=jt, plane_mode=plane_mode)
    key = jax.random.PRNGKey(4)
    with jax.disable_jit():
        jctrl, jms, jstats = jsolve(jst, jax_mppi.init_state(jm, jcfg), key)

    cfg = MPPIConfig(**base)
    solve = mppi.make_solver(m, costs.standing_cost(m, 0.0694 + h0, home),
                             cfg, device="cpu", terrain=t,
                             plane_mode=plane_mode)
    normals = torch.from_numpy(_solve_normals(key, 8, 3, m.nu))
    ctrl, ms, stats = solve(st, mppi.init_state(m, cfg), normals=normals)

    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=1e-4)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=1e-4)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]),
                                   rtol=rtol, err_msg=name)


def _mini_ramp(slope=0.02, n=9, half=2.0):
    """The linear x-ramp of tests/test_pallas_core.py::_ramp_terrain_mini
    in both packages: (jax model, port model, jax terrain, port terrain)."""
    jm = jax_assets.load_mini().replace(
        hfield_size=jnp.asarray([half, half, 1.0, 0.0], jnp.float32))
    m = assets.load_mini(device="cpu").replace(
        hfield_size=torch.tensor([half, half, 1.0, 0.0]))
    xs = np.linspace(-half, half, n, dtype=np.float32)
    height = np.tile(slope * xs[None, :], (n, 1))
    return (jm, m, JaxTerrain(height=jnp.asarray(height)),
            terrain_from_numpy(height, "cpu"))


@pytest.mark.parametrize("plane_mode", ["per_geom", "trunk"])
def test_mini_ramp_kernel_plant_ticks_match_jax(monkeypatch, plane_mode):
    """make_mpc(terrain=..., terrain_plant="kernel"): three ticks on the
    mini ramp (per-geom plant planes refreshed every tick; rollouts on
    per-geom or trunk planes) against JAX make_mpc in Pallas interpret
    mode, at the 1 ms rollout step of the flat mini test (the mini loop
    goes unstable at 4 ms) and with a 1 ms plant step (at mini's 2 ms the
    plant on the ramp reaches qvel ~600 rad/s by the third tick in both
    packages).  Tolerances as for the flat mini test: ctrl and plant qpos
    1e-5 abs, best_cost, mean_cost and ess 5e-5 relative."""
    _interpret(monkeypatch)
    jm, m, jt, t = _mini_ramp()
    jm, m = jm.replace(timestep=0.001), m.replace(timestep=0.001)
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001,
                noise_sigma=0.05)
    n_ticks = 3
    jinit, _, jrun = jax_make_mpc(
        jm, jax_costs.standing_cost(jm, 0.115, home),
        JaxMPPIConfig(engine="pallas", **base), plant_substeps=2,
        terrain=jt, terrain_plant="kernel", plane_mode=plane_mode)
    key = jax.random.PRNGKey(0)
    _, want = jax.jit(lambda c: jrun(c, n_ticks))(
        jinit(key, jax_make_state(jm, "home")))

    init, _, run = make_mpc(m, costs.standing_cost(m, 0.115, home),
                            MPPIConfig(**base), plant_substeps=2,
                            device="cpu", terrain=t, terrain_plant="kernel",
                            plane_mode=plane_mode)
    normals = _tick_normals(key, n_ticks, 8, 4, m.nu)
    _, got = run(init(None, make_state(m, "home")), n_ticks,
                 normals=torch.from_numpy(normals))

    for name in ("ctrl", "qpos"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("best_cost", "ess", "mean_cost"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=5e-5, err_msg=name)


def test_mini_payload_solver_matches_jax_at_0_and_2_kg(monkeypatch):
    """make_solver(with_payload=True) on mini against the JAX payload
    solver in interpret mode with the same noise (test_pallas_core.py:
    439-470): at 0 kg and 2 kg, ctrl 1e-5 abs and best_cost 5e-5
    relative; 0 kg reproduces the port's payload-less solve to 1e-6, and
    2 kg on the 1.24 kg robot moves best_cost by more than 1e-3."""
    _interpret(monkeypatch)
    jm = jax_assets.load_mini()
    m = assets.load_mini(device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001)
    jcfg = JaxMPPIConfig(engine="pallas", **base)
    jpay = jax.jit(jax_mppi.make_solver(
        jm, jax_costs.standing_cost(jm, 0.115, home), jcfg,
        with_payload=True))
    key = jax.random.PRNGKey(2)
    cfg = MPPIConfig(**base)
    cost = costs.standing_cost(m, 0.115, home)
    flat = mppi.make_solver(m, cost, cfg, device="cpu")
    pay = mppi.make_solver(m, cost, cfg, device="cpu", with_payload=True)
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    normals = torch.from_numpy(_solve_normals(key, 8, 4, m.nu))
    out = {}
    for kg in (0.0, 2.0):
        jctrl, _, jstats = jpay(jax_make_state(jm, "home"),
                                jax_mppi.init_state(jm, jcfg), key,
                                jnp.float32(kg))
        ctrl, _, stats = pay(st, ms, None, normals, kg)
        np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(stats["best_cost"]),
                                   float(jstats["best_cost"]), rtol=5e-5)
        out[kg] = (ctrl, stats)
    c_flat, _, _ = flat(st, ms, None, normals)
    np.testing.assert_allclose(out[0.0][0].numpy(), c_flat.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.isfinite(out[2.0][0]).all()
    assert abs(float(out[2.0][1]["best_cost"])
               - float(out[0.0][1]["best_cost"])) > 1e-3


def test_terrain_modes_that_are_not_ported_or_unknown_raise():
    """The JAX package's default terrain plant ``"exact"`` (the op-graph
    step with bilinear contact) runs: a tick on the mini ramp from home
    gives a finite plant state that moved.  Unknown terrain plants, plane
    modes and payload arguments raise."""
    m = assets.load_mini(device="cpu")
    _, mr, _, t = _mini_ramp()
    cost = costs.standing_cost(m, 0.115, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=2, num_samples=4, n_substeps=1)
    init, tick, _ = make_mpc(mr, cost, cfg, plant_substeps=2, device="cpu",
                             terrain=t)  # "exact" default
    carry = init(torch.Generator().manual_seed(0), make_state(mr, "home"))
    carry, out = tick(carry)
    assert torch.isfinite(out["qpos"]).all()
    assert torch.isfinite(out["qvel"]).all()
    assert (out["qpos"] - mr.key_qpos[0]).abs().max() > 0
    with pytest.raises(ValueError, match="terrain_plant"):
        make_mpc(mr, cost, cfg, device="cpu", terrain=t,
                 terrain_plant="bilinear")
    with pytest.raises(ValueError, match="plane_mode"):
        make_mpc(mr, cost, cfg, device="cpu", terrain=t,
                 terrain_plant="kernel", plane_mode="per_foot")
    with pytest.raises(ValueError, match="plane_mode"):
        mppi.make_solver(m, cost, cfg, device="cpu", plane_mode="grid")
    pay = mppi.make_solver(m, cost, cfg, device="cpu", with_payload=True)
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    with pytest.raises(ValueError, match="trailing"):
        pay(st, ms, torch.Generator().manual_seed(0))
    flat = mppi.make_solver(m, cost, cfg, device="cpu")
    with pytest.raises(ValueError, match="trailing"):
        flat(st, ms, torch.Generator().manual_seed(0), None, 1.0)
