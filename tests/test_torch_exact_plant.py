"""The exact-bilinear terrain plant (``make_mpc``'s default
``terrain_plant="exact"``: the op-graph step on the terrain) against the
JAX package's, with shared noise: MPC ticks on the mini ramp, the plant
alone on OpenDOG on a generated terrain, and ``RealtimeController`` on a
terrain (benchmark mode, whose plant is the exact step, and a compensated
bridge, whose roll-forward is).  The op-graph MPPI engine is held in
tests/test_torch_ops_engine.py.

As in tests/test_torch_mppi_mpc.py the JAX noise is drawn exactly as the
JAX solver draws it and handed to the port as ``normals``.  mini runs the
JAX kernel in Pallas interpret mode, jitted.
"""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.physics import Terrain as JaxTerrain
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.physics import terrain as jax_terrain
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import make_mpc as jax_make_mpc
from opendog_tpu.solvers import mpc as jax_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import dynamics, make_state, terrain_from_numpy
from opendog_tpu_torch.solvers import (MPPIConfig, RealtimeController, costs,
                                       make_mpc, mpc)

torch.set_num_threads(1)

RANGE_TOL = 1e-6  # a softmax-weighted mean of clipped plans may round out


def _solve_normals(key, K, H, nu):
    """The (K, H, nu) standard normals one JAX solve draws from ``key``."""
    keys = jax.random.split(key, K)
    return np.array(jax.vmap(
        lambda k: jax.random.normal(k, (H, nu), dtype=jnp.float32))(keys))


def _chain_normals(key, n, K, H, nu):
    """The normals of ``n`` solves each drawn from ``key, sub =
    split(key)`` (MPC ticks, controller ticks and bridge ticks)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_solve_normals(sub, K, H, nu))
    return np.stack(out)


def _interpret(monkeypatch):
    orig = jax_pallas_step.build_pallas_substep
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _mini_ramp(slope=0.02, n=9, half=2.0, timestep=0.001):
    """mini on the linear x-ramp of tests/test_pallas_core.py at a 1 ms
    step (at its 2 ms the plant on the ramp reaches qvel ~600 rad/s within
    three ticks in both packages): (jax model, port model, jax terrain,
    port terrain)."""
    jm = jax_assets.load_mini().replace(
        hfield_size=jnp.asarray([half, half, 1.0, 0.0], jnp.float32),
        timestep=timestep)
    m = assets.load_mini(device="cpu").replace(
        hfield_size=torch.tensor([half, half, 1.0, 0.0]), timestep=timestep)
    xs = np.linspace(-half, half, n, dtype=np.float32)
    height = np.tile(slope * xs[None, :], (n, 1))
    return (jm, m, JaxTerrain(height=jnp.asarray(height)),
            terrain_from_numpy(height, "cpu"))


MINI = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001,
            noise_sigma=0.05)


def _check_traj(got, want, atol=1e-5, rtol=5e-5):
    """ctrl and qpos to ``atol``, qvel to the step's 1e-3, the solve's
    stats to ``rtol``."""
    for name, tol in (("ctrl", atol), ("qpos", atol), ("qvel", 1e-3)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("best_cost", "ess", "mean_cost"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=rtol, err_msg=name)


def test_mini_ramp_exact_plant_ticks_match_jax(monkeypatch):
    """make_mpc(terrain=...) with the default exact plant: three ticks on
    the mini ramp (kernel rollouts on one trunk plane, bench 2c's mode; a
    2-substep op-graph plant with bilinear contact) against JAX make_mpc
    in Pallas interpret mode.  Tolerances as for the kernel plant on the
    ramp (tests/test_torch_terrain_mpc.py): ctrl and qpos 1e-5 abs, qvel
    the step's 1e-3 (measured: 2.6e-5), best_cost, mean_cost and ess 5e-5
    relative."""
    _interpret(monkeypatch)
    jm, m, jt, t = _mini_ramp()
    home = np.asarray(jm.key_qpos[0])[7:]
    n_ticks = 3
    jinit, _, jrun = jax_make_mpc(
        jm, jax_costs.standing_cost(jm, 0.115, home),
        JaxMPPIConfig(engine="pallas", **MINI), plant_substeps=2,
        terrain=jt)
    key = jax.random.PRNGKey(0)
    _, want = jax.jit(lambda c: jrun(c, n_ticks))(
        jinit(key, jax_make_state(jm, "home")))

    init, _, run = make_mpc(m, costs.standing_cost(m, 0.115, home),
                            MPPIConfig(**MINI), plant_substeps=2,
                            device="cpu", terrain=t)
    normals = _chain_normals(key, n_ticks, 8, 4, m.nu)
    _, got = run(init(None, make_state(m, "home")), n_ticks,
                 normals=torch.from_numpy(normals))
    _check_traj(got, want)


def _opendog_on_terrain():
    """OpenDOG on the generated terrain of PRNGKey(0) (JAX's heights
    carried across), standing: its trunk 0.0694 m above the ground under
    (0, 0).  (jax model, port model, jax terrain, port terrain, ground
    height under the start, lift of the keyframe)."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jt = jax_terrain.generate_terrain(jax.random.PRNGKey(0), jm)
    t = terrain_from_numpy(np.asarray(jt.height), "cpu")
    h0 = float(dynamics._terrain_height_normal(m, t, torch.zeros(1, 2))[0])
    return jm, m, jt, t, h0, h0 + 0.0694 - float(jm.key_qpos[0][2])


def test_opendog_terrain_exact_plant_matches_jax():
    """The plant of bench 2c at full width: ``mpc._make_plant_step`` on
    OpenDOG standing on a generated terrain (kernel engine, the default
    exact plant: 10 x 2 ms of the op-graph step with bilinear contact),
    three ticks under the clipped home control from rest, against the JAX
    package's ``_make_plant_step`` jitted.  The ticks that make_mpc
    composes of a solve and this plant are held on the mini ramp above.
    Tolerances: the step's, 1e-4 qpos and 1e-3 qvel abs; time 1e-7
    relative."""
    jm, m, jt, t, h0, lift = _opendog_on_terrain()
    jplant = jax.jit(jax_mpc._make_plant_step(
        jm, JaxMPPIConfig(engine="pallas"), 10, jt))
    plant = mpc._make_plant_step(m, 10, torch.device("cpu"), t)
    rng = np.asarray(jm.actuator_ctrlrange)
    hold = np.clip(np.asarray(jm.key_ctrl[0]), rng[:, 0], rng[:, 1])
    jst = jax_make_state(jm, "home")
    jst = jst.replace(qpos=jst.qpos.at[2].add(lift))
    st = make_state(m, "home")
    st.qpos[2] += lift
    for _ in range(3):
        jst = jplant(jst, jnp.asarray(hold))
        st = plant(st, torch.from_numpy(hold))
        np.testing.assert_allclose(st.qpos.numpy(), np.asarray(jst.qpos),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(st.qvel.numpy(), np.asarray(jst.qvel),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(st.time), float(jst.time),
                                   rtol=1e-7)
    assert np.abs(np.asarray(jst.qvel)).max() > 1e-2  # it moved


# -- RealtimeController on a terrain ---------------------------------------

@pytest.fixture(scope="module")
def jax_ramp_side():
    """The JAX controller's programs on the mini ramp, jitted once and
    shared by every case (tests/test_torch_realtime.py does the same on
    flat ground): the solve (interpret-mode kernel, trunk plane) and the
    exact plant; the controller's glue runs as it is."""
    jm, _, jt, _ = _mini_ramp()
    cost = jax_costs.standing_cost(jm, 0.115, np.asarray(jm.key_qpos[0])[7:])
    cfg = JaxMPPIConfig(engine="pallas", **MINI)
    orig_build = jax_pallas_step.build_pallas_substep
    orig_solver = jax_mppi.make_solver
    orig_plant = jax_mpc._make_plant_step
    shared = {}

    def solver(*a, **k):
        if "solve" not in shared:
            shared["solve"] = jax.jit(orig_solver(*a, **k))
        return shared["solve"]

    def plant(*a, **k):
        if "plant" not in shared:
            shared["plant"] = jax.jit(orig_plant(*a, **k))
        return shared["plant"]

    glue = types.SimpleNamespace(jit=lambda f, **_: f, random=jax.random)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pallas_step, "build_pallas_substep",
                   lambda *a, **k: orig_build(*a, **{**k, "interpret": True}))
        mp.setattr(jax_mppi, "make_solver", solver)
        mp.setattr(jax_mpc, "_make_plant_step", plant)
        mp.setattr(jax_mpc, "jax", glue)
        yield jm, jt, cost, cfg


def _check_stream(got, want, lag, m):
    rng = m.numpy("actuator_ctrlrange")
    hold = np.clip(m.numpy("key_ctrl")[0], rng[:, 0], rng[:, 1])
    got, want = np.array(got), np.array(want)
    for i in range(lag):  # the placeholder until the pipeline is primed
        np.testing.assert_array_equal(got[i], hold)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    assert (got >= rng[:, 0] - RANGE_TOL).all()
    assert (got <= rng[:, 1] + RANGE_TOL).all()


N_TICKS = 5


@pytest.mark.parametrize("lag,compensate", [(1, False), (2, True)])
def test_terrain_benchmark_mode_matches_jax(jax_ramp_side, lag, compensate):
    """Benchmark mode on the mini ramp: the internal plant is the exact
    step (and with compensation so is the roll-forward); every returned
    control of five ticks and a drain against the JAX controller's, 1e-5
    abs."""
    jm, jt, jcost, jcfg = jax_ramp_side
    _, m, _, t = _mini_ramp()
    key = jax.random.PRNGKey(0)
    jrtc = jax_mpc.RealtimeController(jm, jcost, jcfg, terrain=jt, lag=lag,
                                      plant_substeps=2, key=key,
                                      compensate=compensate)
    jrtc.start(jax_make_state(jm, "home"))
    want = [np.array(jrtc.tick()) for _ in range(N_TICKS)]
    want.append(np.array(jrtc.drain()))

    _, sub = jax.random.split(key)  # start() hands the carry a split key
    normals = _chain_normals(sub, N_TICKS, 8, 4, m.nu)
    rtc = RealtimeController(m, costs.standing_cost(m, 0.115,
                                                    m.key_qpos[0, 7:]),
                             MPPIConfig(**MINI), terrain=t, lag=lag,
                             plant_substeps=2, compensate=compensate,
                             device="cpu")
    rtc.start(make_state(m, "home"))
    got = [rtc.tick(torch.from_numpy(n)) for n in normals]
    got.append(rtc.drain())
    _check_stream(got, want, lag, m)
    assert np.isfinite(rtc.plant.qpos.numpy()).all()


def test_terrain_compensated_bridge_matches_jax(jax_ramp_side):
    """A compensated bridge at lag 2 on the mini ramp (the roll-forward
    through the in-flight controls is the exact step) on measured states
    from the port's exact plant: five ticks, a drain, three more, against
    the JAX controller's, 1e-5 abs."""
    jm, jt, jcost, jcfg = jax_ramp_side
    _, m, _, t = _mini_ramp()
    plant = dynamics.step
    rng_c = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng_c[:, 0], rng_c[:, 1])
    st, states = make_state(m, "home"), []
    st.qvel[0] = 0.05
    for _ in range(N_TICKS + 3):
        states.append((st.qpos.numpy().copy(), st.qvel.numpy().copy(),
                       float(st.time)))
        st = plant(m, st, hold, t, n_substeps=2)[0]
    key = jax.random.PRNGKey(1)
    jrtc = jax_mpc.RealtimeController(jm, jcost, jcfg, terrain=jt, lag=2,
                                      plant_substeps=2, key=key,
                                      compensate=True)
    want = [np.array(jrtc.bridge_tick(*s)) for s in states[:N_TICKS]]
    want.append(np.array(jrtc.drain()))
    want += [np.array(jrtc.bridge_tick(*s)) for s in states[N_TICKS:]]

    normals = [torch.from_numpy(n) for n in
               _chain_normals(key, len(states), 8, 4, m.nu)]
    rtc = RealtimeController(m, costs.standing_cost(m, 0.115,
                                                    m.key_qpos[0, 7:]),
                             MPPIConfig(**MINI), terrain=t, lag=2,
                             plant_substeps=2, compensate=True, device="cpu")
    got = [rtc.bridge_tick(*s, normals=n)
           for s, n in zip(states[:N_TICKS], normals)]
    got.append(rtc.drain())
    got += [rtc.bridge_tick(*s, normals=n)
            for s, n in zip(states[N_TICKS:], normals[N_TICKS:])]
    _check_stream(got, want, 2, m)
