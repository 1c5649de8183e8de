"""The slice as a whole: the port's MPPI solver and MPC loop against the JAX
package's, with shared noise.

PyTorch cannot reproduce ``jax.random``, so the tests draw the JAX noise
exactly as the JAX solver does -- one ``jax.random.split(carry.key)`` per
tick (mpc.py:153), ``jax.random.split(sub, K)`` and one
``jax.random.normal(k, (H, nu))`` per sample (mppi.py:276, 342) -- and hand
it to the port as ``normals``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.ops import scalar_core as jax_scalar_core
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import make_mpc as jax_make_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state
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


def test_mini_mpc_ticks_match_jax_pallas_interpret(monkeypatch):
    """mini: three MPC ticks (solve + 2-substep kernel plant) against JAX
    make_mpc with engine="pallas" in interpret mode (the setup of
    test_pallas_core.py:307-334, at a 1 ms rollout step: with 4 ms the
    light mini legs drive the loop unstable within four ticks -- plant qvel
    in the hundreds, costs ~1e6 -- where float32 rounding of the costs
    alone moves the softmax).  Tolerances: ctrl and plant qpos 1e-5 abs,
    best_cost, mean_cost and ess 5e-5 relative (measured on the CPU: 4e-7,
    1e-6 and 8e-6)."""
    orig = jax_pallas_step.build_pallas_substep
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jm = jax_assets.load_mini()
    m = assets.load_mini(device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001,
                noise_sigma=0.05)
    n_ticks = 3

    jinit, _, jrun = jax_make_mpc(
        jm, jax_costs.standing_cost(jm, 0.115, home),
        JaxMPPIConfig(engine="pallas", **base), plant_substeps=2)
    key = jax.random.PRNGKey(0)
    _, want = jax.jit(lambda c: jrun(c, n_ticks))(
        jinit(key, jax_make_state(jm, "home")))

    init, _, run = make_mpc(m, costs.standing_cost(m, 0.115, home),
                            MPPIConfig(**base), plant_substeps=2,
                            device="cpu")
    normals = _tick_normals(key, n_ticks, 8, 4, m.nu)
    _, got = run(init(None, make_state(m, "home")), n_ticks,
                 normals=torch.from_numpy(normals))

    for name in ("ctrl", "qpos"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("best_cost", "ess", "mean_cost"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=5e-5, err_msg=name)


def _eager_scalar_core_step(model, dt, k_tile=256, n_substeps=1, **_):
    """A stand-in for build_pallas_substep that runs the JAX scalar core
    eagerly: the go1 kernel graph takes minutes to compile on the CPU."""
    sub = jax_scalar_core.build_substep(model, dt)

    def step(qpos, qvel, ctrl):
        qp = tuple(qpos[i] for i in range(model.nq))
        qv = tuple(qvel[i] for i in range(model.nv))
        ct = tuple(ctrl[i] for i in range(model.nu))
        for _ in range(n_substeps):
            qp, qv = sub(qp, qv, ct)
        return jnp.stack(qp), jnp.stack(qv)

    return step


def test_go1_solve_matches_jax_scalar_core(monkeypatch):
    """go1 at full width, one MPPI solve of the bench.py configuration at
    K=8, H=3 (2 substeps of 10 ms) against the JAX solver on the scalar
    core, run eagerly with the same noise.  The two libraries' float32
    sin / cos differ in the last bits, which moves the costs by ~1e-5
    relative and the softmax weights at temperature 0.3 by more.
    Tolerances: ctrl and nominal 1e-4 abs, best_cost and mean_cost 5e-5
    relative, ess 5e-4 relative (measured on the CPU: 1.8e-5, 8e-6 and
    9.5e-5)."""
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        _eager_scalar_core_step)
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=3, num_samples=8, n_substeps=2, rollout_dt=0.01,
                noise_sigma=0.12, temperature=0.3)
    params = dict(desired_vel_xy=(0.5, 0.0), target_height=0.265)
    jcfg = JaxMPPIConfig(engine="pallas", **base)
    jsolve = jax_mppi.make_solver(
        jm, jax_costs.trot_cost(jm, jax_costs.TrotCostParams(**params), home,
                                legs="go1"), jcfg)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        jctrl, jms, jstats = jsolve(jax_make_state(jm, "home"),
                                    jax_mppi.init_state(jm, jcfg), key)

    cfg = MPPIConfig(**base)
    solve = mppi.make_solver(
        m, costs.trot_cost(m, costs.TrotCostParams(**params), home,
                           legs="go1"), cfg, device="cpu")
    normals = torch.from_numpy(_solve_normals(key, 8, 3, m.nu))
    ctrl, ms, stats = solve(make_state(m, "home"), mppi.init_state(m, cfg),
                            normals=normals)

    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=1e-4)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=1e-4)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]),
                                   rtol=rtol, err_msg=name)


def _opendog_standing():
    m = assets.load_opendog("flat", device="cpu")
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=4, num_samples=16, n_substeps=1,
                     rollout_dt=0.01, noise_sigma=0.05)
    return m, cost, cfg


def test_compensated_prediction_matches_actual_plant():
    """The invariant of tests/test_lag_compensation.py:32 in the port: the
    state a compensated solve plans from at tick t equals the actual plant
    state when its action is applied (tick t+lag)."""
    m, cost, cfg = _opendog_standing()
    lag = 2
    init, _, run = make_mpc(m, cost, cfg, plant_substeps=2, ctrl_lag=lag,
                            lag_compensation=True, device="cpu")
    carry = init(torch.Generator().manual_seed(3), make_state(m, "home"))
    _, traj = run(carry, 8)
    pred = traj["solve_from_qpos"].numpy()
    qpos = traj["qpos"].numpy()
    for t in range(8 - lag):
        np.testing.assert_allclose(pred[t], qpos[t + lag - 1],
                                   rtol=1e-5, atol=1e-6)
    # the plant applies the clipped hold control while the queue primes
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1]).numpy()
    np.testing.assert_allclose(traj["ctrl"][0].numpy(), hold, atol=1e-6)
    np.testing.assert_allclose(traj["ctrl"][1].numpy(), hold, atol=1e-6)


def test_compensated_first_solve_sees_future_not_initial_state():
    """The second invariant of tests/test_lag_compensation.py in the port:
    both lag-2 pipelines apply the hold control while priming; the
    compensated one plans tick 0 from a predicted state that has moved
    (falling, advancing start), so its first applied plan differs from
    the uncompensated one drawn with the same generator seed."""
    m, cost, cfg = _opendog_standing()
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1]).numpy()
    st0 = make_state(m, "home")
    st0.qvel[2], st0.qvel[0] = -0.3, 0.2
    outs = {}
    for comp in (False, True):
        init, _, run = make_mpc(m, cost, cfg, plant_substeps=2, ctrl_lag=2,
                                lag_compensation=comp, device="cpu")
        _, traj = run(init(torch.Generator().manual_seed(7), st0), 4)
        outs[comp] = traj
        for t in (0, 1):
            np.testing.assert_allclose(traj["ctrl"][t].numpy(), hold,
                                       atol=1e-6)
    pred0 = outs[True]["solve_from_qpos"][0].numpy()
    q0 = st0.qpos.numpy()
    assert abs(pred0[2] - q0[2]) > 1e-4 and abs(pred0[0] - q0[0]) > 1e-4
    assert "solve_from_qpos" not in outs[False]
    diff = (outs[False]["ctrl"][2] - outs[True]["ctrl"][2]).abs().max()
    assert diff.item() > 1e-5


def test_generator_draws_are_reproducible_and_solver_checks_inputs():
    m, cost, cfg = _opendog_standing()
    solve = mppi.make_solver(m, cost, cfg, device="cpu")
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    a = solve(st, ms, torch.Generator().manual_seed(5))[0]
    b = solve(st, ms, torch.Generator().manual_seed(5))[0]
    c = solve(st, ms, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="normals must have shape"):
        solve(st, ms, normals=torch.zeros(3, 4, m.nu))
    with pytest.raises(ValueError, match="M8"):
        mppi.make_solver(m, cost, MPPIConfig(engine="xla"), device="cpu")
