"""The op-graph MPPI engine (``MPPIConfig(engine="ops")``, the JAX
package's ``engine="xla"``: ``dynamics.step`` over all K rollouts at once)
against the JAX package's, with shared noise: solves on flat ground, on the
jump scene's box and on a terrain, and MPC ticks whose plant is the
op-graph step too.  The JAX solves and ticks are jitted.
"""
import jax
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import make_mpc as jax_make_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc, mppi
from test_torch_exact_plant import (MINI, _chain_normals, _check_traj,
                                    _opendog_on_terrain, _solve_normals)

torch.set_num_threads(1)


def _ops_case(robot):
    """(jax model, port model, jax terrain, port terrain, jax start, port
    start, home joints, target height, config base) of an op-graph solve:
    mini on flat ground (1 ms), Go1 on the jump scene standing on its box,
    OpenDOG standing on a generated terrain (exact bilinear contact in the
    rollouts)."""
    if robot == "mini":
        jm, m = jax_assets.load_mini(), assets.load_mini(device="cpu")
        return (jm, m, None, None, jax_make_state(jm, "home"),
                make_state(m, "home"), np.asarray(jm.key_qpos[0])[7:], 0.115,
                MINI)
    base = dict(horizon=2, num_samples=8, n_substeps=2, rollout_dt=0.01,
                noise_sigma=0.08, temperature=0.3)
    if robot == "go1_jump":
        jm = jax_assets.load_go1("jump")
        m = assets.load_go1("jump", device="cpu")
        jt = t = None
        dx, dz, z = 1.0, 0.18, 0.265 + 0.18
    else:
        jm, m, jt, t, h0, dz = _opendog_on_terrain()
        dx, z = 0.0, 0.0694 + h0
    jst = jax_make_state(jm, "home")
    jst = jst.replace(qpos=jst.qpos.at[0].add(dx).at[2].add(dz))
    st = make_state(m, "home")
    st.qpos[0] += dx
    st.qpos[2] += dz
    return (jm, m, jt, t, jst, st, np.asarray(jm.key_qpos[0])[7:], z, base)


@pytest.mark.parametrize("robot", ["mini", "go1_jump", "opendog_terrain"])
def test_ops_engine_solve_matches_jax_xla(robot):
    """One MPPI solve with ``engine="ops"`` against the JAX solver with
    ``engine="xla"`` (run op by op) on the same noise: mini on flat ground
    (K=8, H=4, 1 ms), Go1 standing on the jump box (box contact) and
    OpenDOG on a terrain (bilinear contact), both at K=8, H=2, 2 x 10 ms.
    Tolerances: ctrl and nominal 1e-4 abs, best_cost and mean_cost 5e-5
    relative, ess 5e-4 relative (those of the kernel solves)."""
    jm, m, jt, t, jst, st, home, z, base = _ops_case(robot)
    jcfg = JaxMPPIConfig(engine="xla", **base)
    jsolve = jax.jit(jax_mppi.make_solver(
        jm, jax_costs.standing_cost(jm, z, home), jcfg, terrain=jt))
    key = jax.random.PRNGKey(9)
    jctrl, jms, jstats = jsolve(jst, jax_mppi.init_state(jm, jcfg), key)

    cfg = MPPIConfig(engine="ops", **base)
    solve = mppi.make_solver(m, costs.standing_cost(m, z, home), cfg,
                             device="cpu", terrain=t)
    normals = torch.from_numpy(_solve_normals(key, cfg.num_samples,
                                              cfg.horizon, m.nu))
    ctrl, ms, stats = solve(st, mppi.init_state(m, cfg), normals=normals)
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=1e-4)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=1e-4)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]),
                                   rtol=rtol, err_msg=name)


def test_ops_engine_mpc_ticks_match_jax_xla():
    """make_mpc with ``engine="ops"`` on mini on flat ground: the rollouts
    and the plant (2 substeps) both on the op-graph step, three ticks
    against JAX make_mpc with ``engine="xla"``.  Tolerances as for the
    kernel loop on mini: ctrl and qpos 1e-5 abs, qvel the step's 1e-3,
    best_cost, mean_cost and ess 5e-5 relative."""
    jm, m = jax_assets.load_mini(), assets.load_mini(device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    n_ticks = 3
    jinit, _, jrun = jax_make_mpc(
        jm, jax_costs.standing_cost(jm, 0.115, home),
        JaxMPPIConfig(engine="xla", **MINI), plant_substeps=2)
    key = jax.random.PRNGKey(0)
    _, want = jax.jit(lambda c: jrun(c, n_ticks))(
        jinit(key, jax_make_state(jm, "home")))
    init, _, run = make_mpc(m, costs.standing_cost(m, 0.115, home),
                            MPPIConfig(engine="ops", **MINI),
                            plant_substeps=2, device="cpu")
    normals = _chain_normals(key, n_ticks, 8, 4, m.nu)
    _, got = run(init(None, make_state(m, "home")), n_ticks,
                 normals=torch.from_numpy(normals))
    _check_traj(got, want)


def test_ops_engine_rejects_payload_and_unknown_engines():
    """``with_payload=True`` rides the kernel's payload rows (JAX asserts
    engine="pallas"); an engine name of the JAX package is not one of the
    port's."""
    m = assets.load_mini(device="cpu")
    cost = costs.standing_cost(m, 0.115, m.key_qpos[0, 7:])
    with pytest.raises(ValueError, match="with_payload"):
        mppi.make_solver(m, cost, MPPIConfig(engine="ops"), device="cpu",
                         with_payload=True)
    for name in ("xla", "pallas"):
        with pytest.raises(ValueError, match="engine must be one of"):
            mppi.make_solver(m, cost, MPPIConfig(engine=name), device="cpu")
