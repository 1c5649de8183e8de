"""Go1 at full width with the distiller's expert: one anchored,
command-conditioned kernel-engine solve against the JAX package's, whose
kernel runs its scalar core eagerly (the Go1 kernel graph takes minutes to
compile on the CPU).  Tolerances of the Go1 solve of
tests/test_torch_mppi_mpc.py: ctrl and nominal 1e-4 abs, best_cost and
mean_cost 5e-5 relative, ess 5e-4 relative.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
from test_torch_exact_plant import _solve_normals
from test_torch_mppi_cmd import START_T
from test_torch_mppi_mpc import _eager_scalar_core_step

torch.set_num_threads(1)


def test_go1_anchored_command_solve_matches_jax_scalar_core(monkeypatch):
    """Go1 at full width with the distiller's expert (trot_cost_cmd with
    the calibrated law and steering, anchored with anchor_w = 15 to
    trot_gait_ref_cmd), one solve at K=8, H=3 (2 x 10 ms) from t = 0.37 s
    against the JAX solver on its scalar core run eagerly; tolerances of
    the Go1 solve of tests/test_torch_mppi_mpc.py."""
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        _eager_scalar_core_step)
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    params = dict(desired_vel_xy=(0.5, 0.0), target_height=0.265,
                  lift_phase=float(np.pi / 2), thigh_amp=0.19,
                  w_heading=15.0, amp_v0=0.16, turn_gain=1.2)
    base = dict(horizon=3, num_samples=8, n_substeps=2, rollout_dt=0.01,
                noise_sigma=0.10, temperature=0.2)
    jp, p = jax_costs.TrotCostParams(**params), costs.TrotCostParams(**params)
    jcfg = JaxMPPIConfig(engine="pallas", **base)
    jsolve = jax_mppi.make_solver(
        jm, jax_costs.trot_cost_cmd(jm, jp, home), jcfg, with_command=True,
        u_ref_fn=jax_costs.trot_gait_ref_cmd(jm, jp, home), anchor_w=15.0)
    cmd = (0.3, 0.0, 0.4)
    key = jax.random.PRNGKey(3)
    jst = jax_make_state(jm, "home").replace(time=jnp.float32(START_T))
    with jax.disable_jit():
        jctrl, jms, jstats = jsolve(jst, jax_mppi.init_state(jm, jcfg), key,
                                    jnp.asarray(cmd, jnp.float32))
    cfg = MPPIConfig(**base)
    solve = mppi.make_solver(
        m, costs.trot_cost_cmd(m, p, home), cfg, device="cpu",
        with_command=True, u_ref_fn=costs.trot_gait_ref_cmd(m, p, home),
        anchor_w=15.0)
    st = make_state(m, "home")
    st.time = torch.tensor(START_T)
    normals = torch.from_numpy(_solve_normals(key, 8, 3, m.nu))
    ctrl, ms, stats = solve(st, mppi.init_state(m, cfg), None, normals,
                            torch.tensor(cmd))
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=1e-4)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=1e-4)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]),
                                   rtol=rtol, err_msg=name)
