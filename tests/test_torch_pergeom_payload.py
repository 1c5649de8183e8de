"""Per-geom terrain MPPI with a carried payload, the last mode of the JAX
package's build_pallas_substep (kernel substep_pergeom_payload in the
port), against the JAX solver with the same noise: mini on the linear ramp
of tests/test_torch_terrain_mpc.py, the JAX kernel in Pallas interpret
mode.  The kernel itself is compared with its plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch.ops import cuda_step
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
from test_torch_terrain_mpc import _interpret, _mini_ramp, _solve_normals

torch.set_num_threads(1)


def test_mini_ramp_pergeom_payload_solver_matches_jax(monkeypatch):
    """make_solver(terrain=..., plane_mode="per_geom", with_payload=True) at
    0 kg and 2 kg against the JAX solver of the same mode: ctrl 1e-5 abs and
    best_cost 5e-5 relative, as for the flat payload solver; 0 kg
    reproduces the port's per-geom solve without a payload to 1e-6, and
    2 kg on the 1.24 kg robot moves best_cost by more than 1e-3.  The solve
    runs through the per-geom + payload step."""
    _interpret(monkeypatch)
    jm, m, jt, t = _mini_ramp()
    home = np.asarray(jm.key_qpos[0])[7:]
    base = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001)
    jcfg = JaxMPPIConfig(engine="pallas", **base)
    jsolve = jax.jit(jax_mppi.make_solver(
        jm, jax_costs.standing_cost(jm, 0.115, home), jcfg, terrain=jt,
        plane_mode="per_geom", with_payload=True))
    key = jax.random.PRNGKey(3)
    cfg = MPPIConfig(**base)
    cost = costs.standing_cost(m, 0.115, home)
    built = []
    orig = cuda_step.build_cuda_substep
    monkeypatch.setattr(mppi, "build_cuda_substep",
                        lambda *a, **k: built.append(orig(*a, **k))
                        or built[-1])
    pergeom = mppi.make_solver(m, cost, cfg, device="cpu", terrain=t,
                               plane_mode="per_geom")
    loaded = mppi.make_solver(m, cost, cfg, device="cpu", terrain=t,
                              plane_mode="per_geom", with_payload=True)
    assert [s.name for s in built] == ["substep_pergeom",
                                       "substep_pergeom_payload"]
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    normals = torch.from_numpy(_solve_normals(key, 8, 4, m.nu))
    out = {}
    for kg in (0.0, 2.0):
        jctrl, _, jstats = jsolve(jax_make_state(jm, "home"),
                                  jax_mppi.init_state(jm, jcfg), key,
                                  jnp.float32(kg))
        ctrl, _, stats = loaded(st, ms, None, normals, kg)
        np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(stats["best_cost"]),
                                   float(jstats["best_cost"]), rtol=5e-5)
        out[kg] = (ctrl, stats)
    c_pg, _, _ = pergeom(st, ms, None, normals)
    np.testing.assert_allclose(out[0.0][0].numpy(), c_pg.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.isfinite(out[2.0][0]).all()
    assert abs(float(out[2.0][1]["best_cost"])
               - float(out[0.0][1]["best_cost"])) > 1e-3
