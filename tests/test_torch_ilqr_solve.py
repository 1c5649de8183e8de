"""One whole ``make_ilqr`` solve of the port against the JAX package's,
OpenDOG flat, 6 stages of 2 x 5 ms substeps, 2 iterations, sequential
Riccati pass (the associative one: test_torch_ilqr_solve_assoc.py).  The
JAX solve is jitted, as the JAX package's own tests run it.

Tolerances: U 1e-5 and X 1e-4 absolute; the costs 5e-5 relative (a sum
over the horizon of states that XLA's fused roundings move through the
stiff contact: 1.6e-5 read); the final gains relative to their largest
entry, k_ff 1e-4 and K_fb 2e-4 (the gains of a stiff contact model are
ill-conditioned: 4.8e-5 read).
The step size picked at each iteration must be the JAX solve's: JAX keeps
its candidates' costs inside the solve, so its pick is the port candidate
whose cost its cost trace reads, unambiguously.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers.ilqr import ILQRConfig as JaxILQRConfig
from opendog_tpu.solvers.ilqr import make_ilqr as jax_make_ilqr
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State, dynamics, make_state
from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr

torch.set_num_threads(1)

CFG = dict(horizon=6, n_substeps=2, rollout_dt=0.005, iterations=2)
TOL = dict(U=1e-5, X=1e-4, cost=5e-5, k_ff=1e-4, K_fb=2e-4)


def _close_rel_max(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def compare_solve(riccati):
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    # the start, settled for 200 substeps by the port (the same numpy
    # arrays go to both solves), then pushed forward at 0.2 m/s
    p, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                         n_substeps=200)
    qvel = p.qvel.clone()
    qvel[0] = 0.2
    s = JaxState(qpos=jnp.asarray(p.qpos.numpy()),
                 qvel=jnp.asarray(qvel.numpy()), time=jnp.asarray(0.3))
    rng = np.random.default_rng(1)
    cr = np.asarray(jm.actuator_ctrlrange)
    U0 = (np.asarray(jm.key_ctrl[0])[None]
          + rng.uniform(-0.05, 0.05, (CFG["horizon"], jm.nu)))
    U0 = np.clip(U0, cr[:, 0] + 0.02, cr[:, 1] - 0.02).astype(np.float32)

    jsolve = jax.jit(jax_make_ilqr(
        jm, jax_costs.standing_cost(jm, 0.0694, home),
        JaxILQRConfig(riccati=riccati, **CFG)))
    jU, jX, jst = jsolve(s, jnp.asarray(U0))

    solve = make_ilqr(m, costs.standing_cost(m, 0.0694, home),
                      ILQRConfig(riccati=riccati, **CFG), device="cpu")
    st = State(qpos=p.qpos, qvel=qvel, time=torch.tensor(0.3))
    U, X, stats = solve(st, torch.from_numpy(U0))

    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=0,
                               atol=TOL["U"])
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                               atol=TOL["X"])
    for k in ("cost", "initial_cost", "cost_trace"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jst[k]),
                                   rtol=TOL["cost"])
    for k in ("k_ff", "K_fb"):
        _close_rel_max(stats[k].numpy(), np.asarray(jst[k]), TOL[k], k)
    assert float(stats["cost"]) < float(stats["initial_cost"])

    # the step size of each iteration: the candidate whose cost JAX's trace
    # reads (-1: none improved on the cost before)
    tried = stats["line_search_costs"].numpy()
    before = np.concatenate([[float(jst["initial_cost"])],
                             np.asarray(jst["cost_trace"])[:-1]])
    jax_picks = []
    for i, c in enumerate(np.asarray(jst["cost_trace"])):
        if not c < before[i]:
            jax_picks.append(-1)
            continue
        gap = np.abs(tried[i] - c)
        order = np.argsort(gap)
        assert gap[order[0]] <= TOL["cost"] * abs(c) < gap[order[1]], (
            i, tried[i], c)
        jax_picks.append(int(order[0]))
    assert stats["pick_trace"].tolist() == jax_picks


def test_scan_solve_matches_jax():
    compare_solve("scan")
