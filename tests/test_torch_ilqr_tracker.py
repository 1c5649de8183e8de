"""The port's replan + track cycle (``mpc.make_ilqr_tracker``) against the
JAX package's, on the miniature cycle of tests/test_ilqr_tracker.py:
OpenDOG flat standing, 8 stages of 2 x 5 ms substeps, 3 iterations, 6
tracked ticks of 5 plant substeps, from the settled stance pushed forward
at 0.2 m/s.  The JAX cycle is jitted, as its own test runs it.

Tolerances: tracked qpos and the next plant state 1e-4 absolute (states
through a stiff contact after 6 ticks), controls and the next plan 1e-4
absolute, the solve's cost 5e-5 relative (see test_torch_ilqr_solve.py).
The ``u_ref_fn`` warm start leaves the solve and the ticks as they were
(bit for bit) and gives the gait reference at the next cycle's stage times,
clipped, as the JAX package computes it (1e-6 absolute).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers.ilqr import ILQRConfig as JaxILQRConfig
from opendog_tpu.solvers.mpc import make_ilqr_tracker as jax_make_tracker
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State, dynamics, make_state
from opendog_tpu_torch.solvers import (ILQRConfig, costs,
                                       make_ilqr_tracker)

torch.set_num_threads(1)

CFG = dict(horizon=8, n_substeps=2, rollout_dt=0.005, iterations=3)
TRACK = dict(track_ticks=6, plant_substeps=5)
ATOL = 1e-4
COST_RTOL = 5e-5
REF_ATOL = 1e-6


def test_cycle_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    p, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                         n_substeps=200)
    qvel = p.qvel.clone()
    qvel[0] = 0.2
    U0 = np.tile(np.asarray(jm.key_ctrl[0])[None], (CFG["horizon"], 1))

    jcycle = jax.jit(jax_make_tracker(
        jm, jax_costs.standing_cost(jm, 0.0694, home), JaxILQRConfig(**CFG),
        **TRACK))
    js = JaxState(qpos=jnp.asarray(p.qpos.numpy()),
                  qvel=jnp.asarray(qvel.numpy()), time=jnp.asarray(0.0))
    jplant, jU, jtraj = jcycle(js, jnp.asarray(U0))

    st = State(qpos=p.qpos, qvel=qvel, time=torch.tensor(0.0))
    cost = costs.standing_cost(m, 0.0694, home)
    cycle = make_ilqr_tracker(m, cost, ILQRConfig(**CFG), device="cpu",
                              **TRACK)
    plant, U, traj = cycle(st, torch.from_numpy(U0))
    assert sorted(traj) == sorted(jtraj)
    for got, want in ((traj["qpos"], jtraj["qpos"]),
                      (traj["ctrl"], jtraj["ctrl"]), (U, jU),
                      (plant.qpos, jplant.qpos), (plant.qvel, jplant.qvel)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(float(traj["cost"]), float(jtraj["cost"]),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(float(plant.time), float(jplant.time),
                               rtol=1e-6)
    # the JAX test's health band and ctrlrange
    z = traj["qpos"][:, 2].numpy()
    assert z.min() > 0.04 and z.max() < 0.12
    cr = m.actuator_ctrlrange.numpy()
    c = traj["ctrl"].numpy()
    assert np.all(c >= cr[:, 0] - 1e-5) and np.all(c <= cr[:, 1] + 1e-5)
    # from the clipped home control no step size improves here, in either
    # package (the costs above agree): the plan is kept, never worsened
    assert float(cycle.stats["cost"]) <= float(cycle.stats["initial_cost"])

    # the gait-reference warm start
    pc = costs.TrotCostParams(target_height=0.07)
    jref = jax_costs.trot_gait_ref(jm, jax_costs.TrotCostParams(
        target_height=0.07), home, legs="opendog")
    ref = costs.trot_gait_ref(m, pc, home, legs="opendog")
    rcycle = make_ilqr_tracker(m, cost, ILQRConfig(**CFG), u_ref_fn=ref,
                               device="cpu", **TRACK)
    rplant, rU, rtraj = rcycle(st, torch.from_numpy(U0))
    for k in traj:
        assert torch.equal(rtraj[k], traj[k]), k
    assert torch.equal(rplant.qpos, plant.qpos)
    stage_dt = CFG["n_substeps"] * CFG["rollout_dt"]
    ts = jplant.time + stage_dt * jnp.arange(CFG["horizon"])
    want = jnp.clip(jax.vmap(jref)(ts), jm.actuator_ctrlrange[:, 0],
                    jm.actuator_ctrlrange[:, 1])
    np.testing.assert_allclose(rU.numpy(), np.asarray(want), rtol=0,
                               atol=REF_ATOL)


def test_horizon_must_cover_the_tracked_ticks():
    m = assets.load_opendog("flat", device="cpu")
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    with pytest.raises(ValueError, match="must cover the tracked ticks"):
        make_ilqr_tracker(m, cost, ILQRConfig(**CFG), track_ticks=9,
                          device="cpu")
    jm = jax_assets.load_opendog("flat")
    with pytest.raises(AssertionError):
        jax_make_tracker(jm, jax_costs.standing_cost(
            jm, 0.0694, np.asarray(jm.key_qpos[0])[7:]),
            JaxILQRConfig(**CFG), track_ticks=9)
