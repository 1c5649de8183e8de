"""The port's MPC costs against the JAX package's, over random batches:
the JAX cost is vmapped per sample, the port's runs batch-first.  Relative
tolerance 1e-5 (float32 sums in another order)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State
from opendog_tpu_torch.solvers import costs

torch.set_num_threads(1)

K = 64
RTOL = 1e-5


def _batch(m, seed):
    """Random states near the home keyframe with random times and controls."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.key_qpos[0]), (K, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    quat = qpos[:, 3:7] + rng.normal(0, 0.2, (K, 4)).astype(np.float32)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0, 0.2, (K, m.nq - 7)).astype(np.float32)
    qvel = rng.normal(0, 0.5, (K, m.nv)).astype(np.float32)
    time = rng.uniform(0, 3, K).astype(np.float32)
    lo, hi = np.asarray(m.actuator_ctrlrange).T
    ctrl = rng.uniform(lo, hi, (K, m.nu)).astype(np.float32)
    prev = rng.uniform(lo, hi, (K, m.nu)).astype(np.float32)
    return qpos, qvel, time, ctrl, prev


def _compare(jax_cost, port_cost, arrays):
    qpos, qvel, time, ctrl, prev = arrays
    st = JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                  time=jnp.asarray(time))
    want = np.asarray(jax.vmap(jax_cost)(st, jnp.asarray(ctrl),
                                         jnp.asarray(prev)))
    t = torch.from_numpy
    got = port_cost(State(qpos=t(qpos), qvel=t(qvel), time=t(time)),
                    t(ctrl), t(prev))
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    # one unbatched sample gives the same scalar
    one = port_cost(State(qpos=t(qpos[3]), qvel=t(qvel[3]),
                          time=torch.tensor(time[3])), t(ctrl[3]), t(prev[3]))
    assert one.shape == ()
    np.testing.assert_allclose(float(one), want[3], rtol=RTOL)


@pytest.mark.parametrize("params", [
    dict(desired_vel_xy=(0.5, 0.0), target_height=0.265),  # bench.py
    dict(desired_vel_xy=(0.3, 0.1), lift_phase=np.pi / 2, desired_yaw=0.4),
])
def test_trot_cost_go1_matches_jax(params):
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    _compare(jax_costs.trot_cost(jm, jax_costs.TrotCostParams(**params),
                                 home, legs="go1"),
             costs.trot_cost(m, costs.TrotCostParams(**params), home,
                             legs="go1"),
             _batch(jm, 0))


def test_trot_cost_opendog_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    p = dict(desired_vel_xy=(0.3, 0.0), target_height=0.069)
    _compare(jax_costs.trot_cost(jm, jax_costs.TrotCostParams(**p), home,
                                 legs="opendog"),
             costs.trot_cost(m, costs.TrotCostParams(**p), home,
                             legs="opendog"),
             _batch(jm, 1))


def test_tracking_cost_matches_jax():
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    p = dict(desired_vel_xy=(0.4, -0.1), desired_yaw_rate=0.2)
    _compare(jax_costs.tracking_cost(jm, jax_costs.TrackingCostParams(**p),
                                     home),
             costs.tracking_cost(m, costs.TrackingCostParams(**p), home),
             _batch(jm, 2))


def test_standing_cost_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    _compare(jax_costs.standing_cost(jm, 0.0694, home),
             costs.standing_cost(m, 0.0694, torch.from_numpy(home)),
             _batch(jm, 3))


def test_unknown_leg_layout_raises():
    m = assets.load_go1("flat", device="cpu")
    with pytest.raises(ValueError, match="leg layout"):
        costs.trot_cost(m, costs.TrotCostParams(), np.zeros(12), legs="hexapod")
