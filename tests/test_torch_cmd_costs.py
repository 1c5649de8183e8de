"""The port's command-conditioned trot cost and gait reference against the
JAX package's (``costs.trot_cost_cmd``, ``trot_gait_ref_cmd``,
``_cmd_stride_scales``, ``ref_takes_cmd``), on Go1 and OpenDOG, at random
states and commands.  The JAX functions are vmapped per sample, the port's
run batch-first.  Tolerances: costs 1e-5 relative (float32 sums in another
order), stride scales and gait references 1e-6 absolute (elementwise, the
same operations)."""
import functools

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

B = 64
RTOL = 1e-5
ATOL = 1e-6

# the command gaits of the JAX package's distill_zoo.cmd_distill_setup
# (go1: the calibrated affine law; opendog: the measured knots), and the
# linear law of the defaults with steering
OPENDOG_KNOTS = ((0.0, 0.0), (0.0274, 0.18), (0.0509, 0.3), (0.0821, 0.45),
                 (0.1212, 0.6), (0.1371, 0.9), (0.2042, 1.05))
CASES = {
    "go1-affine": ("go1", dict(
        desired_vel_xy=(0.5, 0.0), target_height=0.265,
        lift_phase=float(np.pi / 2), thigh_amp=0.19, w_heading=15.0,
        amp_v0=0.16, turn_gain=1.2)),
    "opendog-knots": ("opendog", dict(
        desired_vel_xy=(0.28, 0.0), target_height=0.0703, thigh_amp=0.26,
        knee_lift=0.35, w_height=80.0, w_heading=22.0,
        lift_phase=float(-np.pi / 2), amp_knots=OPENDOG_KNOTS,
        turn_gain=1.2)),
    "go1-linear": ("go1", dict(desired_vel_xy=(0.5, 0.0), turn_gain=0.8)),
    "opendog-linear-straight": ("opendog", dict(desired_vel_xy=(0.28, 0.0))),
}


def _models(robot):
    if robot == "go1":
        return jax_assets.load_go1("flat"), assets.load_go1("flat",
                                                             device="cpu")
    return (jax_assets.load_opendog("flat"),
            assets.load_opendog("flat", device="cpu"))


def _inputs(m, seed):
    """Random states near home, times, controls and commands: speeds from
    a stand to past the last knot, one exact stand, yaw targets both
    ways."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.key_qpos[0]), (B, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.05, (B, 3))
    quat = qpos[:, 3:7] + rng.normal(0, 0.2, (B, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0, 0.2, (B, m.nq - 7))
    qvel = rng.normal(0, 0.5, (B, m.nv)).astype(np.float32)
    time = rng.uniform(0, 3, B).astype(np.float32)
    lo, hi = np.asarray(m.actuator_ctrlrange).T
    ctrl = rng.uniform(lo, hi, (B, m.nu)).astype(np.float32)
    prev = rng.uniform(lo, hi, (B, m.nu)).astype(np.float32)
    cmd = np.stack([rng.uniform(0, 0.7, B), rng.uniform(-0.1, 0.1, B),
                    rng.uniform(-0.8, 0.8, B)], axis=1).astype(np.float32)
    cmd[0] = 0.0
    cmd[1] = (0.1, 0.0, 0.0)
    cmd[2] = (0.0274, 0.0, -0.5)   # on a knot
    return (qpos.astype(np.float32), qvel, time, ctrl, prev, cmd)


def _home(m):
    return np.asarray(m.key_qpos[0])[7:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_trot_cost_cmd_matches_jax(case):
    robot, kw = CASES[case]
    jm, m = _models(robot)
    qpos, qvel, time, ctrl, prev, cmd = _inputs(jm, 1)
    jcost = jax_costs.trot_cost_cmd(jm, jax_costs.TrotCostParams(**kw),
                                    _home(jm), legs=robot)
    want = np.asarray(jax.vmap(jcost)(
        JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                 time=jnp.asarray(time)),
        jnp.asarray(ctrl), jnp.asarray(prev), jnp.asarray(cmd)))
    cost = costs.trot_cost_cmd(m, costs.TrotCostParams(**kw), _home(jm),
                               legs=robot)
    t = torch.from_numpy
    got = cost(State(qpos=t(qpos), qvel=t(qvel), time=t(time)), t(ctrl),
               t(prev), t(cmd))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    one = cost(State(qpos=t(qpos[5]), qvel=t(qvel[5]),
                     time=torch.tensor(time[5])), t(ctrl[5]), t(prev[5]),
               t(cmd[5]))
    assert one.shape == ()
    np.testing.assert_allclose(float(one), want[5], rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trot_gait_ref_cmd_matches_jax(case):
    robot, kw = CASES[case]
    jm, m = _models(robot)
    _, _, time, _, _, cmd = _inputs(jm, 2)
    ju = jax_costs.trot_gait_ref_cmd(jm, jax_costs.TrotCostParams(**kw),
                                     _home(jm), legs=robot)
    want = np.asarray(jax.vmap(ju)(jnp.asarray(time), jnp.asarray(cmd)))
    u = costs.trot_gait_ref_cmd(m, costs.TrotCostParams(**kw), _home(jm),
                                legs=robot)
    got = u(torch.from_numpy(time), torch.from_numpy(cmd))
    assert got.shape == (B, m.nu)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # a (S, H) grid of times against (S, H, 3) commands, as the anchored
    # solver asks for it
    grid = u(torch.from_numpy(time[:8]).reshape(2, 4),
             torch.from_numpy(cmd[:8]).reshape(2, 4, 3))
    np.testing.assert_allclose(grid.reshape(8, m.nu).numpy(), want[:8],
                               rtol=0, atol=ATOL)
    # a stand command gives the home stand at every phase
    stand = u(torch.from_numpy(time), torch.zeros(B, 3))
    home = np.asarray(jm.key_qpos[0])[7:][np.asarray(jm.actuator_qposadr) - 7]
    np.testing.assert_allclose(stand.numpy(), np.tile(home, (B, 1)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["go1-affine", "opendog-knots",
                                  "go1-linear"])
@pytest.mark.parametrize("closed_loop", [False, True])
def test_cmd_stride_scales_match_jax(case, closed_loop):
    """Both laws of the forward part (affine, knots; and the linear one),
    with the steering open loop (yaw=None) and closed on a yaw."""
    robot, kw = CASES[case]
    jm, m = _models(robot)
    _, _, time, _, _, cmd = _inputs(jm, 3)
    yaw = np.random.default_rng(4).uniform(-3, 3, B).astype(np.float32)
    jp = jax_costs.TrotCostParams(**kw)
    v_nom = max(1e-6, float(np.hypot(*jp.desired_vel_xy)))
    jside = jax_costs._side_signs(robot)
    want = np.asarray(jax.vmap(
        lambda c, y: jax_costs._cmd_stride_scales(
            jp, v_nom, jside, c, y if closed_loop else None))(
        jnp.asarray(cmd), jnp.asarray(yaw)))
    p = costs.TrotCostParams(**kw)
    _, v, side, knots = costs._cmd_gait(m, p, robot)
    got = costs._cmd_stride_scales(
        p, v, side, torch.from_numpy(cmd),
        torch.from_numpy(yaw) if closed_loop else None, knots)
    assert got.shape == (B, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_ref_takes_cmd_arity():
    """The arity convention on the port's closures, a lambda and
    functools.partial, against the JAX function's verdicts."""
    jm, m = _models("go1")
    p = costs.TrotCostParams()
    by_time = costs.trot_gait_ref(m, p, _home(jm))
    by_cmd = costs.trot_gait_ref_cmd(m, p, _home(jm))
    scaled = lambda t, cmd, k=2.0: k * by_cmd(t, cmd)  # noqa: E731
    bound = functools.partial(scaled, k=1.0)
    first_bound = functools.partial(lambda c, t: by_time(t), None)
    cases = [(by_time, False), (by_cmd, True), (scaled, True),
             (bound, True), (first_bound, False)]
    for fn, want in cases:
        assert costs.ref_takes_cmd(fn) is want
        assert jax_costs.ref_takes_cmd(fn) is want
