"""The port's walk / turn envs and their reward primitives against the JAX
package's, and the shared helpers of the env tests
(``test_torch_envs_jump.py``, ``test_torch_envs_sim2real.py``).

Each JAX env runs vmapped over a batch of envs op by op
(``jax.disable_jit()``; jitted, XLA fuses products and sums into one
rounding, ROADMAP Queue 3), on the reset draws its own keys give (the
port's ``*ResetDraws`` hold the same unit draws), and then steps from the
same states (the JAX reset's, copied into the port's state) with the same
actions (numpy seeds).  Tolerances: the physics state to the op-graph
step's own (1e-4 qpos, 1e-3 qvel, ``tests/test_torch_dynamics_step.py``;
measured on these states: 7.5e-9 qpos, 2.9e-6 qvel); observations and rewards to 1e-5
relative (1e-6 absolute at 0); discrete outputs equal -- the feet in
contact, the gait machine's index and count, ``terminated``,
``truncated``.  The states are near home: the resets' and the steps
after them, chosen so that no contact sits within rounding of its
threshold -- the feet in contact, the gait machine and the flags come out
equal in both packages on every state compared (a state with a contact
at its threshold would show as an unequal flag here, not be averaged
away).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.rewards import common as jax_common
from opendog_tpu_torch import assets
from opendog_tpu_torch import envs
from opendog_tpu_torch.envs.base import tree_copy_, vector_env
from opendog_tpu_torch.envs.walk import WalkResetDraws
from opendog_tpu_torch.rewards import common

torch.set_num_threads(1)

B = 4
PHYS_TOL = {"qpos": 1e-4, "qvel": 1e-3}
RTOL, ATOL = 1e-5, 1e-6


def t_(a):
    return torch.from_numpy(np.array(a))


def jax_to_dict(tree):
    """A JAX env state (flax dataclasses of arrays) as nested dicts of
    tensors, the form ``tree_copy_`` takes."""
    if dataclasses.is_dataclass(tree):
        return {f.name: jax_to_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return None if tree is None else t_(tree)


def reset_draws(jenv, env, keys):
    """The port's reset draws equal to what ``jenv.reset`` draws from each
    of ``keys`` (the splits of walk.py:150-151, jump.py:96,
    terrain.py:58-77; the symmetric walk draws nothing)."""
    if isinstance(jenv, jax_envs.TerrainWalkEnv):
        from test_torch_terrain import jax_draws
        per = [jax_draws(k, jenv.model) for k in keys]
        return type(per[0])(*(torch.stack(f) for f in zip(*per)))
    if isinstance(jenv, jax_envs.SymWalkEnv):
        return env.draw_reset(None, len(keys))
    nq = jenv.model.nq
    split = 2 if isinstance(jenv, jax_envs.JumpEnv) else 3
    qpos_u, vel_u = [], []
    for k in keys:
        ks = jax.random.split(k, split)
        qpos_u.append(np.asarray(jax.random.uniform(ks[0], (nq,))))
        vel_u.append(np.asarray(jax.random.uniform(ks[1], (3,))))
    return WalkResetDraws(qpos_u=t_(np.stack(qpos_u)),
                          vel_u=t_(np.stack(vel_u)))


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def compare_state(jstate, state, path="state"):
    """Every field of a port env state against the JAX one: physics to
    PHYS_TOL, integer and bool fields equal, other floats to RTOL."""
    if dataclasses.is_dataclass(jstate):
        for f in dataclasses.fields(jstate):
            compare_state(getattr(jstate, f.name), getattr(state, f.name),
                          f"{path}.{f.name}")
        return
    if jstate is None:
        assert state is None, path
        return
    want, got = np.asarray(jstate), state.numpy()
    assert got.shape == want.shape, (path, got.shape, want.shape)
    name = path.rsplit(".", 1)[-1]
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif ".physics." in path + "." and name in PHYS_TOL:
        close(got, want, path, rtol=0, atol=PHYS_TOL[name])
    else:
        close(got, want, path)


def compare_transition(jtrans, trans, keys=()):
    close(trans.obs, jtrans.obs, "obs")
    close(trans.reward, jtrans.reward, "reward")
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(trans, k).numpy(),
                                      np.asarray(getattr(jtrans, k)), k)
    for k in keys:
        want = np.asarray(jtrans.info[k])
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(trans.info[k].numpy(), want, k)
        else:
            close(trans.info[k], want, k, atol=1e-5)


def run_env(jenv, env, seed, n_steps=2, info_keys=(), prepare=None):
    """Reset both from the same keys, compare; then ``n_steps`` steps,
    each from the JAX state copied into the port's, with the same random
    actions, comparing states and transitions.  ``prepare(jax_state)``
    may move the reset states before the steps.  Returns the last (JAX
    state, port state)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    with jax.disable_jit():
        jstate, jobs = jax.vmap(jenv.reset)(keys)
    with torch.no_grad():
        state, obs = env.reset(reset_draws(jenv, env, keys))
    compare_state(jstate, state)
    close(obs, jobs, "reset obs")
    if prepare is not None:
        jstate = prepare(jstate)
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        action = rng.uniform(-1, 1, (B, env.action_dim)).astype(np.float32)
        tree_copy_(state, jax_to_dict(jstate))
        with jax.disable_jit():
            jstate, jtrans = jax.vmap(jenv.step)(jstate, jnp.asarray(action))
        with torch.no_grad():
            state, trans = env.step(state, t_(action))
        compare_state(jstate, state)
        compare_transition(jtrans, trans, info_keys)
    return jstate, state


WALK_VARIANTS = ("v0", "gpu", "turn")


@pytest.mark.parametrize("variant", WALK_VARIANTS)
def test_walk_env_reset_and_step_match_jax(variant):
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    if variant == "turn":
        jenv, env = jax_envs.TurnEnv(jm, frame_skip=2), \
            envs.TurnEnv(m, frame_skip=2)
    else:
        jenv = jax_envs.WalkEnv(jm, variant=variant, frame_skip=2)
        env = envs.WalkEnv(m, variant=variant, frame_skip=2)
    assert env.obs_size == jenv.obs_size
    run_env(jenv, env, seed=WALK_VARIANTS.index(variant), n_steps=1,
            info_keys=("x_position", "patterns_matches", "reward_ctrl",
                       "paw_contact_forces", "feet_in_contact"))


def test_vector_env_autoreset_matches_jax():
    """``vector_env``'s step: envs that are done come back as the fresh
    episode of that step's reset draws (state and obs), the others
    continue; the reward and flags are the finished step's.  A truncation
    limit of 2 steps on half the batch makes both kinds."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    jenv = jax_envs.WalkEnv(jm, frame_skip=2, max_episode_time=0.008)
    env = envs.WalkEnv(m, frame_skip=2, max_episode_time=0.008)
    assert env.max_steps == jenv.max_steps == 2
    jreset, jstep = jax_envs.vector_env(jenv)
    reset, step = vector_env(env)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    with jax.disable_jit():
        jstate, _ = jreset(keys)
    state, _ = reset(reset_draws(jenv, env, keys))
    # half the envs one step from truncation
    jstate = jstate.replace(step_count=jnp.asarray([1, 0, 1, 0], jnp.int32))
    state.step_count = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    tree_copy_(state, jax_to_dict(jstate))
    rng = np.random.default_rng(5)
    action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    rkeys = jax.random.split(jax.random.PRNGKey(6), B)
    with jax.disable_jit():
        jnext, jtrans = jstep(jstate, jnp.asarray(action), rkeys)
    with torch.no_grad():
        nxt, trans = step(state, t_(action), reset_draws(jenv, env, rkeys))
    np.testing.assert_array_equal(trans.truncated.numpy(),
                                  [True, False, True, False])
    compare_state(jnext, nxt)
    compare_transition(jtrans, trans)
    # the done rows are fresh episodes: step count 0, zero velocity
    np.testing.assert_array_equal(nxt.step_count.numpy(), [0, 1, 0, 1])
    assert torch.all(nxt.physics.qvel[[0, 2]] == 0)


def test_gait_rewards_match_jax():
    """The stateful gait rewards over random contacts, velocities and
    machine states, per env against the JAX functions vmapped: rewards to
    RTOL, the machine's integer state and last contacts equal."""
    from opendog_tpu.envs.walk import WALK_PATTERNS

    rng = np.random.default_rng(0)
    n = 64
    gait = common.GaitState(
        pattern_index=t_(rng.integers(0, 8, n).astype(np.int32)),
        consecutive_matches=t_(rng.integers(0, 40, n).astype(np.int32)),
        feet_air_time=t_(rng.uniform(0, 1.5, (n, 4)).astype(np.float32)
                         * (rng.uniform(size=(n, 4)) < 0.6)),
        last_contacts=t_(rng.uniform(size=(n, 4)) < 0.5))
    jgait = jax_common.GaitState(
        **{f.name: jnp.asarray(getattr(gait, f.name).numpy())
           for f in dataclasses.fields(gait)})
    contact = rng.uniform(size=(n, 4)) < 0.6
    contact[: n // 2] = WALK_PATTERNS[gait.pattern_index.numpy()[: n // 2]]
    vel = rng.uniform(0.0, 1.0, n).astype(np.float32)
    force = rng.uniform(0, 3.0, (n, 4)).astype(np.float32)
    desired = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    r1, g1 = common.diagonal_gait_reward(
        gait, t_(contact), t_(vel), t_(WALK_PATTERNS))
    jr1, jg1 = jax.vmap(lambda g, c, v: jax_common.diagonal_gait_reward(
        g, c, v, WALK_PATTERNS))(jgait, jnp.asarray(contact),
                                 jnp.asarray(vel))
    close(r1, jr1, "gait reward")
    assert np.asarray(jr1).max() > 0  # some envs matched their pattern
    r2, g2 = common.feet_air_time_reward(g1, t_(force), 0.02, t_(desired))
    jr2, jg2 = jax.vmap(lambda g, f, d: jax_common.feet_air_time_reward(
        g, f, 0.02, d))(jg1, jnp.asarray(force), jnp.asarray(desired))
    close(r2, jr2, "air time reward")
    compare_state(jg2, g2, "gait")


def test_stateless_rewards_match_jax():
    """Orientation, tracking, health, projected gravity and the cost terms
    on random near-upright quaternions and velocities."""
    rng = np.random.default_rng(1)
    n = 64
    quat = rng.normal(0, 1, (n, 4)).astype(np.float32) * 0.15
    quat[:, 0] = 1.0
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    sv = rng.normal(0, 1, (n, 29)).astype(np.float32)
    sv[3, 5] = np.nan
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    des = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x = rng.normal(0, 0.2, n).astype(np.float32)
    q = jnp.asarray(quat)
    v = jax.vmap
    for what, got, want in (
        ("safe_range", common.safe_range_reward(t_(quat)),
         v(jax_common.safe_range_reward)(q)),
        ("projected_gravity", common.projected_gravity(t_(quat)),
         v(jax_common.projected_gravity)(q)),
        ("lin_tracking", common.linear_velocity_tracking(
            t_(des[:, :2]), t_(vel[:, :2]), t_(x)),
         v(jax_common.linear_velocity_tracking)(
             jnp.asarray(des[:, :2]), jnp.asarray(vel[:, :2]),
             jnp.asarray(x))),
        ("ang_tracking", common.angular_velocity_tracking(
            t_(des[:, 2]), t_(vel[:, 2])),
         v(jax_common.angular_velocity_tracking)(jnp.asarray(des[:, 2]),
                                                 jnp.asarray(vel[:, 2]))),
        ("default_pos", common.default_joint_position_cost(
            t_(sv[:, :8]), t_(sv[0, 8:16])),
         v(lambda a: jax_common.default_joint_position_cost(
             a, jnp.asarray(sv[0, 8:16])))(jnp.asarray(sv[:, :8]))),
        ("torque", common.torque_cost(t_(sv[:, :12])),
         v(jax_common.torque_cost)(jnp.asarray(sv[:, :12]))),
    ):
        close(got, want, what)
    np.testing.assert_array_equal(
        common.is_healthy(t_(quat), t_(sv)).numpy(),
        np.asarray(v(jax_common.is_healthy)(q, jnp.asarray(sv))))
    cr = np.stack([-np.ones(8), np.ones(8)], 1)
    soft = common.soft_joint_range(cr)
    np.testing.assert_array_equal(soft, jax_common.soft_joint_range(cr))
    close(common.joint_limit_cost(t_(sv[:, :8] * 2), t_(soft)),
          v(lambda a: jax_common.joint_limit_cost(a, soft))(
              jnp.asarray(sv[:, :8] * 2)), "joint_limit")
    # desired velocities: JAX's draw from a key equals the map of its unit
    # draw, bit for bit
    key = jax.random.PRNGKey(3)
    lo = np.array([0.5, 0.0, -0.2], np.float32)
    hi = np.array([1.0, 0.0, 0.3], np.float32)
    want = jax_common.sample_desired_vel(key, lo, hi)
    got = common.sample_desired_vel(t_(jax.random.uniform(key, (3,))),
                                    t_(lo), t_(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
