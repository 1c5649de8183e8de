"""The port's jump and landing envs (Go1 on the ``jump`` / ``landing`` box
scenes, op-graph box contact) against the JAX package's, op by op, with
the harness and tolerances of tests/test_torch_envs.py: reset from the
JAX keys' draws, then a step of 2 substeps from the JAX states with
random actions.  The jump env's reset noise (0.1 on every qpos entry)
sinks most resets 5 cm into the ground, the contact's cap, where one
substep amplifies float32 rounding to 1.3e-3 qvel between the packages
(measured), and the landing env's ``descent`` keyframe (trunk at 0.6 m)
puts the feet 7 cm inside its platform (top at 0.4 m): 5.4e-3 qvel after
one substep (ROADMAP Queue 3, the ill-conditioned substep).  Before the
steps each trunk is moved to 2 mm into its support, as the step tests'
states are (``tests/test_torch_dynamics.py::_near_home``); the resets
themselves are compared as they come."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu_torch import assets, envs
from test_torch_dynamics import _lowest_sphere
from test_torch_envs import run_env

torch.set_num_threads(1)


@pytest.mark.parametrize("task", ["jump", "landing"])
def test_jump_envs_match_jax(task):
    jm, m = jax_assets.load_go1(task), assets.load_go1(task, device="cpu")
    cls, jcls = ((envs.JumpEnv, jax_envs.JumpEnv) if task == "jump" else
                 (envs.LandingEnv, jax_envs.LandingEnv))
    jenv, env = jcls(jm, frame_skip=2), cls(m, frame_skip=2)
    assert env.obs_size == jenv.obs_size
    info = (("x_position", "z_position", "landing_precision",
             "height_clearance") if task == "jump" else
            ("z_position", "reward_phase_sync", "reward_front_then_back",
             "reward_weight_distribution"))

    # the support under the trunk: the ground (jump: the box is ahead at
    # x in [0.6, 1.4]) or the landing platform's top at 0.4 m
    top = 0.0 if task == "jump" else float(
        np.asarray(jm.wbox_pos)[0, 2] + np.asarray(jm.wbox_size)[0, 2])

    def near_support(js):
        qpos = np.array(js.physics.qpos)
        for i in range(len(qpos)):
            qpos[i, 2] -= _lowest_sphere(jm, qpos[i]) - top + 0.002
        return js.replace(physics=js.physics.replace(
            qpos=jnp.asarray(qpos)))

    run_env(jenv, env, seed=11, n_steps=1, info_keys=info,
            prepare=near_support)
    np.testing.assert_array_equal(env._leg_mask.numpy(), np.isin(
        np.array(jm.geom_body_static), jenv.collision_bodies))
