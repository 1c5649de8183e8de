"""The port's sim2real envs (``SymWalkEnv`` on flat ground here,
``TerrainWalkEnv`` with one procedural terrain per env in
tests/test_torch_envs_terrain.py) against the JAX package's, op by op,
with the harness and tolerances of tests/test_torch_envs.py.

The env logic (action expansion by phase, observations, the shaped
rewards, the real-degree leg penalty, the backward and orientation
terminations, the per-env terrain, its spawn height) is held at cut
substep counts, set on both envs alike: 2 substeps per policy step (the
envs' own: 50 and 40) and a 4-substep settle (their own: 100), because
JAX op by op takes ~1.5 s per vmapped substep on a CPU; the physics of long substep
runs is the op-graph step's, held by tests/test_torch_dynamics_step.py.
The symmetric walk's settled state (computed once on one env and reused)
is held at its full 100 substeps against the JAX reset jitted, to the
10-substep step tolerance of that file (1e-4 qpos, 1e-3 qvel).
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu_torch import assets, envs
from test_torch_envs import B, run_env

torch.set_num_threads(1)


def _cut(*pair):
    for e in pair:
        e.n_substeps, e.settle_steps = 2, 4
    return pair


def test_sym_walk_env_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    jenv, env = _cut(jax_envs.SymWalkEnv(jm), envs.SymWalkEnv(m))
    assert env.obs_size == jenv.obs_size == 22
    # both phases of the gait: half the envs one step into the episode
    def both_phases(js):
        return js.replace(step_count=jnp.asarray([0, 1] * (B // 2),
                                                 jnp.int32))

    run_env(jenv, env, seed=3, n_steps=1, prepare=both_phases,
            info_keys=("sim_target_rad", "x_position", "phase",
                       "real_target_deg"))


def test_sym_walk_settled_reset_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    jenv, env = jax_envs.SymWalkEnv(jm), envs.SymWalkEnv(m)
    assert env.settle_steps == 100 and env.n_substeps == 50
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    state, obs = env.reset(env.draw_reset(None, 2))
    for k, tol in (("qpos", 1e-4), ("qvel", 1e-3)):
        np.testing.assert_allclose(getattr(state.physics, k).numpy(),
                                   np.asarray(getattr(jstate.physics, k)),
                                   rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0,
                               atol=1e-3)
    # the trunk came down onto its feet
    assert 0.03 < float(state.settled_z[0]) < 0.2
