"""The port's ``TerrainWalkEnv`` (one procedural terrain per env, made
from each env's own draws, the spawn above the grid's center, the settle
on it, the step on each env's own terrain) against the JAX package's, op
by op, with the harness and tolerances of tests/test_torch_envs.py, at
the cut substep counts of tests/test_torch_envs_sim2real.py."""
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu_torch import assets, envs
from test_torch_envs import B, run_env
from test_torch_envs_sim2real import _cut

torch.set_num_threads(1)


def test_terrain_walk_env_matches_jax():
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jenv, env = _cut(jax_envs.TerrainWalkEnv(jm), envs.TerrainWalkEnv(m))
    assert env.obs_size == jenv.obs_size == 12
    jstate, state = run_env(jenv, env, seed=4, n_steps=1,
                            info_keys=("sim_target_rad", "x_position"))
    assert state.terrain.height.shape == (B, jm.hfield_nrow, jm.hfield_ncol)
    # the seeds give distinct terrains (flat and rough ones)
    h = state.terrain.height.numpy()
    assert len({float(x.std()) for x in h}) > 1
