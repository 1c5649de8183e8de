"""The walk env at its own 10 substeps per step (50 Hz) against the JAX
env, op by op, for one step from the reset; the harness and tolerances
of tests/test_torch_envs.py."""
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu_torch import assets, envs
from test_torch_envs import run_env

torch.set_num_threads(1)


def test_walk_env_full_frame_skip_matches_jax():
    jenv = jax_envs.WalkEnv(jax_assets.load_opendog("flat"))
    env = envs.WalkEnv(assets.load_opendog("flat", device="cpu"))
    assert env.frame_skip == 10 and env.max_steps == jenv.max_steps == 750
    run_env(jenv, env, seed=7, n_steps=1,
            info_keys=("feet_in_contact", "paw_contact_forces"))
