"""The port's ``make_eval`` against the JAX package's, op by op: the same
network (carried flax parameters), the same reset draws, the policy mean
driving one env.  The walk episode runs its 2 steps upright; the landing
episode, from the ``descent`` keyframe with the feet inside its platform,
terminates, and every field after its end stays frozen in both packages.
Tolerances of tests/test_torch_envs.py: return and forward_x 1e-5
relative, episode length and termination equal, the recorded physics to
1e-4 qpos / 1e-3 qvel."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.rl import MLPActorCritic as JaxMLP
from opendog_tpu.rl.evaluate import make_eval as jax_make_eval
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.rl.evaluate import make_eval
from opendog_tpu_torch.rl.networks import MLPActorCritic, load_flax_params
from test_torch_envs import reset_draws

torch.set_num_threads(1)

STEPS = 2


@pytest.mark.parametrize("task", ["walk", "landing"])
def test_eval_matches_jax_and_freezes(task):
    if task == "walk":
        jm, m = jax_assets.load_opendog("flat"), assets.load_opendog(
            "flat", device="cpu")
        jenv, env = jax_envs.WalkEnv(jm, frame_skip=2), envs.WalkEnv(
            m, frame_skip=2)
    else:
        jm, m = jax_assets.load_go1("landing"), assets.load_go1(
            "landing", device="cpu")
        jenv, env = jax_envs.LandingEnv(jm, frame_skip=2), envs.LandingEnv(
            m, frame_skip=2)
    A = env.action_dim
    jnet = JaxMLP(action_dim=A, hidden=(16, 16), squash_mean=False)
    net = MLPActorCritic(env.obs_size, A, hidden=(16, 16), squash_mean=False)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, env.obs_size)))
    load_flax_params(net, jax.tree.map(np.asarray, jparams))
    key = jax.random.PRNGKey(4)
    with jax.disable_jit():
        jm_, jphys = jax_make_eval(jenv, jnet, STEPS)(jparams, key)
    metrics, phys = make_eval(env, net, STEPS, device="cpu")(
        None, reset_draws(jenv, env, key[None]))
    assert int(metrics["episode_len"]) == int(jm_["episode_len"])
    assert bool(metrics["terminated"]) == bool(jm_["terminated"])
    for k in ("episode_return", "forward_x"):
        np.testing.assert_allclose(float(metrics[k]), float(jm_[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, tol in (("qpos", 1e-4), ("qvel", 1e-3)):
        np.testing.assert_allclose(getattr(phys, k).numpy(),
                                   np.asarray(getattr(jphys, k)), rtol=0,
                                   atol=tol, err_msg=k)
    n = int(metrics["episode_len"])
    if task == "walk":
        assert n == STEPS and not bool(metrics["terminated"])
    else:
        assert n < STEPS and bool(metrics["terminated"])
        # frozen tail: every frame after the end equals the last one
        for k in ("qpos", "qvel", "time"):
            v = getattr(phys, k)
            assert torch.equal(v[n - 1:], v[n - 1].expand_as(v[n - 1:])), k
