"""One data-parallel PPO chunk of the port (``make_sharded_ppo``) at 2 and
4 gloo ranks against the JAX package's ``make_sharded_ppo`` on 8 virtual
devices, on the same draws, and against the port's one-process chunk.

The setup of tests/test_parallel.py:34-71 (OpenDOG walk, frame_skip 2, a
16-16 network, 16 envs x 4 steps, 2 epochs of one minibatch of all 64
samples).  The JAX learner trains a first chunk alone (so that Adam's
moments are not zero); its state is carried into the port's (rank r
keeps its block of envs) and both train a second chunk on the JAX chunk's
own draws (``test_torch_ppo.chunk_draws``).  Each rank permutes its own
samples with a permutation of its own size: one minibatch holds all of
them either way, so only the order of the gradient sums differs.

Tolerances: against JAX, those of ``test_torch_ppo.check_chunk`` (env
states to the env tolerances, the metrics 1e-4 relative, the trained
networks as functions on the chunk's observations 1e-5); against the
one-process chunk, tests/test_parallel.py's (parameters 2e-5, metrics
1e-4, env states 1e-5).  Every rank's parameters and metrics are the same
bits.  A file of its own: the jitted JAX chunk's compile.
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.parallel import env_mesh as jax_env_mesh
from opendog_tpu.parallel import make_sharded_ppo as jax_make_sharded_ppo
from opendog_tpu.rl import Hyper as JaxHyper
from opendog_tpu.rl import MLPActorCritic as JaxMLP
from opendog_tpu.rl import PPOConfig as JaxPPOConfig
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.envs.base import tree_map
from opendog_tpu_torch.rl.networks import MLPActorCritic
from opendog_tpu_torch.rl.ppo import ChunkDraws, Hyper, PPOConfig, make_ppo
from test_torch_envs import compare_state
from test_torch_parallel_mesh import run_ranks, same_on_every_rank
from test_torch_ppo import carry_state, chunk_draws, outputs

torch.set_num_threads(1)

CFG = dict(num_envs=16, n_steps=4, num_epochs=2, minibatch_size=64)
LR, ENT = 3e-4, 0.005

RANK_BODY = """
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.parallel import env_mesh, make_sharded_ppo, shard_batch
from opendog_tpu_torch.rl.networks import MLPActorCritic
from opendog_tpu_torch.rl.ppo import Hyper, PPOConfig
inp = load_inputs()
mesh = env_mesh(device="cpu")
env = envs.WalkEnv(assets.load_opendog("flat", device="cpu"), frame_skip=2)
net = MLPActorCritic(env.obs_size, 8, hidden=(16, 16))
init, chunk = make_sharded_ppo(env, net, PPOConfig(**inp["cfg"]), mesh)
saved = dict(inp["state"])
saved["env_states"] = shard_batch(mesh, saved["env_states"])
saved["last_obs"] = shard_batch(mesh, saved["last_obs"])
state = init(None).load_state_dict(saved)
state, metrics = chunk(state, Hyper(lr=inp["lr"], ent_coef=inp["ent"]),
                       inp["draws"])
save(dict(params={k: v.detach() for k, v in state.params.items()},
          metrics=metrics, env_states=state.env_states,
          last_obs=state.last_obs, obs=chunk.rollout.traj["obs"]))
"""


@pytest.fixture(scope="module")
def refs(devices8):
    """The JAX 8-device second chunk, the carried state and draws, and
    the port's one-process second chunk."""
    jenv = jax_envs.WalkEnv(jax_assets.load_opendog("flat"), frame_skip=2)
    env = envs.WalkEnv(assets.load_opendog("flat", device="cpu"),
                       frame_skip=2)
    jnet = JaxMLP(action_dim=8, hidden=(16, 16))
    net = MLPActorCritic(env.obs_size, 8, hidden=(16, 16))
    jinit, jchunk = jax_make_sharded_ppo(jenv, jnet, JaxPPOConfig(**CFG),
                                         jax_env_mesh(8))
    jhyper = JaxHyper(lr=jnp.float32(LR), ent_coef=jnp.float32(ENT))
    jstate, _ = jchunk(jinit(jax.random.PRNGKey(0)), jhyper)
    cfg = PPOConfig(**CFG)
    init, chunk = make_ppo(env, net, cfg, device="cpu")
    state = carry_state(init(None), net, jstate)
    # a copy: the optimizer's state_dict holds its live moments, which the
    # one-process chunk below updates in place
    saved = copy.deepcopy(state.state_dict())
    draws, _ = chunk_draws(jenv, env, jstate.key, cfg)
    jstate2, jmetrics = jchunk(jstate, jhyper)
    state2, metrics = chunk(state, Hyper(lr=LR, ent_coef=ENT), draws)
    one = dict(params={k: v.detach() for k, v in state2.params.items()},
               metrics=metrics, env_states=state2.env_states,
               last_obs=state2.last_obs)
    return dict(jstate=jstate2, jmetrics=jmetrics, jnet=jnet, net=net,
                saved=saved, draws=draws, one=one)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_chunk_matches_jax_and_one_process(refs, n, tmp_path):
    draws = refs["draws"]
    local_n = CFG["n_steps"] * CFG["num_envs"] // n
    perms = torch.stack([torch.from_numpy(
        np.random.default_rng(e).permutation(local_n))
        for e in range(CFG["num_epochs"])])
    inp = dict(cfg=CFG, lr=LR, ent=ENT, state=refs["saved"],
               draws=ChunkDraws(draws.action_normals, draws.reset_draws,
                                perms))
    results = run_ranks(tmp_path, RANK_BODY, n, inputs=inp)
    params = same_on_every_rank(results, "params")
    metrics = same_on_every_rank(results, "metrics")
    env_states = tree_map(lambda *xs: torch.cat(xs),
                          *[r["env_states"] for r in results])
    last_obs = torch.cat([r["last_obs"] for r in results])

    # against the JAX package's 8-device chunk
    jstate = refs["jstate"]
    compare_state(jstate.env_states, env_states)
    np.testing.assert_allclose(last_obs.numpy(), np.asarray(jstate.last_obs),
                               rtol=0, atol=1e-4)
    for k, v in refs["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    obs = torch.cat([r["obs"] for r in results], dim=1).reshape(
        -1, refs["net"].obs_dim)
    with torch.no_grad():
        got = outputs(lambda o: torch.func.functional_call(
            refs["net"], params, (o,)), obs)
    want = outputs(lambda o: refs["jnet"].apply(jstate.params,
                                                jnp.asarray(o)),
                   obs.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    # against the port's one-process chunk on the same state and draws
    one = refs["one"]
    for k, v in one["params"].items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5), env_states,
        one["env_states"])
