"""Data-parallel PPO (``parallel.make_sharded_ppo``, ``make_ppo(...,
mesh=)``) at 2 and 4 gloo ranks on the CPU against the port's one-process
``make_ppo``, in the setup of tests/test_parallel.py:34-71: OpenDOG walk,
frame_skip 2, a 16-16 network, 16 envs x 4 steps, 2 epochs of one
minibatch of all 64 samples (so that each rank's permutation of its own
samples cannot change the minibatch), lr 3e-3.  Both learners start from
generator seed 42 and draw the same normals and reset draws.

Tolerances are the JAX test's: parameters 2e-5, the metrics 1e-4, the env
states 1e-5 (the gradients and moments summed in another order; the
rollout itself is the same).  Every rank's parameters and metrics are the
same bits.  Also: the sharded batch step (:73-90, observations 1e-5), a
mesh of one rank equal to ``make_ppo`` bit for bit, and the checks of a
global config that does not split.
"""
import numpy as np
import pytest
import torch

from opendog_tpu_torch.envs.base import tree_leaves
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

CFG = dict(num_envs=16, n_steps=4, num_epochs=2, minibatch_size=64)
HYPER = dict(lr=3e-3, ent_coef=0.005)

SETUP = """
import torch
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.envs.base import tree_leaves
from opendog_tpu_torch.parallel import make_sharded_ppo
from opendog_tpu_torch.rl.networks import MLPActorCritic
from opendog_tpu_torch.rl.ppo import Hyper, PPOConfig, make_ppo


def learner(cfg, mesh):
    env = envs.WalkEnv(assets.load_opendog("flat", device="cpu"),
                       frame_skip=2)
    net = MLPActorCritic(env.obs_size, 8, hidden=(16, 16))
    if mesh is None:
        return env, make_ppo(env, net, PPOConfig(**cfg), device="cpu")
    return env, make_sharded_ppo(env, net, PPOConfig(**cfg), mesh)


def one_chunk(cfg, hyper, mesh):
    env, (init, chunk) = learner(cfg, mesh)
    state, metrics = chunk(init(torch.Generator().manual_seed(42)),
                           Hyper(**hyper))
    return dict(params={k: v.detach() for k, v in state.params.items()},
                metrics=metrics,
                env_states=dict(enumerate(tree_leaves(state.env_states))),
                last_obs=state.last_obs)


def batch_step(states, actions, env=None):
    env = env or envs.WalkEnv(assets.load_opendog("flat", device="cpu"),
                              frame_skip=2)
    with torch.no_grad():
        return env.step(states, actions)[1].obs
"""

RANK_BODY = SETUP + """
from opendog_tpu_torch.parallel import collectives, env_mesh, shard_batch
inp = load_inputs()
mesh = env_mesh(device="cpu")
out = one_chunk(inp["cfg"], inp["hyper"], mesh)
obs = batch_step(shard_batch(mesh, inp["states"]),
                 shard_batch(mesh, inp["actions"]))
out["step"] = dict(obs=collectives.all_gather(obs, mesh))
raised = []
for bad in (dict(num_envs=4 * N + N // 2), dict(minibatch_size=N + 1)):
    try:
        learner(dict(inp["cfg"], **bad), mesh)
    except ValueError:
        raised.append(True)
out["raises"] = dict(split=torch.tensor(raised == [True, True]))
save(out)
"""


def _setup():
    ns = {}
    exec(SETUP, ns)
    return ns


@pytest.fixture(scope="module")
def refs():
    """The one-process chunk, a batch of 8 reset states with zero actions
    and their one-process step."""
    ns = _setup()
    env, _ = ns["learner"](CFG, None)
    with torch.no_grad():
        states, _ = env.reset(env.draw_reset(torch.Generator().manual_seed(0),
                                             8))
    actions = torch.zeros(8, 8)
    inp = dict(cfg=CFG, hyper=HYPER, states=states, actions=actions)
    return inp, ns["one_chunk"](CFG, HYPER, None), \
        ns["batch_step"](states, actions, env)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ppo_matches_one_process(refs, n, tmp_path):
    inp, one, obs = refs
    results = run_ranks(tmp_path, RANK_BODY, n, inputs=inp)
    assert all(bool(r["raises"]["split"]) for r in results)
    params = same_on_every_rank(results, "params")
    for k, v in one["params"].items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    metrics = same_on_every_rank(results, "metrics")
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # the rollout matched: the ranks' env blocks make the one-process batch
    for i, leaf in one["env_states"].items():
        got = torch.cat([r["env_states"][i] for r in results])
        np.testing.assert_allclose(got.numpy(), leaf.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"env state {i}")
    np.testing.assert_allclose(
        torch.cat([r["last_obs"] for r in results]).numpy(),
        one["last_obs"].numpy(), rtol=1e-5, atol=1e-5)
    # the sharded batch step (tests/test_parallel.py:73-90)
    step = same_on_every_rank(results, "step")["obs"]
    np.testing.assert_allclose(step.numpy(), obs.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_one_rank_mesh_is_make_ppo_bit_for_bit(refs):
    """make_sharded_ppo on a mesh of one rank (no process group): the
    one-process chunk, bit for bit: parameters, metrics, env states."""
    from opendog_tpu_torch.parallel import env_mesh

    _, one, _ = refs
    got = _setup()["one_chunk"](CFG, HYPER, env_mesh(device="cpu"))
    for part in ("params", "metrics", "env_states"):
        for k, v in one[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert torch.equal(got["last_obs"], one["last_obs"])
    assert len(tree_leaves(one["env_states"])) > 3
