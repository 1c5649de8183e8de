"""Data-parallel PPO over a mesh of ranks, and the scaling-efficiency
harness.

Port of ``opendog_tpu/parallel/rollout.py``: the env batch is sharded over
the mesh's ranks, the parameters and Adam's state are replicated, and each
minibatch's gradients are ``pmean``-ed inside the update
(``rl.ppo.make_ppo(..., mesh=)``): one learner over all rollouts, the
reference's SubprocVecEnv-into-one-PPO semantics (``train/train.py:63-87``).
"""
from __future__ import annotations

from typing import Callable

from ..envs.base import Env, tree_copy_
# the module, not its names: rl.ppo imports parallel.collectives, so either
# package may be the one imported first
from ..rl import ppo
from .mesh import Mesh, replicate, shard_batch


def make_sharded_ppo(env: Env, network, config: ppo.PPOConfig, mesh: Mesh):
    """Data-parallel PPO on this rank of ``mesh``, on the
    mesh's device: returns ``(init(generator, draws=None) -> TrainState,
    train_chunk(state, hyper, draws=None) -> (state, metrics))`` as
    ``make_ppo`` does.

    ``config`` is GLOBAL: ``num_envs`` and ``minibatch_size`` are divided
    over the n ranks, and this raises where n divides either not.  ``init``
    builds the state a one-rank learner of ``config`` would build (from
    ``generator`` or the global reset ``draws``), then keeps this rank's
    block of ``env_states`` / ``last_obs`` and rank 0's parameters.  A
    chunk's draws are global (``draw_chunk(env, local config, generator,
    device, shards=n)``, or passed in): every rank draws the same from the
    same seed.

    An n-rank chunk reproduces the one-rank chunk on the whole env batch
    when ``minibatch_size`` is the full batch (up to the order of the
    gradient sums); with smaller minibatches each rank permutes only its
    own samples, so the minibatches hold other samples than the one-rank
    learner's: a valid stratified data-parallel minibatching, not a bit
    exact reproduction.  On CUDA the rollout step replays its graph, as
    ``make_ppo``'s does."""
    n = mesh.size
    if config.num_envs % n:
        raise ValueError(f"num_envs ({config.num_envs}) must divide over "
                         f"the mesh's {n} ranks")
    if config.minibatch_size % n:
        raise ValueError(f"minibatch_size ({config.minibatch_size}) must "
                         f"divide over the mesh's {n} ranks")
    local = config._replace(num_envs=config.num_envs // n,
                            minibatch_size=config.minibatch_size // n)
    init_global, _ = ppo.make_ppo(env, network, config, mesh.device,
                                  graphs=False)
    _, chunk = ppo.make_ppo(env, network, local, mesh.device, mesh=mesh)

    def init(generator, draws=None) -> ppo.TrainState:
        state = init_global(generator, draws)
        tree_copy_(state.params, replicate(mesh, state.params))
        state.env_states = shard_batch(mesh, state.env_states)
        state.last_obs = shard_batch(mesh, state.last_obs)
        return state

    return init, chunk


def scaling_efficiency(run_fn: Callable[[int], float],
                       device_counts) -> dict:
    """Measure throughput(run_fn) at several device counts; returns
    {n: (throughput, efficiency_vs_1)} (BASELINE.md scaling harness)."""
    results = {}
    base = None
    for n in device_counts:
        thr = run_fn(n)
        if base is None:
            base = thr
        results[n] = (thr, thr / (base * n) if base else 0.0)
    return results
