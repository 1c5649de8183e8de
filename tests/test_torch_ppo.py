"""The port's PPO pieces against the JAX package's, and the helpers of the
chunk tests (``test_torch_ppo_chunk_clip.py``, ``..._plain.py``,
``test_torch_ppo_update.py``): the JAX chunk's draws made from its own key
chain (``ppo.py:105-140, 219-222``), the carrying of a JAX ``TrainState``
into the port's, GAE, optax's global-norm clip, one Adam step from carried
moments, the adaptive scheduler and the train state's save / restore.

Tolerances: GAE (advantages and returns) 1e-6 relative (1e-6 of the
largest magnitude absolute); the clip 1e-6 relative (the norm's sum in
another order: 2.4e-7 measured); parameters after one
Adam step from the same state and gradients 2e-6 absolute (Adam's update
in float32 in another order, as tests/test_torch_distill.py states); the
scheduler's floats equal.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.rl import MLPActorCritic as JaxMLP
from opendog_tpu.rl import PPOConfig as JaxPPOConfig
from opendog_tpu.rl.adaptive import AdaptiveState as JaxAdaptive
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.envs.base import tree_copy_, tree_map
from opendog_tpu_torch.rl import adaptive
from opendog_tpu_torch.rl.networks import MLPActorCritic, load_flax_params
from opendog_tpu_torch.rl.ppo import (ChunkDraws, Hyper, PPOConfig,
                                      clip_by_global_norm_,
                                      load_flax_train_state, make_ppo)
from test_torch_envs import jax_to_dict, reset_draws, t_

torch.set_num_threads(1)

TINY = dict(num_envs=4, n_steps=8, num_epochs=2, minibatch_size=16)
HIDDEN = (32, 32)


def tiny(loss="clip", **cfg):
    """The tiny env of tests/test_ppo.py:11-13 (OpenDOG walk, frame_skip
    2) in both packages, the 32-32 network and the PPO configs."""
    kw = dict(TINY, **cfg)
    jenv = jax_envs.WalkEnv(jax_assets.load_opendog("flat"), frame_skip=2)
    env = envs.WalkEnv(assets.load_opendog("flat", device="cpu"),
                       frame_skip=2)
    jnet = JaxMLP(action_dim=8, hidden=HIDDEN, squash_mean=False)
    net = MLPActorCritic(env.obs_size, 8, hidden=HIDDEN, squash_mean=False)
    return (jenv, env, jnet, net, JaxPPOConfig(loss=loss, **kw),
            PPOConfig(loss=loss, **kw))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def chunk_draws(jenv, env, key, cfg):
    """The draws of a JAX chunk from its state's key: per step the action
    normals and every env's reset draws, then one permutation per epoch
    (ppo.py:108-120, 221-222).  Returns (ChunkDraws, the key after)."""
    B, T, A = cfg.num_envs, cfg.n_steps, env.action_dim
    normals, resets = [], []
    for _ in range(T):
        key, k_act, k_reset = jax.random.split(key, 3)
        normals.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (A,)))(jax.random.split(k_act,
                                                                    B))))
        resets.append(reset_draws(jenv, env, jax.random.split(k_reset, B)))
    perms = []
    for _ in range(cfg.num_epochs):
        key, kperm = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kperm, B * T)))
    stacked = tree_map(lambda *xs: torch.stack(xs), resets[0], *resets[1:])
    return ChunkDraws(t_(np.stack(normals)), stacked,
                      t_(np.stack(perms)).long()), key


def carry_state(state, net, jstate):
    """The port's state set to a JAX ``TrainState``: params, Adam moments
    and count, env states and last observations."""
    adam = jstate.opt_state[1].inner_state[0]
    load_flax_train_state(state, net, np_tree(jstate.params),
                          mu=np_tree(adam.mu), nu=np_tree(adam.nu),
                          count=int(adam.count))
    tree_copy_(state.env_states, jax_to_dict(jstate.env_states))
    state.last_obs.copy_(t_(jstate.last_obs))
    state.update_count = int(jstate.update_count)
    return state


def outputs(params_fn, obs):
    mean, log_std, value = params_fn(obs)
    return np.concatenate([np.asarray(mean).reshape(len(obs), -1),
                           np.asarray(value).reshape(len(obs), 1),
                           np.broadcast_to(np.asarray(log_std),
                                           (len(obs), len(log_std)))], 1)


def _random_traj(rng, T, B, obs_dim):
    done = rng.uniform(size=(T, B)) < 0.25
    return dict(
        obs=rng.normal(0, 1, (T, B, obs_dim)).astype(np.float32),
        bootstrap_obs=rng.normal(0, 1, (T, B, obs_dim)).astype(np.float32),
        reward=rng.uniform(0, 2, (T, B)).astype(np.float32),
        done=done, terminated=done & (rng.uniform(size=(T, B)) < 0.5))


def _jax_gae(jnet, jparams, traj, last_obs, gamma, lam):
    """ppo.py:142-170 on a given trajectory (its value head for values)."""
    _, _, value = jnet.apply(jparams, traj["obs"])
    _, _, last_value = jnet.apply(jparams, last_obs)
    _, _, boot = jnet.apply(jparams, traj["bootstrap_obs"])

    def scan_fn(carry, x):
        gae, next_value = carry
        done = x["done"]
        nv = jnp.where(done, jnp.where(x["terminated"], 0.0, x["boot_v"]),
                       next_value)
        delta = x["reward"] + gamma * nv - x["value"]
        gae = delta + gamma * lam * (~done) * gae
        return (gae, x["value"]), gae

    _, adv = jax.lax.scan(
        scan_fn, (jnp.zeros_like(last_value), last_value),
        dict(reward=traj["reward"], value=value, terminated=traj["terminated"],
             done=traj["done"], boot_v=boot), reverse=True)
    return np.asarray(adv), np.asarray(adv + value), np.asarray(value)


def test_gae_matches_jax():
    """GAE over a trajectory with terminations (bootstrap 0) and
    truncations (bootstrap through the pre-reset observation's value)."""
    jenv, env, jnet, net, jcfg, cfg = tiny()
    T, B = 16, 4
    rng = np.random.default_rng(0)
    traj = _random_traj(rng, T, B, env.obs_size)
    last_obs = rng.normal(0, 1, (B, env.obs_size)).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, env.obs_size)))
    init, chunk = make_ppo(env, net, cfg._replace(n_steps=T), device="cpu")
    state = init(None)
    load_flax_train_state(state, net, np_tree(jparams))
    want_adv, want_ret, value = _jax_gae(
        jnet, jparams, {k: jnp.asarray(v) for k, v in traj.items()},
        jnp.asarray(last_obs), cfg.gamma, cfg.gae_lambda)
    ttraj = {k: t_(v) for k, v in traj.items()}
    ttraj["value"] = t_(value)
    with torch.no_grad():
        adv, ret = chunk.compute_gae(state.params, ttraj, t_(last_obs))
    for got, want in ((adv, want_adv), (ret, want_ret)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("scale", [0.001, 0.1])
def test_clip_by_global_norm_matches_optax(scale):
    """optax's formula on both sides of the bound (norm 0.5: the gradients
    have norm ~0.03 and ~3.3)."""
    rng = np.random.default_rng(1)
    grads = [rng.normal(0, scale, s).astype(np.float32)
             for s in ((33, 32), (32,), (8,))]
    want, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [t_(g) for g in grads]
    clip_by_global_norm_(got, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


def as_torch(tree):
    """A flax tree of the tiny network as ``{name: tensor}`` in the port's
    layout."""
    scratch = MLPActorCritic(33, 8, hidden=HIDDEN, squash_mean=False)
    load_flax_params(scratch, np_tree(tree))
    return {k: v.detach().clone() for k, v in scratch.named_parameters()}


def test_adam_step_from_carried_moments_matches_optax():
    """One step of the JAX package's chain (clip 0.5, Adam at lr 3e-4)
    from Adam moments and a count carried across, on the same gradients:
    parameters to 2e-6."""
    jenv, env, jnet, net, jcfg, cfg = tiny()
    jparams = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, env.obs_size)))
    rng = np.random.default_rng(2)

    def rand(s):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.normal(0, s, x.shape), jnp.float32), jparams)

    mu, grads = rand(0.01), rand(0.05)
    nu = jax.tree.map(jnp.abs, rand(1e-4))
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.inject_hyperparams(optax.adam)(learning_rate=3e-4))
    opt_state = tx.init(jparams)
    inner = opt_state[1].inner_state
    opt_state = (opt_state[0], opt_state[1]._replace(inner_state=(
        inner[0]._replace(count=jnp.int32(5), mu=mu, nu=nu), inner[1])))
    updates, _ = tx.update(grads, opt_state, jparams)
    want = as_torch(optax.apply_updates(jparams, updates))

    init, _ = make_ppo(env, net, cfg, device="cpu")
    state = init(None)
    load_flax_train_state(state, net, np_tree(jparams), mu=np_tree(mu),
                          nu=np_tree(nu), count=5)
    g = as_torch(grads)
    for k, p in state.params.items():
        p.grad = g[k]
    for group in state.opt_state.param_groups:
        group["lr"] = 3e-4
    with torch.no_grad():
        clip_by_global_norm_([p.grad for p in state.params.values()], 0.5)
    state.opt_state.step()
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   v.numpy(), rtol=0, atol=2e-6, err_msg=k)


def test_adaptive_scheduler_reference_semantics():
    """tests/test_ppo.py:73-82 on the copy, and the copy against the JAX
    module on a long random reward sequence: every lr, entropy and shift
    equal."""
    s = adaptive.AdaptiveState()
    lr0 = s.lr
    shifts = [s.record_episode(r) for r in [10, 9, 8, 7, 6, 5, 4, 3, 2, 1]]
    assert s.lr == max(1e-6, lr0 * 0.75)
    assert shifts[-1] < 0
    assert adaptive.AdaptiveState.clamp_log_std(0.0, 10.0) == np.log(0.5)
    assert adaptive.AdaptiveState.clamp_log_std(0.0, -10.0) == np.log(0.10)
    a, b = adaptive.AdaptiveState(), JaxAdaptive()
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.normal(0, 3, 400)) + rng.normal(0, 1, 400)
    for r in walk:
        assert a.record_episode(float(r)) == b.record_episode(float(r))
        assert (a.lr, a.ent_coef) == (b.lr, b.ent_coef)
    assert a.lr != 1e-4 and math.isfinite(a.lr)


def test_train_state_save_restore_round_trip():
    """``state_dict`` -> ``load_state_dict`` into a fresh state restores
    params, Adam moments, env states, observations, the generator and the
    count exactly."""
    _, env, _, net, _, cfg = tiny()
    init, chunk = make_ppo(env, net, cfg, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    state, _ = chunk(state, Hyper(lr=1e-4, ent_coef=0.005))
    saved = state.state_dict()
    init2, _ = make_ppo(env, net, cfg, device="cpu")
    other = init2(torch.Generator().manual_seed(1))
    other.load_state_dict(saved)
    for k, v in state.params.items():
        assert torch.equal(v, other.params[k]), k
    so, oo = state.opt_state.state_dict(), other.opt_state.state_dict()
    for i, st in so["state"].items():
        for k, v in st.items():
            assert torch.equal(v, oo["state"][i][k]), (i, k)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             state.env_states, other.env_states)
    assert torch.equal(state.last_obs, other.last_obs)
    assert torch.equal(state.generator.get_state(),
                       other.generator.get_state())
    assert other.update_count == state.update_count == 1


def run_chunk_vs_jax(loss, **cfg):
    """A whole ``train_chunk`` against the JAX package's jitted one on the
    tiny env: the JAX run trains a first chunk alone (so that the Adam
    moments are not zero), its state is carried into the port's, and
    both train a second chunk on the JAX chunk's draws.  Returns the
    (JAX, port) states and metrics of the second chunk."""
    from opendog_tpu.rl import Hyper as JaxHyper
    from opendog_tpu.rl import make_ppo as jax_make_ppo

    jenv, env, jnet, net, jcfg, cfg = tiny(loss, **cfg)
    jinit, jchunk = jax_make_ppo(jenv, jnet, jcfg)
    jchunk = jax.jit(jchunk)
    jhyper = JaxHyper(lr=jnp.float32(3e-4), ent_coef=jnp.float32(0.005))
    jstate, _ = jchunk(jinit(jax.random.PRNGKey(0)), jhyper)
    init, chunk = make_ppo(env, net, cfg, device="cpu")
    state = carry_state(init(None), net, jstate)
    draws, key_after = chunk_draws(jenv, env, jstate.key, cfg)
    jstate2, jmetrics = jchunk(jstate, jhyper)
    state2, metrics = chunk(state, Hyper(lr=3e-4, ent_coef=0.005), draws)
    np.testing.assert_array_equal(np.asarray(jstate2.key),
                                  np.asarray(key_after))
    return jstate2, jmetrics, state2, metrics, (jnet, net, chunk)


def check_chunk(loss):
    """The chunk's outputs: the env states and last observations to the
    env tolerances (the jitted JAX step's roundings: 1e-4 qpos, 1e-3
    qvel; observations 1e-4); the metrics to 1e-4 relative (1e-6
    absolute); the trained networks as functions on the chunk's
    observations to 1e-5 (ROADMAP Queue 3: a weight whose gradient is at
    rounding level steps by up to lr in either package), their log-stds
    included; ``update_count`` 2."""
    from test_torch_envs import compare_state

    jstate, jm, state, m, (jnet, net, chunk) = run_chunk_vs_jax(loss)
    compare_state(jstate.env_states, state.env_states)
    np.testing.assert_allclose(state.last_obs.numpy(),
                               np.asarray(jstate.last_obs), rtol=0,
                               atol=1e-4)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert state.update_count == int(jstate.update_count) == 2
    obs = chunk.rollout.traj["obs"].reshape(-1, net.obs_dim)
    with torch.no_grad():
        got = outputs(lambda o: torch.func.functional_call(
            net, state.params, (o,)), obs)
    want = outputs(lambda o: jnet.apply(jstate.params, jnp.asarray(o)),
                   obs.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the chunk trained: the parameters moved from the carried ones
    return jm, m
