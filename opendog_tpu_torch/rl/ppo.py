"""PPO: one engine, two reference behaviours.

Port of ``opendog_tpu/rl/ppo.py`` for one device (the ``axis_name``
data-parallel form is ROADMAP M14).

``loss="clip"``   the SB3 PPO configuration the reference trains with
                  (clipped surrogate, lr 1e-4, batch 512, 10 epochs, gamma
                  .99, clip .2, grad-norm .5; ``train/train.py:117-130``).
``loss="plain"``  the hand-rolled sim2real stack: epochs of vanilla policy
                  gradient on normalised GAE advantages with an MSE value
                  loss (``sim2real/train.py:553-570``).

A ``train_chunk`` is a rollout of ``n_steps`` batched env steps, GAE as a
reverse loop, and ``num_epochs`` of minibatch Adam.  optax's chain
(``clip_by_global_norm`` then ``adam``) becomes optax's clip formula written
out (``g * max_norm / norm`` only where ``norm >= max_norm``;
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and scales by a
clamped coefficient, another function) and ``torch.optim.Adam``, whose
learning rate is set on its param group at every chunk (the JAX package's
``inject_hyperparams``).

Randomness goes through :class:`ChunkDraws`: the action normals (n_steps,
B, A), each step's reset draws (n_steps, B, ...) and each epoch's
permutation, drawn at the chunk's start from the state's
``torch.Generator`` or injected (the tests build them with jax from the
JAX chunk's own keys).

On the card one rollout step (policy forward, sample, env step, the reset
of every env, the autoreset merge and the trajectory write) is captured in
one CUDA graph over static buffers and replayed ``n_steps`` times, the
step index a one-element input; nothing inside it draws or reads back to
the host.  ``graphs=False`` runs the same step eagerly, bit for bit the
same.  The update stays eager.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
from torch.func import functional_call

from ..device import resolve_device, use_full_fp32
from ..envs.base import (Env, tree_copy_, tree_map, tree_to_dict,
                         where_done)
from . import networks


class PPOConfig(NamedTuple):
    num_envs: int = 8
    n_steps: int = 256           # rollout length per env
    num_epochs: int = 10
    minibatch_size: int = 512
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    loss: str = "clip"           # "clip" (SB3) | "plain" (sim2real custom)
    normalize_advantage: bool = True


class Hyper(NamedTuple):
    """Hyperparameters the adaptive scheduler moves between chunks
    (sim2real/train.py:571-586)."""

    lr: float
    ent_coef: float


@dataclass
class TrainState:
    """Parameters ``{name: tensor}`` of the network (trained in place),
    the Adam optimizer over them (optax's state), the env states and last
    observations (env axis first), the generator of the chunk draws (the
    JAX package's key) and the number of chunks trained."""

    params: dict
    opt_state: torch.optim.Adam
    env_states: Any
    last_obs: torch.Tensor
    generator: Optional[torch.Generator]
    update_count: int

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors, dicts and lists (what
        ``torch.save`` stores without pickling a class)."""
        gen = self.generator
        return dict(
            params={k: v.detach().clone() for k, v in self.params.items()},
            opt_state=self.opt_state.state_dict(),
            env_states=tree_to_dict(tree_map(torch.clone, self.env_states)),
            last_obs=self.last_obs.clone(),
            generator=None if gen is None else gen.get_state(),
            update_count=int(self.update_count))

    def load_state_dict(self, d: dict) -> "TrainState":
        """Restores ``state_dict()``'s output in place."""
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(d["params"][k])
        self.opt_state.load_state_dict(d["opt_state"])
        tree_copy_(self.env_states, d["env_states"])
        self.last_obs.copy_(d["last_obs"])
        if self.generator is not None and d.get("generator") is not None:
            self.generator.set_state(d["generator"])
        self.update_count = int(d["update_count"])
        return self


@dataclass
class ChunkDraws:
    """The random draws of one chunk: action normals (n_steps, B, A), the
    env's reset draws with leading (n_steps, B) (every env is reset on
    every step and the fresh state kept where it is done, ``ppo.py:
    118-128``), and one permutation of the n_steps x B samples per epoch
    (num_epochs, n)."""

    action_normals: torch.Tensor
    reset_draws: Any
    perms: torch.Tensor


def draw_chunk(env: Env, config: PPOConfig, generator, device) -> ChunkDraws:
    """A chunk's draws from ``generator`` on ``device``: the normals, then
    the reset draws, then the permutations."""
    T, B = config.n_steps, config.num_envs
    normals = torch.randn((T, B, env.action_dim), generator=generator,
                          device=device)
    resets = tree_map(lambda x: x.reshape((T, B) + x.shape[1:]),
                      env.draw_reset(generator, T * B))
    n = T * B
    perms = torch.stack([torch.randperm(n, generator=generator,
                                        device=device)
                         for _ in range(config.num_epochs)])
    return ChunkDraws(normals, resets, perms)


def load_flax_train_state(state: TrainState,
                          network: networks.MLPActorCritic, params: dict,
                          mu: Optional[dict] = None,
                          nu: Optional[dict] = None,
                          count: int = 0) -> TrainState:
    """Carries the JAX package's ``TrainState`` across, in place: its flax
    ``params`` tree into ``state.params`` (through ``network``, whose
    parameters it also takes), and optax's Adam moments ``mu`` / ``nu``
    (trees like ``params``) and ``count`` into ``torch.optim.Adam``'s
    ``exp_avg`` / ``exp_avg_sq`` / ``step``.  Trees hold numpy arrays,
    with or without the top-level ``"params"`` key."""
    networks.load_flax_params(network, params)
    named = dict(network.named_parameters())
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(named[k])
    if mu is None:
        return state
    moments = []
    for tree in (mu, nu):
        scratch = copy.deepcopy(network)
        networks.load_flax_params(scratch, tree)
        moments.append(dict(scratch.named_parameters()))
    opt = state.opt_state
    for k, p in state.params.items():
        opt.state[p] = dict(
            step=torch.tensor(float(count)),
            exp_avg=moments[0][k].detach().clone().to(p.device),
            exp_avg_sq=moments[1][k].detach().clone().to(p.device))
    return state


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on ``grads`` in place: each becomes
    ``(g / norm) * max_norm`` where the global norm is at least
    ``max_norm``, else stays.  Returns the norm; reads nothing back."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class _Rollout:
    """A chunk's rollout over static buffers: the carry (env states, obs),
    the chunk's normals and reset draws, the trajectory, and the step
    index ``t``.  ``run(i)`` runs step i on them eagerly or replays its
    CUDA graph (captured at the first replay, after a warm-up step whose
    carry is put back)."""

    def __init__(self, env, network, params, config, device, graphs):
        self.env, self.network, self.params = env, network, params
        self.config, self.device, self.graphs = config, device, graphs
        self.carry = self.normals = self.resets = self.traj = None
        self.graph = None
        self.capture_s = 0.0
        self.t = torch.zeros(1, dtype=torch.long, device=device)
        self._steps = torch.arange(config.n_steps, device=device)

    def load(self, env_states, obs, draws: ChunkDraws):
        if self.carry is None:
            self.carry = (tree_map(torch.clone, env_states), obs.clone())
            self.normals = draws.action_normals.clone()
            self.resets = tree_map(torch.clone, draws.reset_draws)
            T, (B, O) = self.config.n_steps, obs.shape
            A = draws.action_normals.shape[-1]
            f, b = obs.dtype, torch.bool
            shapes = dict(obs=((B, O), f), action=((B, A), f),
                          logp=((B,), f), value=((B,), f),
                          reward=((B,), f), terminated=((B,), b),
                          done=((B,), b), bootstrap_obs=((B, O), f))
            self.traj = {k: torch.empty((T,) + shape, dtype=dt,
                                        device=self.device)
                         for k, (shape, dt) in shapes.items()}
        else:
            tree_copy_(self.carry, (env_states, obs))
            self.normals.copy_(draws.action_normals)
            tree_copy_(self.resets, draws.reset_draws)

    def _step(self):
        env, t = self.env, self.t
        env_states, obs = self.carry
        mean, log_std, value = functional_call(self.network, self.params,
                                               (obs,))
        nrm = self.normals.index_select(0, t)[0]
        action = mean + torch.exp(log_std) * nrm
        logp = networks.gaussian_logp(mean, log_std, action)
        next_states, trans = env.step(env_states, action)
        done = trans.done
        fresh_states, fresh_obs = env.reset(tree_map(
            lambda x: x.index_select(0, t)[0], self.resets))
        merged = where_done(done, fresh_states, next_states)
        next_obs = torch.where(done[:, None], fresh_obs, trans.obs)
        out = dict(obs=obs, action=action, logp=logp, value=value,
                   reward=trans.reward, terminated=trans.terminated,
                   done=done, bootstrap_obs=trans.obs)
        for k, v in out.items():
            self.traj[k].index_copy_(0, t, v[None])
        tree_copy_(self.carry, (merged, next_obs))

    def _capture(self):
        saved = tree_map(torch.clone, self.carry)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._step()
        current.wait_stream(side)
        tree_copy_(self.carry, saved)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()

    def run(self, i: int):
        """Step ``i`` of the chunk."""
        self.t.copy_(self._steps[i:i + 1])
        with torch.no_grad():
            if not self.graphs:
                self._step()
                return
            if self.graph is None:
                t0 = time.perf_counter()
                self._capture()
                torch.cuda.synchronize(self.device)
                self.capture_s = time.perf_counter() - t0
            self.graph.replay()


def make_ppo(env: Env, network: networks.MLPActorCritic, config: PPOConfig,
             device=None, graphs: Optional[bool] = None):
    """Returns ``(init(generator, draws=None) -> TrainState,
    train_chunk(state, hyper, draws=None) -> (state, metrics))``.

    ``network`` is an :class:`~.networks.MLPActorCritic` whose
    ``obs_dim`` / ``action_dim`` are the env's; ``init`` draws its
    parameters as flax does (``network.flax_init``) after the envs'
    reset draws.  ``train_chunk`` draws the chunk's :class:`ChunkDraws`
    from ``state.generator`` unless ``draws`` are given, trains the
    parameters in place and returns the state with the new env states
    and ``update_count + 1``, and the metrics of ``ppo.py:256-270`` as
    0-d tensors.  ``train_chunk.times`` holds the last chunk's seconds of
    rollout (its graph's capture included, ``capture_s`` of them) and
    update (host clock, synchronised on CUDA) and
    ``train_chunk.rollout`` the rollout's buffers (``traj``);
    ``train_chunk.compute_gae(params, traj, last_obs)`` is its GAE.

    ``graphs`` (default: on CUDA) replays the rollout step from a CUDA
    graph; a CPU device with ``graphs=True`` raises."""
    device = resolve_device(device)
    if graphs is None:
        graphs = device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
    if config.loss not in ("clip", "plain"):
        raise ValueError(f"unknown loss {config.loss!r}")
    use_full_fp32()
    network = network.to(device)
    names = [n for n, _ in network.named_parameters()]
    T, B = config.n_steps, config.num_envs
    n = T * B
    mb = min(config.minibatch_size, n)
    num_mb = n // mb
    rollout = None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def init(generator: Optional[torch.Generator],
             draws: Any = None) -> TrainState:
        if draws is None:
            draws = env.draw_reset(generator, B)
        with torch.no_grad():
            env_states, obs = env.reset(draws)
        if obs.shape[-1] != network.obs_dim:
            raise ValueError(f"observations are {obs.shape[-1]} wide, the "
                             f"network takes {network.obs_dim}")
        params = network.flax_init(generator)
        params = {k: params[k].detach().to(device).clone().requires_grad_()
                  for k in names}
        opt = torch.optim.Adam(params.values(), lr=1e-4, betas=(0.9, 0.999),
                               eps=1e-8)
        return TrainState(params=params, opt_state=opt,
                          env_states=env_states, last_obs=obs,
                          generator=generator, update_count=0)

    def forward(params, obs, value=True):
        return functional_call(network, params, (obs,), {"value": value})

    def compute_gae(params, traj, last_obs):
        """Reverse-loop GAE (sim2real/train.py:557-561).  Terminated rows
        bootstrap 0, truncated ones the value of the pre-reset
        observation."""
        _, _, last_value = forward(params, last_obs)
        _, _, boot_values = forward(params, traj["bootstrap_obs"])
        gae = torch.zeros_like(last_value)
        next_value = last_value
        adv = torch.empty_like(traj["value"])
        zero = torch.zeros_like(last_value)
        gl = config.gamma * config.gae_lambda
        for t in range(T - 1, -1, -1):
            done = traj["done"][t]
            nv = torch.where(done, torch.where(traj["terminated"][t], zero,
                                               boot_values[t]), next_value)
            delta = traj["reward"][t] + config.gamma * nv - traj["value"][t]
            gae = delta + gl * (~done) * gae
            adv[t] = gae
            next_value = traj["value"][t]
        return adv, adv + traj["value"]

    def loss_fn(params, batch, hyper: Hyper):
        mean, log_std, value = forward(params, batch["obs"])
        logp = networks.gaussian_logp(mean, log_std, batch["action"])
        entropy = networks.gaussian_entropy(log_std)
        adv = batch["adv"]
        if config.loss == "clip":
            ratio = torch.exp(logp - batch["logp"])
            clipped = torch.clamp(ratio, 1 - config.clip_eps,
                                  1 + config.clip_eps) * adv
            actor_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
        else:  # "plain": sim2real/train.py:567
            actor_loss = -torch.mean(logp * adv)
        value_loss = torch.mean(torch.square(value - batch["ret"]))
        total = (actor_loss + config.vf_coef * value_loss
                 - hyper.ent_coef * entropy)
        return total, (actor_loss, value_loss, entropy)

    def update(state: TrainState, flat, perms, hyper: Hyper):
        params, opt = state.params, state.opt_state
        leaves = [params[k] for k in names]
        for g in opt.param_groups:
            g["lr"] = float(hyper.lr)
        aux = []
        for e in range(config.num_epochs):
            idxs = perms[e][: num_mb * mb].reshape(num_mb, mb)
            for j in range(num_mb):
                idx = idxs[j]
                batch = {k: v[idx] for k, v in flat.items()}
                opt.zero_grad(set_to_none=True)
                total, parts = loss_fn(params, batch, hyper)
                total.backward()
                with torch.no_grad():
                    clip_by_global_norm_([p.grad for p in leaves],
                                         config.max_grad_norm)
                opt.step()
                aux.append(torch.stack([p.detach() for p in parts]))
        return torch.stack(aux)  # (epochs * num_mb, 3)

    def train_chunk(state: TrainState, hyper: Hyper,
                    draws: Optional[ChunkDraws] = None):
        nonlocal rollout
        if draws is None:
            draws = draw_chunk(env, config, state.generator, device)
        if rollout is None:
            rollout = _Rollout(env, network, state.params, config, device,
                               graphs)
            train_chunk.rollout = rollout
        if rollout.params is not state.params:
            raise ValueError("train_chunk serves the parameters of the state "
                             "it first trained: make a new make_ppo for "
                             "another")
        sync()
        t0 = time.perf_counter()
        rollout.capture_s = 0.0
        rollout.load(state.env_states, state.last_obs, draws)
        for i in range(T):
            rollout.run(i)
        sync()
        t1 = time.perf_counter()
        traj = {k: v.clone() for k, v in rollout.traj.items()}
        env_states, last_obs = tree_map(torch.clone, rollout.carry)
        with torch.no_grad():
            advantages, returns = compute_gae(state.params, traj, last_obs)
            if config.normalize_advantage:
                mu = torch.mean(advantages)
                var = torch.mean(torch.square(advantages - mu))
                advantages = (advantages - mu) / (torch.sqrt(var) + 1e-8)
        flat = dict(obs=traj["obs"].reshape(n, -1),
                    action=traj["action"].reshape(n, -1),
                    logp=traj["logp"].reshape(n),
                    adv=advantages.reshape(n),
                    ret=returns.reshape(n))
        aux = update(state, flat, draws.perms, hyper)
        sync()
        train_chunk.times = dict(rollout_s=t1 - t0,
                                 update_s=time.perf_counter() - t1,
                                 capture_s=rollout.capture_s)
        with torch.no_grad():
            ret_mu = torch.mean(returns)
            ret_var = torch.mean(torch.square(returns - ret_mu))
            actor_loss, value_loss, entropy = torch.mean(aux, dim=0)
            metrics = dict(
                mean_reward=torch.mean(traj["reward"]),
                sum_reward_per_env=torch.mean(traj["reward"].sum(0)),
                done_rate=torch.mean(traj["done"].to(torch.float32)),
                actor_loss=actor_loss,
                value_loss=value_loss,
                # critic residual over the target variance (1 - explained
                # variance): scale-free, unlike value_loss
                value_resid_frac=value_loss / (ret_var + 1e-8),
                entropy=entropy,
                mean_value=torch.mean(traj["value"]),
            )
        new_state = TrainState(params=state.params, opt_state=state.opt_state,
                               env_states=env_states, last_obs=last_obs,
                               generator=state.generator,
                               update_count=state.update_count + 1)
        return new_state, metrics

    train_chunk.times = {}
    train_chunk.rollout = None
    train_chunk.compute_gae = compute_gae
    return init, train_chunk
