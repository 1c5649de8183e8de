"""Deterministic policy evaluation.

Port of ``opendog_tpu/rl/evaluate.py`` (the reference's SB3
``EvalCallback``, ``train/train.py:142-149``, and ``test/test.py:12-43``):
an eval episode rolls one env for a fixed number of steps with the policy
*mean* action; once the episode has ended every field of the env state is
frozen, so the episode's return and length are its own and the recorded
physics states (for ``utils.render.record_rollout``) repeat the last one.

On the card one step (policy forward, env step, the freeze and the
records) is captured in a CUDA graph over static buffers and replayed
``n_steps`` times; on the CPU it runs eagerly.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..device import resolve_device, use_full_fp32
from ..envs.base import tree_copy_, tree_map, where_done
from ..physics import State


class PolicyRollout:
    """``policy(obs) -> action`` driving one env (B = 1) for ``n_steps``
    steps from ``env.reset(draws)``, frozen after its episode ends.

    ``__call__(draws)`` returns (metrics, physics, infos): metrics
    ``episode_return``, ``episode_len``, ``forward_x`` (trunk x at the end
    less at the start) and ``terminated`` (the episode ended) as 0-d
    tensors; the physics states (qpos (n_steps, nq), qvel, time) after
    each step; and ``infos[k]`` (n_steps, ...) the step's
    ``Transition.info[k]`` for each of ``info_keys``, as the env returned
    it (not frozen).  The outputs are static buffers that the next call
    overwrites: clone what you keep.

    On CUDA ``policy`` must be capturable: a function of tensors whose
    addresses do not change."""

    def __init__(self, env, policy: Callable, n_steps: int, device=None,
                 info_keys: Sequence[str] = ()):
        self.env, self.policy, self.n_steps = env, policy, int(n_steps)
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda"
        self.info_keys = tuple(info_keys)
        self.carry = self.rec = None
        self.graph = None
        self.t = torch.zeros(1, dtype=torch.long, device=self.device)
        self._steps = torch.arange(self.n_steps, device=self.device)

    def _start(self, draws):
        with torch.no_grad():
            state, obs = self.env.reset(draws)
        done = torch.zeros(1, dtype=torch.bool, device=self.device)
        total = torch.zeros(1, dtype=torch.float32, device=self.device)
        steps = torch.zeros(1, dtype=torch.int32, device=self.device)
        carry = (state, obs, done, total, steps)
        if self.carry is None:
            self.carry = tree_map(torch.clone, carry)
        else:
            tree_copy_(self.carry, carry)
        return state.physics.qpos[0, 0].clone()

    def _step(self):
        state, obs, done, total, steps = self.carry
        action = self.policy(obs)
        nstate, trans = self.env.step(state, action)
        # freeze every field once the episode has ended
        nstate = where_done(done, state, nstate)
        nobs = torch.where(done[:, None], obs, trans.obs)
        total = total + torch.where(done, 0.0, trans.reward)
        steps = steps + torch.where(done, 0, 1).to(torch.int32)
        new_done = done | trans.done
        rec = dict(qpos=nstate.physics.qpos[0], qvel=nstate.physics.qvel[0],
                   time=nstate.physics.time[0])
        rec.update({k: trans.info[k][0] for k in self.info_keys})
        if self.rec is None:
            self.rec = {k: v.new_empty((self.n_steps,) + v.shape)
                        for k, v in rec.items()}
        for k, v in rec.items():
            self.rec[k].index_copy_(0, self.t, v[None])
        tree_copy_(self.carry, (nstate, nobs, new_done, total, steps))

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
        # the cyclic collector is held off, as GraphedTick holds it: a
        # collection inside the capture that frees another graph (a
        # dropped learner's or eval's, left as cyclic garbage) invalidates
        # the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self._step()
        finally:
            if collecting:
                gc.enable()

    def __call__(self, draws):
        x0 = self._start(draws)
        with torch.no_grad():
            for i in range(self.n_steps):
                self.t.copy_(self._steps[i:i + 1])
                if not self.graphs:
                    self._step()
                    continue
                if self.graph is None:
                    self._capture()
                self.graph.replay()
        state, _, done, total, steps = self.carry
        metrics = dict(episode_return=total[0], episode_len=steps[0],
                       forward_x=state.physics.qpos[0, 0] - x0,
                       terminated=done[0])
        physics = State(qpos=self.rec["qpos"], qvel=self.rec["qvel"],
                        time=self.rec["time"])
        return metrics, physics, {k: self.rec[k] for k in self.info_keys}


def make_eval(env, net, n_steps: int, device=None):
    """Build ``eval_fn(params, draws) -> (metrics, physics_states)``.

    ``params`` is ``{name: tensor}`` of ``net`` (copied into the eval's
    own buffers; None evaluates ``net``'s own parameters), ``draws`` one
    env's reset draws (``env.draw_reset(generator, 1)``).  metrics:
    ``episode_return``, ``episode_len``, ``forward_x``, ``terminated``;
    physics_states: a :class:`State` with a leading (n_steps,) time axis,
    frozen after termination (replay-safe).  The outputs are copies."""
    device = resolve_device(device)
    use_full_fp32()
    net = net.to(device)
    own = {k: v.detach().clone() for k, v in net.named_parameters()}

    def policy(obs):
        return functional_call(net, own, (obs,), {"value": False})[0]

    run = PolicyRollout(env, policy, n_steps, device)

    def eval_fn(params: Optional[Dict[str, torch.Tensor]], draws
                ) -> Tuple[Dict[str, torch.Tensor], State]:
        src = dict(net.named_parameters()) if params is None else params
        with torch.no_grad():
            for k, v in own.items():
                v.copy_(src[k])
        metrics, physics, _ = run(draws)
        return ({k: v.clone() for k, v in metrics.items()},
                tree_map(torch.clone, physics))

    return eval_fn
