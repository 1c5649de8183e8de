"""Functional environment protocol and batched autoreset.

Port of ``opendog_tpu/envs/base.py``.  The JAX package writes an env for one
state and vmaps it; here an env is written over a leading env axis: its
state is a dataclass of tensors, each with the env axis first, and
``reset`` takes the batch's random draws (a dataclass of tensors, env axis
first, that the env's ``draw_reset`` fills from a ``torch.Generator``) in
place of PRNG keys: ``torch`` cannot reproduce ``jax.random``, so the
tests hand both packages the same draws.

Every env has ``reset(draws) -> (state, obs)``, ``step(state, action) ->
(state, Transition)``, ``draw_reset(generator, n) -> draws``,
``obs_size`` and ``action_dim``.  Its state and draws hold no host data,
and ``reset`` and ``step`` read nothing back to the host, so that a CUDA
graph can capture them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Protocol, Tuple

import torch


@dataclass
class Transition:
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Any

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class Env(Protocol):
    obs_size: int
    action_dim: int

    def draw_reset(self, generator, n: int) -> Any:
        ...

    def reset(self, draws: Any) -> Tuple[Any, torch.Tensor]:
        ...

    def step(self, state: Any, action: torch.Tensor
             ) -> Tuple[Any, Transition]:
        ...


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (dataclasses, dicts, tuples,
    lists; None and Python scalars pass through), with the matching leaves
    of ``rest``: the counterpart of ``jax.tree.map``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    raise TypeError(f"tree_map: unsupported leaf {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def tree_to_dict(tree):
    """Nested dicts, lists and tensors of ``tree`` (dataclasses become
    dicts of their fields): what ``torch.save`` stores without pickling a
    class."""
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_to_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: tree_to_dict(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_to_dict(v) for v in tree]
    return tree


def tree_copy_(dst, src):
    """Copies every tensor of ``src`` into the matching one of ``dst`` in
    place; ``src`` has ``dst``'s structure or ``tree_to_dict``'s form of
    it.  Returns ``dst``."""
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            s = src[f.name] if isinstance(src, dict) else getattr(src, f.name)
            tree_copy_(getattr(dst, f.name), s)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            tree_copy_(v, src[k])
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"tree_copy_: {len(dst)} leaves against "
                             f"{len(src)}")
        for a, b in zip(dst, src):
            tree_copy_(a, b)
    return dst


def where_done(done: torch.Tensor, fresh, nxt):
    """``fresh`` where an env is done, else ``nxt``, field by field (the
    autoreset merge of ``ppo.py:122-127``)."""
    def pick(a, b):
        return torch.where(done.reshape(done.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return tree_map(pick, fresh, nxt)


def vector_env(env: Env):
    """Autoreset wrappers ``(reset_fn(draws), step_fn(states, actions,
    draws))``: when an episode ends, the returned state and observation
    are those of a fresh episode made from that step's reset draws
    (Gymnasium / SB3 VecEnv semantics)."""

    def reset_fn(draws):
        return env.reset(draws)

    def step_fn(states, actions, draws):
        next_states, trans = env.step(states, actions)
        done = trans.done
        fresh_states, fresh_obs = env.reset(draws)
        merged = where_done(done, fresh_states, next_states)
        obs = torch.where(done[:, None], fresh_obs, trans.obs)
        return merged, dataclasses.replace(trans, obs=obs)

    return reset_fn, step_fn
