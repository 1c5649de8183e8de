"""Policy / value networks.

Port of ``opendog_tpu/rl/networks.py``.  ``MLPActorCritic`` covers the
reference's three configurations: 512-256 tanh MLPs with a tanh on the
action mean and a learned state-independent log-std (sim2real/train.py:
132-149), 1024-512 (train2.py:149-157), and SB3's 64-64 tanh MlpPolicy
without squashing (train/train.py:117); ``layer_norm_extractor`` adds the
shared Linear(50) -> LayerNorm -> ReLU -> Linear(40) features extractor of
train/CurstomNetwork.py:6-17.

flax infers a layer's input width at ``init``; a ``Linear`` needs it at
construction, so the module takes ``obs_dim``.  Parameters start as flax
starts them (truncated lecun-normal kernels, zero biases, unit LayerNorm
scales), and :func:`load_flax_params` carries a flax parameter tree across.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# flax's LayerNorm epsilon (PyTorch's default is 1e-5)
LAYER_NORM_EPS = 1e-6
# lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"), whose
# draws are N(0, 1) cut at +-2, scaled by sqrt(1 / fan_in) / this (the
# standard deviation of that cut normal)
_TRUNC_STD = 0.87962566103423978


class FlaxLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: the variance as
    ``mean(x^2) - mean(x)^2`` clamped at 0, epsilon 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        mean2 = torch.mean(torch.square(x), dim=-1, keepdim=True)
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.scale
        return (x - mean) * mul + self.bias


class MLPActorCritic(nn.Module):
    """``forward(obs) -> (mean, log_std, value)`` for observations
    (..., obs_dim): mean (..., action_dim), log_std (action_dim,), value
    (...).  ``forward(obs, value=False)`` skips the critic (value None).

    flax's layer order, which :func:`load_flax_params` follows:
    ``Dense_0`` / ``LayerNorm_0`` / ``Dense_1`` for the extractor when it
    is on, then the actor's hidden layers and mean head, then the
    critic's."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (512, 256),
                 squash_mean: bool = True,
                 log_std_init: float = float(np.log(0.4)),
                 layer_norm_extractor: bool = False,
                 extractor_dims: Tuple[int, int] = (50, 40),
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.obs_dim, self.action_dim = int(obs_dim), int(action_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.squash_mean = bool(squash_mean)
        self.log_std_init = float(log_std_init)
        self.layer_norm_extractor = bool(layer_norm_extractor)
        self.extractor_dims = tuple(extractor_dims)
        width = self.obs_dim
        if self.layer_norm_extractor:
            h0, feat = self.extractor_dims
            self.extractor = nn.ModuleList([nn.Linear(width, h0),
                                            FlaxLayerNorm(h0),
                                            nn.Linear(h0, feat)])
            width = feat

        def mlp(out: int) -> nn.ModuleList:
            dims = (width,) + self.hidden + (out,)
            return nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(dims[:-1], dims[1:]))

        self.actor = mlp(self.action_dim)
        self.critic = mlp(1)
        self.log_std = nn.Parameter(torch.full((self.action_dim,),
                                               self.log_std_init))
        self.to(device)
        with torch.no_grad():
            for name, p in self.flax_init(generator).items():
                self.get_parameter(name).copy_(p)

    def flax_layers(self):
        """``(flax name, module)`` pairs in flax's numbering."""
        dense = []
        out = []
        if self.layer_norm_extractor:
            dense.append(self.extractor[0])
            out.append(("LayerNorm_0", self.extractor[1]))
            dense.append(self.extractor[2])
        dense += list(self.actor) + list(self.critic)
        out += [(f"Dense_{i}", lin) for i, lin in enumerate(dense)]
        return out

    def flax_init(self, generator: Optional[torch.Generator] = None):
        """New parameters ``{name: tensor}`` drawn as flax draws them:
        each kernel from a truncated normal of standard deviation
        sqrt(1 / fan_in), biases 0, LayerNorm scales 1, the log-std
        ``log_std_init``.  ``generator`` is on the module's device."""
        out, new = {}, {}
        for name, p in self.named_parameters():
            out[name] = new[id(p)] = torch.zeros_like(p, requires_grad=False)
        for _, mod in self.flax_layers():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(new[id(mod.weight)], 0.0, std,
                                      -2.0 * std, 2.0 * std,
                                      generator=generator)
            else:
                new[id(mod.scale)].fill_(1.0)
        out["log_std"].fill_(self.log_std_init)
        return out

    def forward(self, obs: torch.Tensor, value: bool = True):
        if self.layer_norm_extractor:
            x = self.extractor[1](self.extractor[0](obs))
            obs = self.extractor[2](torch.relu(x))
        a = obs
        for lin in self.actor[:-1]:
            a = torch.tanh(lin(a))
        mean = self.actor[-1](a)
        if self.squash_mean:
            mean = torch.tanh(mean)
        v = None
        if value:
            v = obs
            for lin in self.critic[:-1]:
                v = torch.tanh(lin(v))
            v = self.critic[-1](v)[..., 0]
        return mean, self.log_std, v


def load_flax_params(module: MLPActorCritic, tree: dict) -> MLPActorCritic:
    """Copies a flax parameter tree (numpy arrays, as
    ``flax.serialization.msgpack_restore`` or :mod:`.student_io` returns
    it; with or without the top-level ``"params"`` key) into ``module``,
    whose options must be those the tree was made with.  A flax kernel is
    (in, out), a ``Linear`` weight (out, in).  Returns ``module``."""
    params = tree.get("params", tree)
    layers = dict(module.flax_layers())
    want = set(layers) | {"log_std"}
    if set(params) != want:
        raise ValueError(f"flax tree has layers {sorted(params)}, the "
                         f"module {sorted(want)}")

    def put(dst: torch.Tensor, src, name: str):
        src = torch.as_tensor(np.asarray(src, np.float32))
        if src.shape != dst.shape:
            raise ValueError(f"{name}: flax shape {tuple(src.shape)}, the "
                             f"module's {tuple(dst.shape)}")
        dst.copy_(src.to(dst.device))

    with torch.no_grad():
        for name, mod in layers.items():
            leaf = params[name]
            if isinstance(mod, nn.Linear):
                put(mod.weight, np.asarray(leaf["kernel"]).T, name)
                put(mod.bias, leaf["bias"], name)
            else:
                put(mod.scale, leaf["scale"], name)
                put(mod.bias, leaf["bias"], name)
        put(module.log_std, params["log_std"], "log_std")
    return module


COMMITTED_WALK_POLICY = os.path.join(os.path.dirname(__file__), "policies",
                                     "walk_1_best_970.npz")


def read_npz_tree(path: str) -> dict:
    """A flax parameter tree saved as an ``.npz`` of ``layer/leaf`` keys
    (``Dense_0/kernel``, ..., ``log_std``), as nested dicts of numpy
    arrays for :func:`load_flax_params`.  ``COMMITTED_WALK_POLICY`` is
    the JAX package's ``runs/walk_1`` best policy (step 970, the 64-64
    walk network) carried across so."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *layers, leaf = key.split("/")
            node = tree
            for layer in layers:
                node = node.setdefault(layer, {})
            node[leaf] = data[key]
    return tree


def gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * torch.square(action - mean) / var - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def sample_action(generator: Optional[torch.Generator], mean, log_std):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise
