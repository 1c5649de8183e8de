"""Behaviour-cloning of the analytic yaw-correction expert.

Port of ``Code/examples/cloning.py``: the expert maps yaw error to the
(N, Y) knee-lift pair exactly like the P-controller of the auto-correct walk
(cloning.py:19-31); a tiny MLP (1 -> 64 -> 64 -> 2, cloning.py:38-47) is
regression-trained on sampled errors and then drops into the walk loop in
place of the P-controller (examples/udp_walk_ai.py:42-43).

Port of the JAX package's ``apps/cloning.py``.  :class:`WalkPolicyNet`
starts as flax starts it (truncated lecun-normal kernels, zero biases) and
:func:`load_flax_params` carries a flax parameter tree across.
:func:`train_cloned_policy` is Adam (optax's defaults) on the mean squared
error; the sampled errors enter as draws, ``(num_steps, batch, 1)``, in
place of ``jax.random.uniform`` on split keys.  The JAX function jits its
training step; on CUDA the port runs the first step eagerly and replays
the rest from one CUDA graph of a step (forward, backward and a capturable
Adam step over static buffers).
"""
from __future__ import annotations

import gc
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device, use_full_fp32
from ..rl.networks import _TRUNC_STD
from .gaits import (
    CORRECTION_GAIN_KP,
    MAX_LIFT_ANGLE,
    MIN_LIFT_ANGLE,
    NEUTRAL_LIFT_ANGLE,
)


def expert_action(yaw_error_deg) -> torch.Tensor:
    """Analytic expert (cloning.py:19-31): N = 30 - Kp*e, Y = 30 + Kp*e,
    clamped [20, 50]."""
    e = torch.as_tensor(yaw_error_deg, dtype=torch.float32)
    c = CORRECTION_GAIN_KP * e
    n = torch.clamp(NEUTRAL_LIFT_ANGLE - c, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)
    y = torch.clamp(NEUTRAL_LIFT_ANGLE + c, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)
    return torch.stack([n, y], dim=-1)


class WalkPolicyNet(nn.Module):
    """1 -> 64 -> 64 -> 2 (cloning.py:38-47); flax's ``Dense_0`` ..
    ``Dense_2``."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(1, 64), nn.Linear(64, 64),
                                     nn.Linear(64, 2)]).to(device)
        with torch.no_grad():
            for lin in self.layers:
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                lin.bias.zero_()

    def flax_layers(self):
        """``(flax name, module)`` pairs in flax's numbering."""
        return [(f"Dense_{i}", lin) for i, lin in enumerate(self.layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.layers[0](x))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)


def load_flax_params(net: WalkPolicyNet, tree: dict) -> WalkPolicyNet:
    """Copies a flax parameter tree of the JAX ``WalkPolicyNet`` (numpy
    arrays, with or without the top-level ``"params"`` key) into ``net``.
    A flax kernel is (in, out), a ``Linear`` weight (out, in)."""
    params = tree.get("params", tree)
    layers = dict(net.flax_layers())
    if set(params) != set(layers):
        raise ValueError(f"flax tree has layers {sorted(params)}, the net "
                         f"{sorted(layers)}")
    with torch.no_grad():
        for name, lin in layers.items():
            for dst, src in ((lin.weight, np.asarray(params[name]["kernel"]).T),
                             (lin.bias, params[name]["bias"])):
                src = torch.from_numpy(np.array(src, np.float32))
                if src.shape != dst.shape:
                    raise ValueError(f"{name}: flax shape {tuple(src.shape)}, "
                                     f"the net's {tuple(dst.shape)}")
                dst.copy_(src)
    return net


def train_cloned_policy(
    draws: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 2000,
    batch: int = 256,
    lr: float = 1e-3,
    err_range: float = 30.0,
    params: Optional[dict] = None,
    device=None,
    graphs: bool = True,
) -> WalkPolicyNet:
    """Regression-train the MLP on the expert; returns the net.

    ``draws`` are the sampled yaw errors, ``(num_steps, batch, 1)`` in
    [-err_range, err_range]; without them they are drawn uniformly from
    ``generator`` on the device.  ``params`` (a flax tree) sets the start;
    without it the net starts from a flax-style init drawn from
    ``generator``.  Runs on ``device`` (CUDA unless ``device="cpu"``).
    On CUDA the steps after the first replay one CUDA graph;
    ``graphs=False`` runs them eagerly, bit for bit the same (both take
    Adam's capturable form there)."""
    dev = resolve_device(device)
    use_full_fp32()
    net = WalkPolicyNet(generator=generator if params is None else None,
                        device=dev)
    if params is not None:
        load_flax_params(net, params)
    if draws is None:
        draws = torch.rand((num_steps, batch, 1), generator=generator,
                           device=dev) * (2 * err_range) - err_range
    draws = torch.as_tensor(draws, dtype=torch.float32).to(dev)
    if draws.shape != (num_steps, batch, 1):
        raise ValueError(f"draws have shape {tuple(draws.shape)}, not "
                         f"{(num_steps, batch, 1)}")
    cuda = dev.type == "cuda"
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, capturable=cuda)

    def step(e):
        target = expert_action(e[:, 0])
        loss = torch.mean(torch.square(net(e) - target))
        loss.backward()
        opt.step()

    if not (cuda and graphs):
        for e in draws:
            opt.zero_grad(set_to_none=True)
            step(e)
        return net
    # the first step eagerly on a side stream (it makes Adam's state and
    # loads every kernel), then one step captured and replayed for the rest
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        opt.zero_grad(set_to_none=True)
        step(draws[0])
    current.wait_stream(side)
    static = draws[0].clone()
    opt.zero_grad(set_to_none=True)   # the capture's backward makes them
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()   # a collection inside a capture may free another graph
    try:
        with torch.cuda.graph(graph):
            step(static)
    finally:
        if collecting:
            gc.enable()
    for e in draws[1:]:
        static.copy_(e)
        graph.replay()
    return net


def cloned_lift_angles(net: WalkPolicyNet, yaw_error_deg: float):
    """Inference shim for the walk loop (udp_walk_ai.py:42-43)."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        out = net(torch.tensor([[yaw_error_deg]], dtype=torch.float32,
                               device=dev)).cpu()
    n, y = float(out[0, 0]), float(out[0, 1])
    return (
        float(np.clip(n, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)),
        float(np.clip(y, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)),
    )
