"""Canonical trot-distillation setups for the built-in robots.

Port of ``opendog_tpu/rl/distill_zoo.py``: one place for the (cost, gait
reference, observation, network) recipe of the walking and
command-conditioned students, so that tests, scripts and apps rebuild the
exact policy around a saved ``student.msgpack``, and :func:`load_student`,
which deploys one on the port (read by :mod:`.student_io`, no flax).

The ``engine`` of a setup's MPPI config takes the port's names: ``"ops"``
(the op-graph step; the JAX package's default ``"xla"``) or ``"kernel"``
(the substep kernel; JAX ``"pallas"``).  A setup's network takes the
observation of ``obs_fn`` plus the previous control (``nu``) plus the
command (3, command setups only): the layout every committed student was
trained on (``make_distiller(with_prev_ctrl=True)``).
"""
from __future__ import annotations

import copy
import math
from dataclasses import fields, replace
from typing import NamedTuple

import numpy as np
import torch

from ..assets import load_go1, load_opendog
from ..device import resolve_device
from ..solvers import MPPIConfig, costs
from . import student_io
from .networks import MLPActorCritic, load_flax_params


class TrotDistillSetup(NamedTuple):
    model: object
    cost: object
    u_ref: object          # (t) or (t, cmd) -> ctrl, batch-first
    obs_fn: object         # (qpos, qvel, t) -> obs (phase included)
    net: MLPActorCritic
    mppi_config: MPPIConfig
    z_band: tuple          # healthy trunk-height band
    # JSON-serialisable fingerprint of the gait / cost recipe.  A saved
    # student deploys as net(obs) + u_ref and is valid only with the u_ref
    # it was trained against: committed artifacts carry this in
    # metrics.json, and a test pins it against the current defaults.
    recipe: dict = None


def _jsonable(v):
    """Recipe values in their JSON round-trip form (tuples to lists,
    recursively), so an artifact's recipe compares equal to the defaults
    after a json load (amp_knots is a tuple of pairs)."""
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return float(v)


def _cost_params(pc: costs.TrotCostParams) -> dict:
    return {f.name: _jsonable(getattr(pc, f.name)) for f in fields(pc)}


def _obs_fn(period: float):
    """The trot student's observation: trunk height and attitude, joint
    angles, scaled velocities and the gait phase, batch-first."""

    def obs_fn(qpos, qvel, t):
        phase = 2.0 * math.pi * t / period
        return torch.cat([
            qpos[..., 2:7],
            qpos[..., 7:],
            qvel[..., :6] * 0.25,
            qvel[..., 6:] * 0.1,
            torch.sin(phase)[..., None],
            torch.cos(phase)[..., None],
        ], dim=-1)

    return obs_fn


def trot_distill_setup(robot: str = "go1", engine: str = "ops",
                       pc_overrides=None, gait_center=None,
                       device=None) -> TrotDistillSetup:
    """The configuration that produced runs/distill_<robot>/, on
    ``device`` (CUDA unless the caller names another).

    ``pc_overrides`` replaces TrotCostParams fields; ``gait_center`` =
    (thigh_rad, knee_rad) recentres the gait reference away from the
    keyframe home.  OpenDOG's home thigh (2.356 rad) sits at the bottom of
    its ctrlrange [2.36, 2.8], so a home-centred reference loses the
    backward half of its swing to the clamp; OpenDOG therefore defaults
    ``gait_center`` to (2.58, -1.5), the winner of the JAX package's
    sweep."""
    device = resolve_device(device)
    if robot == "go1":
        model = load_go1("flat", device=device)
        pc = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
        z_band = (0.12, 0.45)
    elif robot == "opendog":
        model = load_opendog("flat", device=device)
        # full-range thigh swing around mid-range, low knee lift, 0.4 s
        # period, 0.28 m/s
        pc = costs.TrotCostParams(desired_vel_xy=(0.28, 0.0),
                                  target_height=0.0703, thigh_amp=0.22,
                                  knee_lift=0.12, w_height=80.0)
        if gait_center is None:
            gait_center = (2.58, -1.5)
        z_band = (0.035, 0.12)
    else:
        raise ValueError(robot)
    if pc_overrides:
        pc = replace(pc, **pc_overrides)
    home_j = model.numpy("key_qpos")[0][7:].copy()
    if gait_center is not None:
        if robot != "opendog":
            raise ValueError("gait_center is wired for the 8-DoF layout")
        thigh_c, knee_c = gait_center
        home_j[np.array([0, 2, 4, 6])] = thigh_c
        home_j[np.array([1, 3, 5, 7])] = knee_c
    cost = costs.trot_cost(model, pc, home_j, legs=robot)
    u_ref = costs.trot_gait_ref(model, pc, home_j, legs=robot)
    net = MLPActorCritic(model.nq + model.nv + model.nu, model.nu,
                         hidden=(512, 256), squash_mean=False, device=device)
    mcfg = MPPIConfig(horizon=25, num_samples=512, n_substeps=2,
                      rollout_dt=0.01, noise_sigma=0.10, temperature=0.2,
                      engine=engine)
    recipe = dict(
        robot=robot,
        cost_params=_cost_params(pc),
        gait_center=(list(gait_center) if gait_center is not None
                     else None),
        noise_sigma=float(mcfg.noise_sigma),
        horizon=int(mcfg.horizon),
    )
    return TrotDistillSetup(model, cost, u_ref, _obs_fn(pc.period_s), net,
                            mcfg, z_band, recipe)


def cmd_distill_setup(robot: str = "go1", engine: str = "ops",
                      device=None) -> TrotDistillSetup:
    """Command-conditioned variant of :func:`trot_distill_setup` (BASELINE
    config 5, the velocity-command curriculum): the cost is
    ``costs.trot_cost_cmd`` (a trailing ``(vx, vy, yaw_target)`` per lane)
    and the reference ``costs.trot_gait_ref_cmd`` scales the gait with the
    command, so the student's residual stays small across the family.

    Go1: quadrature knee lift (lift_phase pi/2; the open-loop reference
    then walks at a speed set by its amplitude), heading weight 15 (the
    anchored expert otherwise under-steers), the calibrated affine speed
    law (amp_v0 0.16) and differential-stride steering (turn_gain 1.2).
    OpenDOG: the sweep's gait centre with the opposite quadrature
    (-pi/2), heading weight 22, the piecewise-linear speed law measured
    open loop on the kernel plant (amp_knots), steering 1.2."""
    base = trot_distill_setup(robot, engine=engine, device=device)
    model = base.model
    if robot == "go1":
        pc = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265,
                                  lift_phase=float(np.pi / 2),
                                  thigh_amp=0.19,
                                  w_heading=15.0,
                                  amp_v0=0.16,
                                  turn_gain=1.2)
        home_j = model.numpy("key_qpos")[0][7:]
    elif robot == "opendog":
        pc = costs.TrotCostParams(desired_vel_xy=(0.28, 0.0),
                                  target_height=0.0703,
                                  thigh_amp=0.26, knee_lift=0.35,
                                  w_height=80.0, w_heading=22.0,
                                  lift_phase=float(-np.pi / 2),
                                  amp_knots=((0.0, 0.0),
                                             (0.0274, 0.18),
                                             (0.0509, 0.3),
                                             (0.0821, 0.45),
                                             (0.1212, 0.6),
                                             (0.1371, 0.9),
                                             (0.2042, 1.05)),
                                  turn_gain=1.2)
        home_j = model.numpy("key_qpos")[0][7:].copy()
        home_j[np.array([0, 2, 4, 6])] = 2.58
        home_j[np.array([1, 3, 5, 7])] = -1.5
    else:
        raise ValueError(robot)
    cost = costs.trot_cost_cmd(model, pc, home_j, legs=robot)
    u_ref = costs.trot_gait_ref_cmd(model, pc, home_j, legs=robot)
    net = MLPActorCritic(base.net.obs_dim + 3, model.nu, hidden=(512, 256),
                         squash_mean=False, device=model.device)
    recipe = dict(
        base.recipe, command_conditioned=True,
        command=["vx", "vy", "yaw_target"],
        u_ref="trot_gait_ref_cmd",
        cost_params=_cost_params(pc))
    return base._replace(cost=cost, u_ref=u_ref, net=net, recipe=recipe)


def normalize_recipe(rec: dict) -> dict:
    """Fills the cost_params fields that TrotCostParams gained after an
    artifact was trained with their defaults: an absent field and a
    default-valued one give the same cost, so recipe pins survive purely
    additive schema growth.  Drift from a default still fails a pin."""
    rec = dict(rec)
    cp = dict(rec.get("cost_params", {}))
    for k, v in _cost_params(costs.TrotCostParams()).items():
        cp.setdefault(k, v)
    rec["cost_params"] = cp
    return rec


def load_student(path: str, setup: TrotDistillSetup, command_dim: int = 0):
    """Restores a student saved by the JAX package's scripts/distill_walk.py
    (or the command curriculum, scripts/distill_cmd.py, with
    ``command_dim > 0``) and returns the deployed policy, batch-first:
    ``policy(qpos, qvel, t, prev_ctrl[, cmd]) -> ctrl`` = clip(net(obs ++
    (prev - home) [++ cmd]) + u_ref(t[, cmd])) on the setup's device."""
    m = setup.model
    rng = m.actuator_ctrlrange
    lo, hi = rng[:, 0], rng[:, 1]
    home_ctrl = torch.clamp(m.key_ctrl[0], lo, hi)
    net = copy.deepcopy(setup.net)
    want = m.nq + m.nv + m.nu + command_dim
    if net.obs_dim != want:
        raise ValueError(f"the setup's network takes {net.obs_dim} inputs, "
                         f"a student with command_dim={command_dim} {want}")
    load_flax_params(net, student_io.load_params(path))
    net.eval()
    ref_cmd = costs.ref_takes_cmd(setup.u_ref)

    def policy(qpos, qvel, t, prev_ctrl, cmd=None):
        obs = torch.cat([setup.obs_fn(qpos, qvel, t), prev_ctrl - home_ctrl],
                        dim=-1)
        if command_dim:
            obs = torch.cat([obs, cmd], dim=-1)
        with torch.no_grad():
            mean = net(obs, value=False)[0]
        u_ref = setup.u_ref(t, cmd) if ref_cmd else setup.u_ref(t)
        return torch.clamp(mean + u_ref, lo, hi)

    return policy
