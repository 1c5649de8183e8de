"""Task cost functions for the trajectory-optimization solvers.

Port of ``opendog_tpu/solvers/costs.py:21-181``.  A cost is a per-step
function ``cost(state, ctrl, prev_ctrl) -> cost`` that works batch-first:
``state.qpos`` (K, nq), ``state.qvel`` (K, nv), ``state.time`` (K,), ``ctrl``
and ``prev_ctrl`` (K, nu) give a (K,) cost; unbatched inputs give a scalar.
Constants live on the model's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..physics import State, spatial


@dataclass(frozen=True)
class TrackingCostParams:
    """Quadratic-ish locomotion cost: track a commanded body velocity while
    staying upright at a target height near the home posture."""

    desired_vel_xy: tuple = (0.5, 0.0)
    desired_yaw_rate: float = 0.0
    target_height: float = 0.265  # Go1 standing height; OpenDOG uses 0.069
    w_vel: float = 10.0
    w_yaw_rate: float = 1.0
    w_height: float = 50.0
    w_upright: float = 20.0
    w_joint_posture: float = 1.0
    w_ctrl_rate: float = 0.5
    w_lateral: float = 2.0


def _const(model, values) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return torch.as_tensor(np.asarray(values, np.float32), device=model.device)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x), dim=-1)


def tracking_cost(model, params: TrackingCostParams, home_joint_qpos):
    """Returns step_cost(state, ctrl, prev_ctrl) for velocity-tracking
    locomotion MPC."""
    desired = _const(model, params.desired_vel_xy)
    home_j = _const(model, home_joint_qpos)

    def step_cost(state: State, ctrl, prev_ctrl):
        qpos, qvel = state.qpos, state.qvel
        roll, pitch, _yaw = spatial.euler_from_quat(qpos[..., 3:7])
        c_vel = params.w_vel * _sq_sum(qvel[..., :2] - desired)
        c_yaw = params.w_yaw_rate * torch.square(
            qvel[..., 5] - params.desired_yaw_rate)
        c_h = params.w_height * torch.square(qpos[..., 2] - params.target_height)
        c_up = params.w_upright * (torch.square(roll) + torch.square(pitch))
        c_post = params.w_joint_posture * _sq_sum(qpos[..., 7:] - home_j)
        c_rate = params.w_ctrl_rate * _sq_sum(ctrl - prev_ctrl)
        c_lat = params.w_lateral * torch.square(qvel[..., 1])
        return c_vel + c_yaw + c_h + c_up + c_post + c_rate + c_lat

    return step_cost


def standing_cost(model, target_height: float, home_joint_qpos):
    """Balance-in-place cost (BASELINE config 1)."""
    p = TrackingCostParams(
        desired_vel_xy=(0.0, 0.0), target_height=target_height,
        w_vel=20.0, w_height=100.0, w_upright=50.0, w_joint_posture=2.0,
    )
    return tracking_cost(model, p, home_joint_qpos)


@dataclass(frozen=True)
class TrotCostParams:
    """Phase-referenced diagonal trot (the MPC analog of the reference's
    phase-conditioned symmetric gait, sim2real/train.py:235-285).  The
    command-conditioned fields of the JAX package (``amp_v0``,
    ``amp_knots``, ``turn_gain``) come with ``trot_cost_cmd`` (ROADMAP M10)."""

    desired_vel_xy: tuple = (0.5, 0.0)
    target_height: float = 0.265
    period_s: float = 0.4
    thigh_amp: float = 0.2       # fore-aft swing amplitude [rad]
    knee_lift: float = 0.35      # swing-leg knee flexion [rad]
    w_gait: float = 8.0
    w_vel: float = 12.0
    w_height: float = 60.0
    w_upright: float = 30.0
    w_lateral: float = 3.0
    w_yaw_rate: float = 2.0
    w_heading: float = 6.0       # hold world heading
    desired_yaw: float = 0.0     # heading target [rad]
    w_ctrl_rate: float = 0.3
    thigh_phase: float = 1.0     # +1: swing-leg thigh rotates forward with s
    lift_phase: float = 0.0      # knee-lift oscillator phase lead [rad]


def trot_cost(model, params: TrotCostParams, home_joint_qpos,
              legs: str = "go1"):
    """Gait-shaped locomotion cost.

    Joint layout per leg: 'go1' = (hip, thigh, knee) x [FR, FL, RR, RL];
    'opendog' = (thigh, knee) x [FL, FR, BL, BR] (qpos order).  Diagonal
    pairs (FR+RL / FL+RR, or FR+BL / FL+BR) alternate by phase."""
    home_j = _const(model, home_joint_qpos)
    desired = _const(model, params.desired_vel_xy)
    if legs == "go1":
        thigh_idx, knee_idx = slice(1, None, 3), slice(2, None, 3)
        # legs order FR, FL, RR, RL -> diagonal pair A = FR, RL
        diag_sign = [1.0, -1.0, -1.0, 1.0]
        knee_dir = -1.0  # knees flex negative
        thigh_dir = -params.thigh_phase  # go1 thigh angle decreases forward
    elif legs == "opendog":  # FL, FR, BL, BR thigh/knee pairs
        thigh_idx, knee_idx = slice(0, None, 2), slice(1, None, 2)
        diag_sign = [-1.0, 1.0, 1.0, -1.0]  # pair A = FR, BL
        knee_dir = -1.0
        thigh_dir = params.thigh_phase
    else:
        raise ValueError(f"unknown leg layout {legs!r}")
    sign = _const(model, diag_sign)
    home_thigh, home_knee = home_j[thigh_idx], home_j[knee_idx]

    def step_cost(state: State, ctrl, prev_ctrl):
        qpos, qvel = state.qpos, state.qvel
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        phase = 2.0 * math.pi * state.time / params.period_s
        s = torch.sin(phase)[..., None]
        sl = torch.sin(phase + params.lift_phase)[..., None]
        swingA = torch.clamp(sl, min=0.0)   # pair A in swing
        swingB = torch.clamp(-sl, min=0.0)
        swing = torch.where(sign > 0, swingA, swingB)
        thigh_ref = home_thigh + thigh_dir * params.thigh_amp * sign * s
        knee_ref = home_knee + knee_dir * params.knee_lift * swing
        joints = qpos[..., 7:]
        c_gait = params.w_gait * (
            _sq_sum(joints[..., thigh_idx] - thigh_ref)
            + _sq_sum(joints[..., knee_idx] - knee_ref)
        )
        c_vel = params.w_vel * _sq_sum(qvel[..., :2] - desired)
        c_h = params.w_height * torch.square(qpos[..., 2] - params.target_height)
        c_up = params.w_upright * (torch.square(roll) + torch.square(pitch))
        c_lat = params.w_lateral * torch.square(qvel[..., 1])
        c_yawr = params.w_yaw_rate * torch.square(qvel[..., 5])
        dyaw = torch.atan2(torch.sin(yaw - params.desired_yaw),
                           torch.cos(yaw - params.desired_yaw))
        c_head = params.w_heading * torch.square(dyaw)
        c_rate = params.w_ctrl_rate * _sq_sum(ctrl - prev_ctrl)
        return (c_gait + c_vel + c_h + c_up + c_lat + c_yawr + c_head
                + c_rate)

    return step_cost
