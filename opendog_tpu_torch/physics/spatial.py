"""Orientation helpers (port of ``opendog_tpu/physics/spatial.py:119-138``)."""
from __future__ import annotations

import torch


def quat_to_ypr(quat: torch.Tensor):
    """(yaw, pitch, roll) — exact formula parity with the reference's
    ``quat_to_ypr`` (sim2real/train.py:110-118)."""
    q0, q1, q2, q3 = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    sinr_cosp = 2 * (q0 * q1 + q2 * q3)
    cosr_cosp = 1 - 2 * (q1 * q1 + q2 * q2)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = torch.clamp(2 * (q0 * q2 - q3 * q1), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2 * (q0 * q3 + q1 * q2)
    cosy_cosp = 1 - 2 * (q2 * q2 + q3 * q3)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return yaw, pitch, roll


def euler_from_quat(quat: torch.Tensor):
    """(roll, pitch, yaw) — parity with the reference reward library's
    ``euler_from_quaternion`` (rewards/walk_environment_reward_calc.py:372-390)."""
    yaw, pitch, roll = quat_to_ypr(quat)
    return roll, pitch, yaw
