"""Quaternion and orientation helpers (port of
``opendog_tpu/physics/spatial.py:30-138``).

Quaternions are wxyz, unit norm, rotating a vector from the local frame into
the world frame; every function works on the trailing axis and broadcasts
over leading batch axes.
"""
from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis, written out as ``jnp.cross`` is."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a (x) b (both wxyz)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (local -> world)."""
    qv = q[..., 1:]
    qw = q[..., 0:1]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (local -> world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


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
