# Frozen copy of opendog_tpu_torch/physics/spatial.py at commit 9b29168 (the benchmark's reference:
# later changes to the program do not reach it).  Imports rewritten only.
"""Spatial algebra and rotation helpers (port of
``opendog_tpu/physics/spatial.py``).

Quaternions are wxyz, unit norm, rotating a vector from the local frame into
the world frame.  Spatial (6D) motion vectors are ``[omega; v_o]`` and force
vectors ``[torque_o; force]`` about one common origin.  Every function works
on the trailing axes and broadcasts over leading batch axes.
"""
from __future__ import annotations

import functools

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis, written out as ``jnp.cross`` is."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity quaternion, made once per dtype and device (so that a
    call copies no host data, as a CUDA graph capture requires) and shared:
    expand it, do not write to it."""
    return _quat_identity(dtype, torch.device("cpu" if device is None
                                              else device))


@functools.lru_cache(maxsize=None)
def _quat_identity(dtype, device) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# Quaternions of the op-graph step (port of spatial.py:49-116)
# ---------------------------------------------------------------------------


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """The conjugate (w, -x, -y, -z): the JAX package multiplies by a
    constant sign vector, here the vector part is negated (the same bits,
    and no constant made from host data)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by the inverse of q (world -> local)."""
    return quat_rotate(quat_conj(q), v)


def quat_exp(w: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Exponential map: rotation vector w (axis*angle) -> quaternion."""
    angle = torch.linalg.norm(w, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sinc-safe: sin(half)/angle -> 0.5 as angle -> 0
    k = torch.where(angle > eps,
                    torch.sin(half) / torch.clamp(angle, min=eps),
                    torch.full_like(angle, 0.5))
    return quat_normalize(torch.cat([torch.cos(half), w * k], dim=-1))


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
    """Integrate orientation with body-frame angular velocity (MuJoCo
    free-joint convention: rotational qvel of a free joint is expressed in
    the child body frame)."""
    return quat_normalize(quat_mul(q, quat_exp(omega_local * dt)))


# ---------------------------------------------------------------------------
# 3D helpers and spatial (6D) algebra at a common origin (spatial.py:146-209).
# Motion = [omega; v_o], force = [torque_o; force].
# ---------------------------------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def spatial_inertia_at_origin(mass: torch.Tensor, com: torch.Tensor,
                              inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the reference origin.

    ``inertia_com`` is the 3x3 rotational inertia about the body COM in
    world axes; ``com`` the world-frame COM relative to the origin.
    I = [[I_c - m cx cx, m cx], [-m cx, m 1]] with cx = skew(com)."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    top_left = inertia_com - m * (cx @ cx)
    top_right = m * cx
    bot_left = -m * cx
    bot_right = (m * eye).expand(cx.shape)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product  v x m  (both [omega; v_o])."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, mv) + _cross(vo, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product  v x* f  (f = [torque_o; force])."""
    w, vo = v[..., :3], v[..., 3:]
    tau, frc = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, tau) + _cross(vo, frc), _cross(w, frc)],
                     dim=-1)


def point_velocity(spatial_vel: torch.Tensor,
                   point: torch.Tensor) -> torch.Tensor:
    """Linear velocity of the body-fixed point at world position ``point``
    given the body spatial velocity at the origin."""
    w, vo = spatial_vel[..., :3], spatial_vel[..., 3:]
    return vo + _cross(w, point)
