"""Shared reward and cost primitives with explicit carried state.

Port of ``opendog_tpu/rewards/common.py`` (the reference's reward
calculators, ``Code/mujoco/rewards/walk_environment_reward_calc.py``).  The
JAX functions are written for one env and vmapped; here each takes the
env axis (any leading axes) first.  Every stateful mechanism (the
diagonal-gait pattern machine, the feet-air-time filter) is a (state,
inputs) -> (reward, state') transition over :class:`GaitState`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..physics import spatial

DEG15 = float(np.deg2rad(15))


@dataclass
class GaitState:
    """Carried state of the stateful gait rewards
    (walk_environment_reward_calc.py:54-69,91-92,236-255), env axis first."""

    pattern_index: torch.Tensor        # (...,) int32
    consecutive_matches: torch.Tensor  # (...,) int32
    feet_air_time: torch.Tensor        # (..., 4) float32
    last_contacts: torch.Tensor        # (..., 4) bool

    @staticmethod
    def init(batch_shape=(), device=None) -> "GaitState":
        shape = tuple(batch_shape)
        return GaitState(
            pattern_index=torch.zeros(shape, dtype=torch.int32,
                                      device=device),
            consecutive_matches=torch.zeros(shape, dtype=torch.int32,
                                            device=device),
            feet_air_time=torch.zeros(shape + (4,), dtype=torch.float32,
                                      device=device),
            last_contacts=torch.zeros(shape + (4,), dtype=torch.bool,
                                      device=device),
        )


def diagonal_gait_reward(gait: GaitState, feet_contact: torch.Tensor,
                         forward_vel: torch.Tensor, patterns: torch.Tensor,
                         min_vel: float = 0.5):
    """Pattern-machine gait reward (walk_environment_reward_calc.py:
    203-234).  ``feet_contact`` (..., 4) bool in [FL, FR, BL, BR] order,
    ``patterns`` (P, 4) bool on the same device.  Matching the expected
    contact pattern while moving at >= ``min_vel`` advances the machine
    and pays ``consecutive_matches`` (incremented by P per match); any
    miss resets.  Returns (reward, gait')."""
    P = patterns.shape[0]
    expected = patterns[gait.pattern_index.long()]
    matches = (torch.all(feet_contact == expected, dim=-1)
               & (forward_vel >= min_vel))
    zero = torch.zeros_like(gait.consecutive_matches)
    new_consecutive = torch.where(matches, gait.consecutive_matches + P, zero)
    reward = torch.where(matches, new_consecutive, zero).to(torch.float32)
    new_index = torch.where(matches, (gait.pattern_index + 1) % P,
                            torch.zeros_like(gait.pattern_index))
    return reward, dataclasses.replace(
        gait, pattern_index=new_index.to(torch.int32),
        consecutive_matches=new_consecutive.to(torch.int32))


def feet_air_time_reward(gait: GaitState, feet_force_norm: torch.Tensor,
                         dt: float, desired_vel_xy: torch.Tensor):
    """Air-time reward with contact filtering
    (walk_environment_reward_calc.py:236-255)."""
    curr_contact = feet_force_norm > 1.0
    contact_filter = curr_contact | gait.last_contacts
    first_contact = (gait.feet_air_time > 0.0) * contact_filter
    air_time = gait.feet_air_time + dt
    reward = torch.sum((air_time - 1.0) * first_contact, dim=-1)
    reward = reward * (torch.linalg.norm(desired_vel_xy, dim=-1) > 0.1)
    air_time = air_time * (~contact_filter)
    return reward, dataclasses.replace(gait, feet_air_time=air_time,
                                       last_contacts=curr_contact)


# ---------------------------------------------------------------------------
# stateless pieces
# ---------------------------------------------------------------------------


def linear_velocity_tracking(desired_vel_xy, vel_xy, pos_x,
                             sigma: float = 0.25):
    """exp-kernel tracking, zeroed behind the start line
    (walk_environment_reward_calc.py:169-176)."""
    err = torch.sum(torch.square(desired_vel_xy - vel_xy), dim=-1)
    return torch.where(pos_x > 0, torch.exp(-err / sigma),
                       torch.zeros_like(err))


def angular_velocity_tracking(desired_yaw_rate, yaw_rate,
                              sigma: float = 0.25):
    return torch.exp(-torch.square(desired_yaw_rate - yaw_rate) / sigma)


def safe_range_reward(quat, roll_range: float = DEG15,
                      pitch_range: float = DEG15, yaw_range: float = DEG15,
                      z_top: float = 0.110):
    """Orientation margin reward (walk_environment_reward_calc.py:140-154)."""
    roll, pitch, yaw = spatial.euler_from_quat(quat)

    def margin(a, rng):
        return torch.where(torch.abs(a) > rng, torch.zeros_like(a),
                           rng - torch.abs(a))

    d_r, d_p, d_y = margin(roll, roll_range), margin(pitch, pitch_range), \
        margin(yaw, yaw_range)
    max_d = z_top + roll_range + pitch_range + yaw_range
    return (d_r + d_p + d_y) / max_d


def is_healthy(quat, state_vec, roll_range: float = DEG15,
               pitch_range: float = DEG15, yaw_range: float = DEG15):
    """Orientation health band (walk_environment_reward_calc.py:117-135)."""
    roll, pitch, yaw = spatial.euler_from_quat(quat)
    finite = torch.all(torch.isfinite(state_vec), dim=-1)
    return (finite & (torch.abs(roll) < roll_range)
            & (torch.abs(pitch) < pitch_range)
            & (torch.abs(yaw) < yaw_range))


def projected_gravity(quat, gravity=(0.0, 0.0, -9.81)):
    """The reference's projected-gravity observation: a projection of the
    gravity vector onto the *euler-angle vector* (sic), normalised
    (walk_environment_reward_calc.py:156-166).  The dot product is
    written out over the three constants: no tensor is made from host
    data."""
    roll, pitch, yaw = spatial.euler_from_quat(quat)
    euler = torch.stack([roll, pitch, yaw], dim=-1)
    dot = roll * gravity[0] + pitch * gravity[1] + yaw * gravity[2]
    p = dot[..., None] * euler
    n = torch.linalg.norm(p, dim=-1, keepdim=True)
    return torch.where(n == 0, p, p / torch.clamp(n, min=1e-12))


def default_joint_position_cost(joint_pos, default_pos):
    return torch.sum(torch.square(joint_pos - default_pos), dim=-1)


def action_rate_cost(last_action, action):
    return torch.sum(torch.square(last_action - action), dim=-1)


def torque_cost(torques):
    return torch.sum(torch.square(torques), dim=-1)


def joint_limit_cost(joint_pos, soft_range):
    below = torch.clamp(soft_range[:, 0] - joint_pos, min=0.0)
    above = torch.clamp(joint_pos - soft_range[:, 1], min=0.0)
    return torch.sum(below + above, dim=-1)


def soft_joint_range(ctrlrange: np.ndarray, multiplier: float = 0.9,
                     scale: float = 0.1) -> np.ndarray:
    """Soft joint range used by the limit cost
    (walk_environment_reward_calc.py:96-100: offset = 0.1*(1-0.9)*span)."""
    offset = scale * (1 - multiplier) * (ctrlrange[:, 1] - ctrlrange[:, 0])
    out = np.array(ctrlrange, dtype=np.float64)
    out[:, 0] += offset
    out[:, 1] -= offset
    return out


def uniform_range(u: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """A U[0, 1) draw mapped onto [lo, hi) as ``jax.random.uniform`` maps
    its unit draw: ``max(lo, u * (hi - lo) + lo)`` in float32, with
    ``lo`` and ``hi`` float32 tensors on ``u``'s device."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def sample_desired_vel(u: torch.Tensor, vmin: torch.Tensor,
                       vmax: torch.Tensor) -> torch.Tensor:
    """Desired (vx, vy, yaw rate) from a (..., 3) U[0, 1) draw (the JAX
    function draws it from a key)."""
    return uniform_range(u, vmin, vmax)
