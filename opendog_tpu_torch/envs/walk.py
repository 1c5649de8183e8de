"""Walk / turn task environments for the OpenDOG robot (8 DoF).

Port of ``opendog_tpu/envs/walk.py`` (the reference's Gymnasium envs as
pure functions), over a leading env axis:
  * ``WalkEnv`` (variant="v0")  -- ``environments/WalkEnvironment.py``
  * ``WalkEnv`` (variant="gpu") -- ``environments/walk_environment_gpu.py``
    (adds angular-vel tracking and feet-air-time rewards, torque /
    vertical-vel costs, relaxed termination)
  * ``TurnEnv``                 -- ``environments/TurnEnvironment.py`` with
    the two-pattern diagonal gait table of ``rewards/TurnRewwardCalc.py``

The JAX package's documented deviations hold here too: the gait machine
advances once per step, and contact is the physics step's active-contact
flag.  A reset takes :class:`WalkResetDraws`, the unit draws of the JAX
reset's two keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..physics import State, Terrain, dynamics, spatial
from ..rewards import common
from .base import Transition

# Diagonal-gait pattern tables, feet ordered [FL, FR, BL, BR]
# (walk_environment_reward_calc.py:54-63, TurnRewwardCalc.py:24-27).
WALK_PATTERNS = np.array([
    [True, True, True, True],
    [True, True, False, True],
    [True, False, False, True],
    [True, False, True, True],
    [True, True, True, True],
    [True, True, True, False],
    [False, True, True, False],
    [True, True, True, True],
])
TURN_PATTERNS = np.array([
    [False, True, True, False],
    [True, False, False, True],
])

# Reward/cost weights (walk_environment_reward_calc.py:28-51).
REWARD_WEIGHTS = dict(
    linear_vel_tracking=1.5,
    angular_vel_tracking=0.001,
    healthy=0.015,
    feet_airtime=0.2,
    diagonal_gait_reward=3.0,
)
COST_WEIGHTS = dict(
    cost_distance=5.0,
    torque=0.0001,
    vertical_vel=2.0,
    action_rate=0.01,
    default_joint_position=0.1,
)

OBS_SCALE = dict(  # walk_environment_reward_calc.py:76-82
    linear_velocity=2.0, angular_velocity=0.25, dofs_position=1.0,
    dofs_velocity=0.05,
)


@dataclass
class WalkResetDraws:
    """Unit draws of a batch of resets: ``qpos_u`` (B, nq) U[0, 1) for the
    qpos noise, ``vel_u`` (B, 3) U[0, 1) for the desired velocity (the JAX
    reset's ``k1`` and ``k2``)."""

    qpos_u: torch.Tensor
    vel_u: torch.Tensor


@dataclass
class WalkEnvState:
    physics: State
    gait: common.GaitState
    step_count: torch.Tensor   # (B,) int32
    last_action: torch.Tensor  # (B, nu)
    desired_vel: torch.Tensor  # (B, 3)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class WalkEnv:
    """Walk env on the OpenDOG model, over a leading env axis.

    Action (B, 8) in [-1, 1], linearly mapped onto the actuator ctrlrange
    (the reference's ScaleActionWrapper).  Observation (B, 33): scaled
    [lin vel(3), ang vel(3), desired vel(3), joint pos dev(8), joint
    vel(8), last action(8)] clipped to +-100 (WalkEnvironment.py:115-136).
    """

    def __init__(self, model, variant: str = "v0",
                 patterns: np.ndarray = WALK_PATTERNS,
                 max_episode_time: float = 15.0, frame_skip: int = 10,
                 reset_noise_scale: float = 0.02,
                 desired_vel_min=(0.5, 0.0, 0.0),
                 desired_vel_max=(1.0, 0.0, 0.0),
                 terrain: Optional[Terrain] = None):
        if variant not in ("v0", "gpu", "turn"):
            raise ValueError(f"unknown walk variant {variant!r}")
        dev = model.device
        self.model = model
        self.variant = variant
        self.patterns = torch.as_tensor(
            patterns if variant != "turn" else TURN_PATTERNS,
            dtype=torch.bool, device=dev)
        self.frame_skip = frame_skip
        self.dt = model.timestep * frame_skip  # 0.02 s (50 Hz)
        self.max_steps = int(max_episode_time / self.dt)  # 750
        self.reset_noise_scale = reset_noise_scale
        self.desired_vel_min = _f32(desired_vel_min, dev)
        self.desired_vel_max = _f32(desired_vel_max, dev)
        self._noise_lo = _f32(-reset_noise_scale, dev)
        self._noise_hi = _f32(reset_noise_scale, dev)
        self.terrain = terrain
        self.nu = model.nu
        self.action_dim = model.nu
        key_id = model.key_id("home")
        self.home_qpos = model.key_qpos[key_id].clone()
        self.home_ctrl = model.key_ctrl[key_id].clone()
        cr = model.actuator_ctrlrange
        self._lo, self._hi = cr[:, 0].clone(), cr[:, 1].clone()
        # the reference compares qpos[7:] against key_ctrl directly
        # (WalkEnvironment.py:106,116; actuator order != joint order in
        # our_robot.xml, reproduced faithfully)
        self.default_joint_pos = self.home_ctrl
        self.obs_size = 3 + 3 + 3 + self.nu + self.nu + self.nu

    # ------------------------------------------------------------------
    def draw_reset(self, generator: Optional[torch.Generator],
                   n: int) -> WalkResetDraws:
        dev = self.model.device
        return WalkResetDraws(
            qpos_u=torch.rand((n, self.model.nq), generator=generator,
                              device=dev),
            vel_u=torch.rand((n, 3), generator=generator, device=dev))

    def scale_action(self, action: torch.Tensor) -> torch.Tensor:
        lo, hi = self._lo, self._hi
        return lo + (torch.clamp(action, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)

    def _obs(self, state: WalkEnvState) -> torch.Tensor:
        qpos, v = state.physics.qpos, state.physics.qvel
        q, qd = qpos[..., 7:], v[..., 6:]
        obs = torch.cat([
            v[..., :3] * OBS_SCALE["linear_velocity"],
            v[..., 3:6] * OBS_SCALE["angular_velocity"],
            state.desired_vel * OBS_SCALE["linear_velocity"],
            (q - self.default_joint_pos) * OBS_SCALE["dofs_position"],
            qd * OBS_SCALE["dofs_velocity"],
            state.last_action,
        ], dim=-1)
        return torch.clamp(obs, -100.0, 100.0)

    def _noisy_home(self, qpos_u: torch.Tensor) -> torch.Tensor:
        noise = common.uniform_range(qpos_u, self._noise_lo, self._noise_hi)
        qpos = self.home_qpos + noise
        return torch.cat([qpos[..., :3],
                          spatial.quat_normalize(qpos[..., 3:7]),
                          qpos[..., 7:]], dim=-1)

    # ------------------------------------------------------------------
    def reset(self, draws: WalkResetDraws):
        qpos = self._noisy_home(draws.qpos_u)
        B = qpos.shape[:-1]
        physics = State(qpos=qpos, qvel=qpos.new_zeros(B + (self.model.nv,)),
                        time=qpos.new_zeros(B))
        state = WalkEnvState(
            physics=physics,
            gait=common.GaitState.init(B, qpos.device),
            step_count=torch.zeros(B, dtype=torch.int32, device=qpos.device),
            last_action=qpos.new_zeros(B + (self.nu,)),
            desired_vel=common.sample_desired_vel(
                draws.vel_u, self.desired_vel_min, self.desired_vel_max),
        )
        return state, self._obs(state)

    # ------------------------------------------------------------------
    def step(self, state: WalkEnvState, action: torch.Tensor):
        ctrl = self.scale_action(action)
        physics, info = dynamics.step(self.model, state.physics, ctrl,
                                      self.terrain,
                                      n_substeps=self.frame_skip)
        fw, fb, in_contact = dynamics.foot_contact_summary(self.model,
                                                           info.contact)
        qpos, qvel = physics.qpos, physics.qvel
        quat = qpos[..., 3:7]

        # --- stateful gait rewards ---
        r_gait, gait = common.diagonal_gait_reward(
            state.gait, in_contact, qvel[..., 0], self.patterns)
        feet_force_norm = torch.linalg.norm(fb, dim=-1)
        r_air, gait = common.feet_air_time_reward(
            gait, feet_force_norm, self.dt, state.desired_vel[..., :2])

        r_track = common.linear_velocity_tracking(
            state.desired_vel[..., :2], qvel[..., :2], qpos[..., 0])
        r_safe = common.safe_range_reward(quat)
        q_joints = qpos[..., 7:]
        qfrc_act = info.qfrc_actuator[..., 6:]
        c_default = common.default_joint_position_cost(
            q_joints, self.default_joint_pos)
        c_rate = common.action_rate_cost(state.last_action, action)

        if self.variant == "v0":
            positives = (
                r_track * REWARD_WEIGHTS["linear_vel_tracking"]
                + r_safe * REWARD_WEIGHTS["healthy"]
                + r_gait * REWARD_WEIGHTS["diagonal_gait_reward"])
            costs = (
                c_default * COST_WEIGHTS["default_joint_position"]
                + c_rate * COST_WEIGHTS["action_rate"]
                + torch.abs(qpos[..., 1]))  # y_cost, unweighted
        elif self.variant == "gpu":
            r_ang = common.angular_velocity_tracking(
                state.desired_vel[..., 2], qvel[..., 5])
            positives = (
                r_track * REWARD_WEIGHTS["linear_vel_tracking"]
                + r_safe * REWARD_WEIGHTS["healthy"]
                + r_ang * REWARD_WEIGHTS["angular_vel_tracking"]
                + r_gait * REWARD_WEIGHTS["diagonal_gait_reward"]
                + r_air * REWARD_WEIGHTS["feet_airtime"])
            costs = (
                common.torque_cost(qfrc_act) * COST_WEIGHTS["torque"]
                + c_rate * COST_WEIGHTS["action_rate"]
                + torch.square(qvel[..., 2]) * COST_WEIGHTS["vertical_vel"]
                + c_default * COST_WEIGHTS["default_joint_position"])
        else:  # turn (TurnEnvironment.py + TurnRewwardCalc weights)
            positives = r_safe * 0.015 + r_gait * 3.0 + r_air * 0.2
            costs = c_default * 0.1
        reward = torch.clamp(positives - costs, min=0.0)

        state_vec = torch.cat([qpos, qvel], dim=-1)
        healthy = common.is_healthy(quat, state_vec)
        if self.variant == "gpu":
            # relaxed termination (walk_environment_gpu.py:61-63)
            terminated = (~healthy) & (~(qvel[..., 0] < 0.5))
        else:
            terminated = ~healthy
        step_count = state.step_count + 1
        truncated = step_count >= self.max_steps

        new_state = WalkEnvState(physics=physics, gait=gait,
                                 step_count=step_count, last_action=action,
                                 desired_vel=state.desired_vel)
        trans = Transition(
            obs=self._obs(new_state), reward=reward, terminated=terminated,
            truncated=truncated,
            info=dict(
                x_position=qpos[..., 0],
                y_position=qpos[..., 1],
                distance_from_origin=torch.linalg.norm(qpos[..., :2],
                                                       dim=-1),
                patterns_matches=r_gait,
                linear_vel_tracking_reward=r_track,
                reward_ctrl=common.torque_cost(qfrc_act),
                paw_contact_forces=fb,
                feet_in_contact=in_contact,
            ),
        )
        return new_state, trans


def TurnEnv(model, **kw):
    """Turning task (TurnEnvironment.py:35-44)."""
    return WalkEnv(model, variant="turn", **kw)

