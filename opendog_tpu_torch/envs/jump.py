"""Jump and landing task environments on the Go1 (12 DoF).

Port of ``opendog_tpu/envs/jump.py``, over a leading env axis:

``JumpEnv``    -- jump-onto-cube task (``environments/JumpEnvironment.py``
                 + ``rewards/jump_environment_reward_calc.py``).
``LandingEnv`` -- landing-from-descent task
                 (``environments/landing_environment.py`` +
                 ``rewards/landing_environment_reward_calc.py``).

The JAX module's documented deviations hold here: the landing weights
that the reference's dict lacks are explicit constants, and its three
undefined costs are the closest defined semantics (feet force clipping,
force imbalance, knee-flexion shortfall).  The box scenes step on the
op-graph physics with box contact.  A reset takes
:class:`~.walk.WalkResetDraws`, the unit draws of the JAX reset's two
keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..physics import State, dynamics, spatial
from ..rewards import common
from .base import Transition
from .walk import WalkResetDraws, _f32

DEG = np.pi / 180.0


@dataclass
class JumpEnvState:
    physics: State
    gait: common.GaitState
    step_count: torch.Tensor
    last_action: torch.Tensor
    desired_vel: torch.Tensor


class JumpEnv:
    """Jump-onto-cube (JumpEnvironment.py).  Action (B, 12) in [-1,1]
    mapped to ctrlrange; obs = [dist-to-cube(2), lin vel(3), v_z, projected
    gravity(3), last action(12)] clipped +-100 (JumpEnvironment.py:99-119)."""

    # jump_environment_reward_calc.py:26-52
    cube_height = 0.5
    cube_position = np.array([1.0, 0.0, 0.5])
    reward_weights = dict(
        height_clearance=0.2, phase_sync=0.8, jump_velocity=1.0,
        landing_precision=3.0, landing_orientation=2.0,
        control_velocity_horizontal=1.0,
    )
    cost_weights = dict(
        collision=1.0, distance_on_liftoff=2.0,
        vertical_velocity_on_landing=1.5, out_of_bounds=3.0,
    )
    tracking_velocity_sigma = 0.45
    desired_vel_min = np.array([1.20, 0.0, 1.20])
    desired_vel_max = np.array([1.25, 0.0, 1.25])
    healthy_range = 20.0 * DEG
    reset_noise_scale = 0.1

    def __init__(self, model, frame_skip: int = 10,
                 max_episode_time: float = 15.0, key_name: str = "home"):
        dev = model.device
        self.model = model
        self.frame_skip = frame_skip
        self.dt = model.timestep * frame_skip
        self.max_steps = int(max_episode_time / self.dt)
        kid = model.key_id(key_name)
        self.home_qpos = model.key_qpos[kid].clone()
        self.home_ctrl = model.key_ctrl[kid].clone()
        cr = model.actuator_ctrlrange
        self._lo, self._hi = cr[:, 0].clone(), cr[:, 1].clone()
        self.nu = model.nu
        self.action_dim = model.nu
        self.obs_size = 2 + 3 + 1 + 3 + self.nu
        self._vel_lo = _f32(self.desired_vel_min, dev)
        self._vel_hi = _f32(self.desired_vel_max, dev)
        self._noise_lo = _f32(-self.reset_noise_scale, dev)
        self._noise_hi = _f32(self.reset_noise_scale, dev)
        self._cube_xy = _f32(self.cube_position[:2], dev)
        # non-foot leg bodies for the collision cost
        # (cfrc_ext_contact_indices [2,3,5,6,8,9,11,12] MuJoCo ids -> ours -1)
        self.collision_bodies = tuple(i - 1 for i in (2, 3, 5, 6, 8, 9, 11, 12))
        self._leg_mask = torch.as_tensor(
            np.isin(np.array(model.geom_body_static), self.collision_bodies),
            device=dev)

    def draw_reset(self, generator: Optional[torch.Generator],
                   n: int) -> WalkResetDraws:
        dev = self.model.device
        return WalkResetDraws(
            qpos_u=torch.rand((n, self.model.nq), generator=generator,
                              device=dev),
            vel_u=torch.rand((n, 3), generator=generator, device=dev))

    def scale_action(self, action):
        lo, hi = self._lo, self._hi
        return lo + (torch.clamp(action, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)

    def _obs(self, state: JumpEnvState):
        qpos, qvel = state.physics.qpos, state.physics.qvel
        obs = torch.cat([
            torch.stack([0.3 - qpos[..., 0], 0.3 - qpos[..., 2]], dim=-1),
            qvel[..., :3] * 2.0,
            qvel[..., 2:3],
            common.projected_gravity(qpos[..., 3:7]),
            state.last_action,
        ], dim=-1)
        return torch.clamp(obs, -100.0, 100.0)

    def reset(self, draws: WalkResetDraws):
        qpos = self.home_qpos + common.uniform_range(
            draws.qpos_u, self._noise_lo, self._noise_hi)
        qpos = torch.cat([qpos[..., :3],
                          spatial.quat_normalize(qpos[..., 3:7]),
                          qpos[..., 7:]], dim=-1)
        B = qpos.shape[:-1]
        physics = State(qpos=qpos, qvel=qpos.new_zeros(B + (self.model.nv,)),
                        time=qpos.new_zeros(B))
        state = JumpEnvState(
            physics=physics, gait=common.GaitState.init(B, qpos.device),
            step_count=torch.zeros(B, dtype=torch.int32, device=qpos.device),
            last_action=qpos.new_zeros(B + (self.nu,)),
            desired_vel=common.sample_desired_vel(draws.vel_u, self._vel_lo,
                                                  self._vel_hi))
        return state, self._obs(state)

    def _feet_and_collision(self, info):
        fw, fb, ic = dynamics.foot_contact_summary(self.model, info.contact)
        # collision proxy: contact on non-foot leg geoms
        ncol = torch.sum(info.contact.in_contact & self._leg_mask, dim=-1)
        return fw, ic, ncol

    def step(self, state: JumpEnvState, action: torch.Tensor):
        ctrl = self.scale_action(action)
        physics, pinfo = dynamics.step(self.model, state.physics, ctrl, None,
                                       n_substeps=self.frame_skip)
        qpos, qvel = physics.qpos, physics.qvel
        fw, ic, ncol = self._feet_and_collision(pinfo)
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])

        dist_to_cube = torch.linalg.norm(self._cube_xy - qpos[..., :2],
                                         dim=-1)
        above = qpos[..., 2] >= self.cube_height
        zero = torch.zeros_like(dist_to_cube)
        w, cw = self.reward_weights, self.cost_weights
        r_prec = torch.where(above, torch.exp(-dist_to_cube), zero) \
            * w["landing_precision"]
        r_orient = torch.exp(-(torch.abs(roll) + torch.abs(pitch)
                               + torch.abs(yaw))) * w["landing_orientation"]
        r_hvel = torch.exp(-torch.linalg.norm(qvel[..., :2], dim=-1)) \
            * w["control_velocity_horizontal"]
        r_clear = torch.clamp(qpos[..., 2] - self.cube_height, min=0.0) \
            * w["height_clearance"]
        # phase sync over the air-time state (diagonal pairs)
        air = state.gait.feet_air_time
        r_phase = -(torch.abs(air[..., 0] - air[..., 1])
                    + torch.abs(air[..., 2] - air[..., 3])) * w["phase_sync"]
        vel_err = torch.sum(torch.square(state.desired_vel - qvel[..., :3]),
                            dim=-1)
        r_jvel = torch.exp(-vel_err / self.tracking_velocity_sigma) \
            * w["jump_velocity"]

        c_lift = torch.where(~above, torch.exp(dist_to_cube), zero) \
            * cw["distance_on_liftoff"]
        c_vland = torch.where(above, torch.square(qvel[..., 2]), zero) \
            * cw["vertical_velocity_on_landing"]
        c_oob = torch.where(dist_to_cube > 1.0, 1.0, 0.0) \
            * cw["out_of_bounds"]
        c_col = ncol.to(torch.float32) * cw["collision"]

        reward = torch.clamp(
            (r_prec + r_orient + r_hvel + r_clear + r_phase + r_jvel)
            - (c_lift + c_vland + c_oob + c_col), min=0.0)

        # update air-time state
        feet_force = torch.linalg.norm(fw, dim=-1)
        _, gait = common.feet_air_time_reward(
            state.gait, feet_force, self.dt, state.desired_vel[..., :2])

        # static_stability termination (jump_environment_reward_calc.py:
        # 140-150): yaw + roll bands only
        finite = torch.all(torch.isfinite(torch.cat([qpos, qvel], dim=-1)),
                           dim=-1)
        terminated = ~(finite & (torch.abs(yaw) <= self.healthy_range)
                       & (torch.abs(roll) <= self.healthy_range))
        step_count = state.step_count + 1
        truncated = step_count >= self.max_steps
        new_state = JumpEnvState(physics=physics, gait=gait,
                                 step_count=step_count, last_action=action,
                                 desired_vel=state.desired_vel)
        return new_state, Transition(
            obs=self._obs(new_state), reward=reward, terminated=terminated,
            truncated=truncated,
            info=dict(x_position=qpos[..., 0], z_position=qpos[..., 2],
                      landing_precision=r_prec, height_clearance=r_clear))


class LandingEnv(JumpEnv):
    """Landing from the ``descent`` keyframe (z=0.6, go1.xml:227) onto the
    platform cube (landing_scene.xml): rewards phase-sync, front-then-back
    contact and even weight distribution; costs impact force, imbalance and
    lack of knee flexion (landing_environment.py:98-110)."""

    # landing_environment_reward_calc.py:35-50 + chosen weights for the
    # reference's missing keys (see module docstring)
    desired_vel_min = np.array([0.5, 0.0, 0.0])
    desired_vel_max = np.array([0.8, 0.0, 0.0])
    healthy_z = (0.22, 0.65)
    healthy_range = 10.0 * DEG
    phase_sync_w = 1.0
    front_then_back_w = 1.0
    weight_distribution_w = 5.0
    max_contact_force = 100.0
    impact_w = 0.01
    imbalance_w = 0.01
    flexion_w = 0.5

    def __init__(self, model, **kw):
        kw.setdefault("key_name", "descent")
        super().__init__(model, **kw)
        self.obs_size = 3 + 3 + 3 + 12 + 12 + 12
        # knee home angle for the flexion cost
        self.knee_home = -1.8
        self._knees = torch.tensor([9, 12, 15, 18], device=model.device)

    def _obs(self, state: JumpEnvState):
        qpos, qvel = state.physics.qpos, state.physics.qvel
        obs = torch.cat([
            qvel[..., :3], qvel[..., 3:6],
            common.projected_gravity(qpos[..., 3:7]),
            qpos[..., 7:] - self.home_qpos[7:],
            qvel[..., 6:],
            state.last_action,
        ], dim=-1)
        return torch.clamp(obs, -100.0, 100.0)

    def step(self, state: JumpEnvState, action: torch.Tensor):
        ctrl = self.scale_action(action)
        physics, pinfo = dynamics.step(self.model, state.physics, ctrl, None,
                                       n_substeps=self.frame_skip)
        qpos, qvel = physics.qpos, physics.qvel
        fw, ic, ncol = self._feet_and_collision(pinfo)
        feet_force = torch.linalg.norm(fw, dim=-1)
        curr = feet_force > 1.0  # [FR, FL, RR, RL]

        front_sync = curr[..., 0] == curr[..., 1]
        rear_sync = curr[..., 2] == curr[..., 3]
        r_phase = torch.where(front_sync & rear_sync, self.phase_sync_w, 0.0)
        front = curr[..., 0] | curr[..., 1]
        rear = curr[..., 2] | curr[..., 3]
        r_ftb = torch.where(front & ~rear, self.front_then_back_w, 0.0)
        avg = torch.mean(feet_force, dim=-1, keepdim=True)
        max_dev = torch.amax(torch.abs(feet_force - avg), dim=-1)
        r_wd = torch.clamp(self.weight_distribution_w - max_dev, min=0.0)

        c_impact = self.impact_w * torch.sum(
            torch.clamp(feet_force - self.max_contact_force, min=0.0),
            dim=-1)
        c_imb = self.imbalance_w * max_dev
        knees = qpos[..., self._knees]
        c_flex = self.flexion_w * torch.sum(
            torch.clamp(knees - self.knee_home, min=0.0), dim=-1) \
            * (qvel[..., 2] < -0.5)

        reward = torch.clamp(
            (r_phase + r_ftb + r_wd) - (c_impact + c_imb + c_flex), min=0.0)

        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        finite = torch.all(torch.isfinite(torch.cat([qpos, qvel], dim=-1)),
                           dim=-1)
        healthy = (finite
                   & (qpos[..., 2] >= self.healthy_z[0])
                   & (qpos[..., 2] <= self.healthy_z[1])
                   & (torch.abs(roll) <= self.healthy_range)
                   & (torch.abs(pitch) <= self.healthy_range)
                   & (torch.abs(yaw) <= self.healthy_range))
        step_count = state.step_count + 1
        new_state = JumpEnvState(physics=physics, gait=state.gait,
                                 step_count=step_count, last_action=action,
                                 desired_vel=state.desired_vel)
        return new_state, Transition(
            obs=self._obs(new_state), reward=reward, terminated=~healthy,
            truncated=step_count >= self.max_steps,
            info=dict(z_position=qpos[..., 2], reward_phase_sync=r_phase,
                      reward_front_then_back=r_ftb,
                      reward_weight_distribution=r_wd))
