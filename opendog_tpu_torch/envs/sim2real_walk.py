"""Sim2real training environments: the custom-PPO pipeline that drove the
physical robot.

Port of ``opendog_tpu/envs/sim2real_walk.py``, over a leading env axis:

``SymWalkEnv``     -- flat-ground phase-conditioned symmetric-gait env
                     (``sim2real/train.py``): a 4-dim policy action
                     expanded to 8 actuators with diagonal mirroring per
                     2-step phase cycle (train.py:235-285), 22-dim state,
                     dense shaped reward with the real-robot-degree-space
                     leg-positioning penalty (train.py:313-392).
``TerrainWalkEnv`` -- heightfield variant (``sim2real/train2.py``): 8-dim
                     action x 50 deg, 12-dim state, one procedural terrain
                     per env and episode (train2.py:203-292), z-stability /
                     step-displacement / low-joint-velocity terms
                     (train2.py:346-397).

Reset cost.  ``SymWalkEnv.reset`` ignores its draws (as the JAX reset
ignores its key): every env starts from the home pose settled for 100
substeps under the home controls.  That settled state is computed once
per env object and device, on one env, and reused, where the JAX rollout
recomputes the same values for every env on every step
(``ppo.py:119-125``).  ``TerrainWalkEnv.reset`` makes one terrain per env
from its :class:`~..physics.terrain.TerrainDraws` (leading env axis) and
settles each env on its own terrain: every row, every call.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..physics import State, Terrain, dynamics, spatial
from ..physics import terrain as terrain_lib
from ..sim2real.calibration import Calibration
from .base import Transition

DEG = np.pi / 180.0


@dataclass
class SymWalkState:
    physics: State
    step_count: torch.Tensor   # (B,) int32 -- drives the gait phase
    last_ctrl: torch.Tensor    # (B, 8) last clipped sim commands (model order)
    prev_x: torch.Tensor       # (B,)
    cum_pos_x: torch.Tensor
    cum_neg_x: torch.Tensor
    prev_net_fwd: torch.Tensor
    settled_z: torch.Tensor    # (B,) trunk z right after the settle
    terrain: Optional[Terrain] = None  # heights (B, nrow, ncol)


@dataclass
class CountDraws:
    """The draws of a reset that draws nothing: ``u`` (B, 0) carries the
    batch size."""

    u: torch.Tensor


class SymWalkEnv:
    """Flat-ground phase-conditioned symmetric walk (sim2real/train.py).

    Actions (B, 4) in [-1,1]: [FR-thigh delta, knee-pair-1 swing, FL-thigh
    delta, knee-pair-2 swing], scaled by 40 deg and expanded: BL thigh
    mirrors FR thigh, BR mirrors FL; in phase 0 the FR/BL knees swing
    antisymmetrically, in phase 1 FL/BR (train.py:243-259).
    """

    # constants -- sim2real/train.py:67-93
    action_dim = 4
    max_steps = 250
    action_amplitude = 40.0 * DEG
    policy_dt = 0.10
    settle_steps = 100
    orient_term = 25.0 * DEG
    orient_pen_thr = 5.0 * DEG
    yaw_pen_thr = 10.0 * DEG
    leg_home_thr_deg = 15.0
    swing_max_dev_deg = 40.0
    leg_penalty = 0.5
    min_fwd_for_backward_check = 0.05
    backward_frac = 0.75

    def __init__(self, model, terrain_mode: bool = False):
        dev = model.device
        self.model = model
        self.cal = Calibration(model)
        self.n_substeps = max(1, int(round(self.policy_dt / model.timestep)))
        home = model.key_id("home")
        self.home_qpos = model.key_qpos[home].clone()
        self.home_ctrl = model.key_ctrl[home].clone()  # model order
        cr = model.actuator_ctrlrange
        self.ctrl_lo, self.ctrl_hi = cr[:, 0].clone(), cr[:, 1].clone()
        self.obs_size = 3 + 8 + 8 + 1 + 2
        cal_index = self.cal.model_actuator_index
        self.qpos_adr = torch.as_tensor(
            model.numpy("actuator_qposadr")[cal_index].astype(np.int64),
            device=dev)
        self.dof_adr = torch.as_tensor(
            model.numpy("actuator_dof")[cal_index].astype(np.int64),
            device=dev)
        c = self.cal.on(dev)
        # calibration (reference) actuator order -> model order
        self.cal_to_model = c["inv"]
        self.cal_index = c["index"]
        self.sim_home_rad = c["sim_home_rad"]
        self.real_home_deg = c["real_home_deg"]
        # swing legs of each phase, calibration leg order [FR, FL, BR, BL]:
        # p0 -> FR, BL; p1 -> FL, BR
        self._swing = torch.tensor([[True, False, False, True],
                                    [False, True, True, False]],
                                   device=dev)
        self._settled = {}

    # ------------------------------------------------------------------
    def draw_reset(self, generator: Optional[torch.Generator],
                   n: int) -> CountDraws:
        return CountDraws(u=torch.empty((n, 0), device=self.model.device))

    def expand_action(self, action: torch.Tensor,
                      phase: torch.Tensor) -> torch.Tensor:
        """(B, 4) policy action + (B,) phase -> (B, 8) clipped sim ctrl in
        *model* actuator order (train.py:235-285)."""
        a = action * self.action_amplitude
        fr_t, k1, fl_t, k2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        is_p0 = phase == 0
        zero = torch.zeros_like(k1)
        deltas_cal = torch.stack([
            fr_t,                                  # FR_tigh
            torch.where(is_p0, k1, zero),          # FR_knee
            fl_t,                                  # FL_tigh
            torch.where(is_p0, zero, k2),          # FL_knee
            fl_t,                                  # BR_tigh (mirrors FL)
            torch.where(is_p0, zero, -k2),         # BR_knee
            fr_t,                                  # BL_tigh (mirrors FR)
            torch.where(is_p0, -k1, zero),         # BL_knee
        ], dim=-1)
        target_cal = self.sim_home_rad + deltas_cal
        target_model = target_cal[..., self.cal_to_model]
        return torch.clamp(target_model, self.ctrl_lo, self.ctrl_hi)

    def _ypr_dev(self, qpos):
        yaw, pitch, roll = spatial.quat_to_ypr(qpos[..., 3:7])
        joint_dev = qpos[..., self.qpos_adr] - self.sim_home_rad
        return torch.stack([yaw, pitch, roll], dim=-1), joint_dev

    def _obs(self, state: SymWalkState) -> torch.Tensor:
        qpos, qvel = state.physics.qpos, state.physics.qvel
        ypr, joint_dev = self._ypr_dev(qpos)
        joint_vel = qvel[..., self.dof_adr]
        # train.py:200-203: progress_norm is 0 or 1; sin(pi*p), cos(pi*p)
        pn = (state.step_count % 2).to(torch.float32)
        return torch.cat([
            ypr, joint_dev, joint_vel, qvel[..., 0:1],
            torch.stack([torch.sin(pn * np.pi), torch.cos(pn * np.pi)],
                        dim=-1),
        ], dim=-1)

    def _start(self, physics: State, terrain: Optional[Terrain]):
        B = physics.qpos.shape[:-1]
        zeros = physics.qpos.new_zeros(B)
        state = SymWalkState(
            physics=physics,
            step_count=torch.zeros(B, dtype=torch.int32,
                                   device=physics.qpos.device),
            last_ctrl=self.home_ctrl.expand(B + (self.model.nu,)).clone(),
            prev_x=physics.qpos[..., 0], cum_pos_x=zeros,
            cum_neg_x=zeros.clone(), prev_net_fwd=zeros.clone(),
            settled_z=physics.qpos[..., 2], terrain=terrain)
        return state, self._obs(state)

    def settled(self) -> State:
        """The home pose settled for ``settle_steps`` substeps under the
        home controls (train.py:218-222: 100 raw mj_steps), on one env:
        computed at the first call on the model's device and kept."""
        dev = self.model.device
        if dev not in self._settled:
            home = State(qpos=self.home_qpos[None],
                         qvel=self.home_qpos.new_zeros((1, self.model.nv)),
                         time=self.home_qpos.new_zeros(1))
            with torch.no_grad():
                st, _ = dynamics.step(self.model, home, self.home_ctrl[None],
                                      None, n_substeps=self.settle_steps)
            self._settled[dev] = st
        return self._settled[dev]

    # ------------------------------------------------------------------
    def reset(self, draws: CountDraws):
        B = draws.u.shape[:-1]
        s = self.settled()
        physics = State(qpos=s.qpos[0].expand(B + s.qpos.shape[-1:]).clone(),
                        qvel=s.qvel[0].expand(B + s.qvel.shape[-1:]).clone(),
                        time=s.time[0].expand(B).clone())
        return self._start(physics, None)

    # ------------------------------------------------------------------
    def _progress(self, state: SymWalkState, qpos):
        dx = qpos[..., 0] - state.prev_x
        cum_pos = state.cum_pos_x + torch.clamp(dx, min=0.0)
        cum_neg = state.cum_neg_x + torch.clamp(-dx, min=0.0)
        net = cum_pos - cum_neg
        return dx, cum_pos, cum_neg, net, net - state.prev_net_fwd

    def _orient(self, ypr, opf):
        def pen(a, thr):
            return torch.where(torch.abs(a) > thr,
                               opf * (torch.abs(a) - thr) ** 2,
                               torch.zeros_like(a))
        yaw, pitch, roll = ypr.unbind(-1)
        return (pen(roll, self.orient_pen_thr)
                + pen(pitch, self.orient_pen_thr)
                + pen(yaw, self.yaw_pen_thr))

    def step(self, state: SymWalkState, action: torch.Tensor):
        phase = state.step_count % 2
        ctrl = self.expand_action(action, phase)
        physics, info = dynamics.step(self.model, state.physics, ctrl, None,
                                      n_substeps=self.n_substeps)
        qpos, qvel = physics.qpos, physics.qvel
        dx, cum_pos, cum_neg, net, dnd = self._progress(state, qpos)

        zero = torch.zeros_like(dx)
        fvx = qvel[..., 0]
        r_fwd = 150.0 * fvx
        r_prog = torch.where(dnd > 0.0005, 15.0 * dnd, zero)
        r_bwd = torch.where(fvx < -0.005, -5.0 * torch.abs(fvx), zero)
        r_alive = 0.05
        r_side = -0.2 * torch.abs(qvel[..., 1])
        r_ypos = -0.1 * torch.abs(qpos[..., 1] - self.home_qpos[1])
        ypr, _ = self._ypr_dev(qpos)
        r_orient = self._orient(ypr, -0.05)
        r_smooth = -0.01 * torch.sum(torch.square(ctrl - state.last_ctrl),
                                     dim=-1)

        # real-degree-space leg positioning penalty (train.py:342-386)
        ctrl_cal = ctrl[..., self.cal_index]
        real_deg = self.cal.sim_rad_to_real_deg(ctrl_cal)
        dev_deg = torch.abs(real_deg - self.real_home_deg)
        # calibration order: FR(0,1) FL(2,3) BR(4,5) BL(6,7)
        leg_dev = dev_deg.reshape(dev_deg.shape[:-1] + (4, 2))
        leg_max = torch.amax(leg_dev, dim=-1)
        leg_at_home = torch.all(leg_dev <= self.leg_home_thr_deg, dim=-1)
        swinging = self._swing[phase.long()]
        swing_too_far = swinging & (leg_max > self.swing_max_dev_deg)
        stance_off = (~swinging) & (~leg_at_home)
        r_legs = -self.leg_penalty * (
            torch.sum(swing_too_far, dim=-1)
            + torch.sum(stance_off, dim=-1)).to(torch.float32)

        reward = (r_fwd + r_prog + r_bwd + r_alive + r_side + r_ypos
                  + r_orient + r_smooth + r_legs)

        bad = ~torch.all(torch.isfinite(torch.cat([qpos, qvel], dim=-1)),
                         dim=-1)
        yaw, pitch, roll = ypr.unbind(-1)
        orient_term = ((torch.abs(roll) > self.orient_term)
                       | (torch.abs(pitch) > self.orient_term)
                       | (torch.abs(yaw) > self.orient_term))
        too_backward = (cum_pos > self.min_fwd_for_backward_check) & (
            cum_neg > self.backward_frac * cum_pos)
        reward = reward + torch.where(bad, -20.0, 0.0)
        reward = torch.where(orient_term & ~bad, reward - 5.0, reward)
        reward = torch.where(too_backward & ~orient_term & ~bad,
                             reward - 5.0, reward)
        terminated = bad | orient_term | too_backward

        step_count = state.step_count + 1
        truncated = step_count >= self.max_steps
        new_state = dataclasses.replace(
            state, physics=physics, step_count=step_count, last_ctrl=ctrl,
            prev_x=qpos[..., 0], cum_pos_x=cum_pos, cum_neg_x=cum_neg,
            prev_net_fwd=net)
        return new_state, Transition(
            obs=self._obs(new_state), reward=reward, terminated=terminated,
            truncated=truncated,
            info=dict(sim_target_rad=ctrl, x_position=qpos[..., 0],
                      phase=phase, real_target_deg=real_deg))


class TerrainWalkEnv(SymWalkEnv):
    """Heightfield walk env (sim2real/train2.py): per-joint 8-dim action,
    12-dim state, one procedural terrain per env and episode."""

    action_dim = 8
    max_steps = 1000
    action_amplitude = 50.0 * DEG      # train2.py:90
    policy_dt = 0.08                   # train2.py:103
    orient_term = 35.0 * DEG           # train2.py:94
    orient_pen_thr = 15.0 * DEG        # train2.py:96
    yaw_pen_thr = 35.0 * DEG           # train2.py:98
    z_coef = 0.25                      # train2.py:100
    backward_frac = 0.85               # train2.py:402

    def __init__(self, model, ideal_z: float = 0.2):
        super().__init__(model)
        self.obs_size = 3 + 8 + 1
        # "ideal" flat-ground spawn height (train2.py:189)
        self.ideal_z = ideal_z
        self.hfield_size = tuple(float(v)
                                 for v in model.numpy("hfield_size"))

    def draw_reset(self, generator: Optional[torch.Generator],
                   n: int) -> terrain_lib.TerrainDraws:
        return terrain_lib.draw_terrain(self.model, generator,
                                        batch_shape=(n,))

    def expand_action(self, action: torch.Tensor,
                      phase: torch.Tensor) -> torch.Tensor:
        """Full per-joint deltas in calibration order (train2 step)."""
        target_cal = self.sim_home_rad + action * self.action_amplitude
        target_model = target_cal[..., self.cal_to_model]
        return torch.clamp(target_model, self.ctrl_lo, self.ctrl_hi)

    def _obs(self, state: SymWalkState) -> torch.Tensor:
        qpos, qvel = state.physics.qpos, state.physics.qvel
        ypr, joint_dev = self._ypr_dev(qpos)
        return torch.cat([ypr, joint_dev, qvel[..., 0:1]], dim=-1)

    def reset(self, draws: terrain_lib.TerrainDraws):
        terr = terrain_lib.generate_terrain(self.model, draws=draws,
                                            hfield_size=self.hfield_size)
        nrow, ncol = terr.height.shape[-2:]
        B = terr.height.shape[:-2]
        # spawn above the local terrain height, then settle
        h0 = terr.height[..., nrow // 2, ncol // 2]
        qpos = self.home_qpos.expand(B + self.home_qpos.shape).clone()
        qpos[..., 2] = self.home_qpos[2] + h0
        physics = State(qpos=qpos, qvel=qpos.new_zeros(B + (self.model.nv,)),
                        time=qpos.new_zeros(B))
        physics, _ = dynamics.step(
            self.model, physics,
            self.home_ctrl.expand(B + self.home_ctrl.shape), terr,
            n_substeps=self.settle_steps)
        return self._start(physics, terr)

    def step(self, state: SymWalkState, action: torch.Tensor):
        ctrl = self.expand_action(action, state.step_count % 2)
        physics, info = dynamics.step(self.model, state.physics, ctrl,
                                      state.terrain,
                                      n_substeps=self.n_substeps)
        qpos, qvel = physics.qpos, physics.qvel
        dx, cum_pos, cum_neg, net, dnd = self._progress(state, qpos)
        zero = torch.zeros_like(dx)
        fvx = qvel[..., 0]

        r_fwd = 450.0 * fvx
        r_prog = torch.where(dnd > 0.0005, 20.0 * dnd, zero)
        r_bwd = torch.where(fvx < -0.005, -9.0 * torch.abs(fvx), zero)
        r_step = torch.where(dx > 0, 70.0 * dx,
                             torch.where(dx < 0.0005, -1.0, 0.0))
        r_alive = 0.005 + 0.01
        r_side = -0.3 * torch.abs(qvel[..., 1]) - 0.5 * torch.abs(qvel[..., 1])
        r_ypos = -0.15 * torch.abs(qpos[..., 1] - self.home_qpos[1])
        z_dev_settled = qpos[..., 2] - state.settled_z
        z_dev_ideal = qpos[..., 2] - self.ideal_z
        r_z = (torch.where(z_dev_settled < -0.03,
                           -(self.z_coef * 0.5)
                           * (torch.abs(z_dev_settled) - 0.03) ** 2, zero)
               + torch.where(torch.abs(z_dev_ideal) > 0.05,
                             -(self.z_coef * 0.25)
                             * (torch.abs(z_dev_ideal) - 0.05) ** 2, zero))
        ypr, _ = self._ypr_dev(qpos)
        r_orient = self._orient(ypr, -0.08)
        r_smooth = -0.005 * torch.sum(torch.square(ctrl - state.last_ctrl),
                                      dim=-1)
        jvm = torch.sum(torch.abs(qvel[..., 6:14]), dim=-1)
        r_lowvel = -0.05 * torch.exp(-jvm * 5.0)

        reward = (r_fwd + r_prog + r_bwd + r_step + r_alive + r_side + r_ypos
                  + r_z + r_orient + r_smooth + r_lowvel)

        bad = ~torch.all(torch.isfinite(torch.cat([qpos, qvel], dim=-1)),
                         dim=-1)
        yaw, pitch, roll = ypr.unbind(-1)
        orient_term = ((torch.abs(roll) > self.orient_term)
                       | (torch.abs(pitch) > self.orient_term)
                       | (torch.abs(yaw) > self.orient_term * 1.5))
        too_backward = (cum_pos > self.min_fwd_for_backward_check) & (
            cum_neg > self.backward_frac * cum_pos)
        reward = reward + torch.where(bad, -50.0, 0.0)
        reward = torch.where(orient_term & ~bad, reward - 150.0, reward)
        reward = torch.where(too_backward & ~orient_term & ~bad,
                             reward - 50.0, reward)
        terminated = bad | orient_term | too_backward

        step_count = state.step_count + 1
        truncated = step_count >= self.max_steps
        new_state = dataclasses.replace(
            state, physics=physics, step_count=step_count, last_ctrl=ctrl,
            prev_x=qpos[..., 0], cum_pos_x=cum_pos, cum_neg_x=cum_neg,
            prev_net_fwd=net)
        return new_state, Transition(
            obs=self._obs(new_state), reward=reward, terminated=terminated,
            truncated=truncated,
            info=dict(sim_target_rad=ctrl, x_position=qpos[..., 0]))
