"""Task cost functions for the trajectory-optimization solvers.

Port of ``opendog_tpu/solvers/costs.py``: the tracking, standing and trot
costs, the command-conditioned trot cost and gait reference (``:184-344``:
``trot_cost_cmd``, ``ref_takes_cmd``, ``trot_gait_ref_cmd``) and, for the
whole-body iLQR, the contact schedules and gait reference (``:345-570``:
``ContactSchedule``, ``trot_schedule``, ``landing_schedule``,
``contact_schedule_cost``, ``trot_gait_ref``).  A cost is a per-step
function ``cost(state, ctrl, prev_ctrl) -> cost`` that works batch-first:
``state.qpos`` (K, nq), ``state.qvel`` (K, nv), ``state.time`` (K,), ``ctrl``
and ``prev_ctrl`` (K, nu) give a (K,) cost; unbatched inputs give a scalar.
A command-conditioned cost takes a trailing ``cmd``, one ``(vx, vy,
yaw_target)`` row per lane: (K, 3).  Constants live on the model's device.
"""
from __future__ import annotations

import inspect
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
    locomotion MPC.  The closure carries ``tracking = (params,
    home_joint_qpos)``, its own constants, by which the MPPI rollouts on
    the card pick the hand-written kernel that computes it
    (``ops.cuda_step.TrackingCostKernel``).  A wrapper around the closure
    (a lambda, ``functools.partial``, an adapter) drops the tag, and the
    rollouts then run the closure's torch ops: ``COST_LAUNCHES`` reading 0
    on a solve shows it."""
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

    step_cost.tracking = (params, home_j)
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
    phase-conditioned symmetric gait, sim2real/train.py:235-285).  The last
    three fields shape the command-conditioned gait of
    :func:`trot_cost_cmd` and :func:`trot_gait_ref_cmd` (see
    :func:`_cmd_stride_scales`)."""

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
    amp_v0: float = -1.0         # < 0: stride scale linear in the commanded
    # speed; >= 0: the calibrated affine law with a smooth stand gate
    amp_knots: tuple = ()        # ((v, scale), ...): a measured piecewise-
    # linear speed -> scale law, clamped at both ends; overrides amp_v0
    turn_gain: float = 0.0       # > 0: differential-stride steering


def _leg_layout(legs: str, params: TrotCostParams):
    """(thigh joints, knee joints, diagonal signs, thigh direction) of a leg
    layout, the joints as slices of ``qpos[7:]``: 'go1' = (hip, thigh,
    knee) x [FR, FL, RR, RL]; 'opendog' = (thigh, knee) x [FL, FR, BL, BR].
    Slices index without a host copy, so the costs stay capturable."""
    if legs == "go1":
        return (slice(1, None, 3), slice(2, None, 3), [1.0, -1.0, -1.0, 1.0],
                -params.thigh_phase)
    if legs == "opendog":
        return (slice(0, None, 2), slice(1, None, 2), [-1.0, 1.0, 1.0, -1.0],
                params.thigh_phase)
    raise ValueError(f"unknown leg layout {legs!r}")


def _dofs(joints: slice) -> slice:
    """The qvel slice of a joint slice of ``qpos[7:]`` (free joint first)."""
    return slice(joints.start + 6, None, joints.step)


def trot_cost(model, params: TrotCostParams, home_joint_qpos,
              legs: str = "go1"):
    """Gait-shaped locomotion cost.

    Joint layout per leg: 'go1' = (hip, thigh, knee) x [FR, FL, RR, RL];
    'opendog' = (thigh, knee) x [FL, FR, BL, BR] (qpos order).  Diagonal
    pairs (FR+RL / FL+RR, or FR+BL / FL+BR) alternate by phase."""
    home_j = _const(model, home_joint_qpos)
    desired = _const(model, params.desired_vel_xy)
    thigh_idx, knee_idx, diag_sign, thigh_dir = _leg_layout(legs, params)
    knee_dir = -1.0  # knees flex negative
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


def _side_signs(model, legs: str) -> torch.Tensor:
    """+1 for legs on the robot's right (y < 0), -1 for the left: a positive
    differential strides the right side longer and turns left (+yaw)."""
    if legs == "go1":       # FR, FL, RR, RL
        return _const(model, [1.0, -1.0, 1.0, -1.0])
    return _const(model, [-1.0, 1.0, -1.0, 1.0])  # opendog: FL, FR, BL, BR


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in the JAX package's arithmetic: linear
    between the knots, clamped to the end values outside them.  The knot
    lookup is ``torch.searchsorted`` on the device: no host read."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.reshape(-1), right=True).reshape(x.shape)
    i = torch.clamp(i, 1, n - 1)
    x0, x1 = _rows(xp, i - 1), _rows(xp, i)
    f0, f1 = _rows(fp, i - 1), _rows(fp, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0,
                    f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _cmd_stride_scales(params: TrotCostParams, v_nom: float,
                       side: torch.Tensor, cmd: torch.Tensor, yaw=None,
                       knots=None) -> torch.Tensor:
    """(..., 4) per-leg stride scales of the command-conditioned gait for
    commands ``cmd`` (..., 3).

    Forward part: the linear command scale, or (``amp_v0 >= 0``) the
    calibrated affine law with a smooth stand gate, or (``amp_knots``, as
    ``knots = (speeds, scales)`` tensors) the measured piecewise-linear
    law.  Steering part (``turn_gain > 0``): the differential stride
    ``side * d``.  ``yaw=None`` is the open-loop (gait reference) form: the
    heading error is the commanded target itself."""
    speed = torch.sqrt(torch.sum(torch.square(cmd[..., :2]), dim=-1)
                       + 1e-12)
    if len(params.amp_knots) > 0:
        scale = _interp(speed, *knots)
    elif params.amp_v0 >= 0.0:
        scale = torch.clamp((speed + params.amp_v0)
                            / (v_nom + params.amp_v0), 0.0, 1.5) \
            * torch.clamp(speed / 0.1, max=1.0)
    else:
        scale = torch.clamp(speed / v_nom, 0.0, 1.5)
    s_leg = scale[..., None] * torch.ones_like(side)
    if params.turn_gain > 0.0:
        target = cmd[..., 2]
        dyaw = (target if yaw is None else
                torch.atan2(torch.sin(target - yaw), torch.cos(target - yaw)))
        d = torch.clamp(params.turn_gain * dyaw, -0.5, 0.5)
        s_leg = s_leg + side * d[..., None]
    return s_leg


def _cmd_gait(model, params: TrotCostParams, legs: str):
    """What the command-conditioned cost and gait reference share: the leg
    layout, the nominal speed, the side signs and the speed knots."""
    v_nom = max(1e-6, float(np.hypot(*params.desired_vel_xy)))
    knots = None
    if len(params.amp_knots) > 0:
        knots = (_const(model, [k[0] for k in params.amp_knots]),
                 _const(model, [k[1] for k in params.amp_knots]))
    return _leg_layout(legs, params), v_nom, _side_signs(model, legs), knots


def trot_cost_cmd(model, params: TrotCostParams, home_joint_qpos,
                  legs: str = "go1"):
    """Command-conditioned :func:`trot_cost`: returns ``step_cost(state,
    ctrl, prev_ctrl, cmd)`` with ``cmd = (vx, vy, yaw_target)`` per lane in
    place of the params' fixed ``desired_vel_xy`` / ``desired_yaw``
    (``mppi.make_solver(with_command=True)``).  The gait term scales with
    the commanded speed (:func:`_cmd_stride_scales`, with the steering
    closed on the actual heading): at ``cmd = 0`` the swing collapses to a
    stand."""
    home_j = _const(model, home_joint_qpos)
    (thigh_idx, knee_idx, diag_sign, thigh_dir), v_nom, side, knots = \
        _cmd_gait(model, params, legs)
    knee_dir = -1.0
    sign = _const(model, diag_sign)
    home_thigh, home_knee = home_j[thigh_idx], home_j[knee_idx]

    def step_cost(state: State, ctrl, prev_ctrl, cmd):
        qpos, qvel = state.qpos, state.qvel
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        s_leg = _cmd_stride_scales(params, v_nom, side, cmd, yaw, knots)
        phase = 2.0 * math.pi * state.time / params.period_s
        s = torch.sin(phase)[..., None]
        sl = torch.sin(phase + params.lift_phase)[..., None]
        swing = torch.where(sign > 0, torch.clamp(sl, min=0.0),
                            torch.clamp(-sl, min=0.0))
        thigh_ref = home_thigh + thigh_dir * params.thigh_amp \
            * s_leg * sign * s
        knee_ref = home_knee \
            + knee_dir * params.knee_lift * torch.abs(s_leg) * swing
        joints = qpos[..., 7:]
        c_gait = params.w_gait * (
            _sq_sum(joints[..., thigh_idx] - thigh_ref)
            + _sq_sum(joints[..., knee_idx] - knee_ref)
        )
        c_vel = params.w_vel * _sq_sum(qvel[..., :2] - cmd[..., :2])
        c_h = params.w_height * torch.square(qpos[..., 2] - params.target_height)
        c_up = params.w_upright * (torch.square(roll) + torch.square(pitch))
        c_lat = params.w_lateral * torch.square(qvel[..., 1] - cmd[..., 1])
        c_yawr = params.w_yaw_rate * torch.square(qvel[..., 5])
        dyaw = torch.atan2(torch.sin(yaw - cmd[..., 2]),
                           torch.cos(yaw - cmd[..., 2]))
        c_head = params.w_heading * torch.square(dyaw)
        c_rate = params.w_ctrl_rate * _sq_sum(ctrl - prev_ctrl)
        return (c_gait + c_vel + c_h + c_up + c_lat + c_yawr + c_head
                + c_rate)

    return step_cost


def ref_takes_cmd(u_ref_fn) -> bool:
    """True if an action reference is command-indexed, ``(t, cmd) -> ctrl``
    (:func:`trot_gait_ref_cmd`), rather than ``(t) -> ctrl``
    (:func:`trot_gait_ref`): the one arity convention of the anchored
    solver, the distiller and student deployment."""
    return len(inspect.signature(u_ref_fn).parameters) >= 2


def trot_gait_ref_cmd(model, params: TrotCostParams, home_joint_qpos,
                      legs: str = "go1"):
    """Command-scaled :func:`trot_gait_ref`: ``u_ref(t, cmd)`` with the
    swing scaled by the commanded speed as :func:`trot_cost_cmd` scales its
    gait term, steering open loop (``cmd = 0`` gives the home stand).
    Batch-first: times (...) and commands (..., 3) give controls
    (..., nu)."""
    home_j = _const(model, home_joint_qpos)
    (thigh_idx, knee_idx, diag_sign, thigh_dir), v_nom, side, knots = \
        _cmd_gait(model, params, legs)
    knee_dir = -1.0
    qadr = (model.actuator_qposadr - 7).long()
    sign = _const(model, diag_sign)
    home_thigh, home_knee = home_j[thigh_idx], home_j[knee_idx]

    def u_ref(t, cmd):
        s_leg = _cmd_stride_scales(params, v_nom, side, cmd, None, knots)
        phase = (2.0 * math.pi * t / params.period_s)[..., None]
        s = torch.sin(phase)
        sl = torch.sin(phase + params.lift_phase)
        swing = torch.where(sign > 0, torch.clamp(sl, min=0.0),
                            torch.clamp(-sl, min=0.0))
        joints_ref = home_j.expand(s_leg.shape[:-1] + home_j.shape).clone()
        joints_ref[..., thigh_idx] = (
            home_thigh + thigh_dir * params.thigh_amp * s_leg * sign * s)
        joints_ref[..., knee_idx] = (
            home_knee + knee_dir * params.knee_lift * torch.abs(s_leg)
            * swing)
        return joints_ref[..., qadr]

    return u_ref


# ---------------------------------------------------------------------------
# Contact schedules (port of opendog_tpu/solvers/costs.py:345-570)
# ---------------------------------------------------------------------------


def _rows(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``table[i]`` for an index tensor of any shape, 0-d included: a 0-d
    index would otherwise be read to the host as a Python int, which
    neither a CUDA graph capture nor ``torch.func.vmap`` allows."""
    return torch.index_select(table, 0, i.reshape(-1)).reshape(
        i.shape + table.shape[1:])


@dataclass(frozen=True)
class ContactSchedule:
    """Explicit per-leg stance/swing plan, the contact-sequencing input of
    the whole-body iLQR (BASELINE config 3): a table of time slots that
    costs built from it index by ``state.time``, which iLQR threads through
    the horizon, so one solve optimises through the stance/swing sequence.

    ``stance``: (n_slots, nlegs) rows of 0/1, 1 = the leg is planned in
    stance during that slot, legs in the model's qpos order (go1: FR, FL,
    RR, RL; opendog: FL, FR, BL, BR).  ``thigh_offset``: optional (n_slots,
    nlegs) thigh targets [rad, "forward" units] at the start of each slot,
    interpolated linearly to the next slot's.  ``cyclic``: wrap (gaits) or
    clamp at the last slot (terminal sequences such as a landing)."""

    stance: tuple
    slot_dt: float
    cyclic: bool = True
    thigh_offset: tuple = None


def trot_schedule(params: TrotCostParams, legs: str = "go1",
                  duty: float = 0.5) -> ContactSchedule:
    """Alternating-diagonal trot: pair A (FR+RL / FR+BL) in stance while
    pair B swings, then swap, each leg's thigh on a triangle wave of
    amplitude ``thigh_amp`` (forward in swing, back in stance).  ``duty``
    is the stance fraction per leg: 0.5, the two-slot trot, or 0.625, an
    eight-slot walk-trot (swing 3 slots, stance 5) with quadruple-support
    overlap."""
    if legs == "go1":
        diag_sign = np.array([1.0, -1.0, -1.0, 1.0])  # FR, FL, RR, RL
    else:
        diag_sign = np.array([-1.0, 1.0, 1.0, -1.0])  # FL, FR, BL, BR
    amp = params.thigh_amp
    try:
        n_slots, n_swing = {0.5: (2, 1), 0.625: (8, 3)}[duty]
    except KeyError:
        raise ValueError(f"duty must be 0.5 or 0.625, got {duty}")
    # per-leg triangle wave (slot-start waypoints): -amp -> +amp over the
    # swing slots, back over the stance slots; pair B half a period later
    tri = np.array([
        (-amp + 2.0 * amp * k / n_swing) if k <= n_swing
        else (amp - 2.0 * amp * (k - n_swing) / (n_slots - n_swing))
        for k in range(n_slots)], np.float32)
    phase = np.where(diag_sign > 0, 0, n_slots // 2)
    off = np.stack([tri[(k - phase) % n_slots] for k in range(n_slots)])
    stance = np.stack([((k - phase) % n_slots >= n_swing)
                       .astype(np.float32) for k in range(n_slots)])
    return ContactSchedule(
        stance=tuple(map(tuple, stance)),
        slot_dt=params.period_s / n_slots,
        cyclic=True,
        thigh_offset=tuple(map(tuple, off.astype(np.float32))),
    )


def landing_schedule(slot_dt: float = 0.25) -> ContactSchedule:
    """Front-then-back landing of the Go1 ``descent`` drop (legs FR, FL,
    RR, RL): the front legs are planned in stance from the first slot and
    reach for the ground while the rears stay tucked one slot longer, then
    all four stand."""
    stance = ((1.0, 1.0, 0.0, 0.0),   # flight: fronts reach, rears tuck
              (1.0, 1.0, 0.0, 0.0),   # front touch-down
              (1.0, 1.0, 1.0, 1.0))   # all-stance
    return ContactSchedule(stance=stance, slot_dt=slot_dt, cyclic=False)


def contact_schedule_cost(model, sched: ContactSchedule,
                          params: TrotCostParams, home_joint_qpos,
                          legs: str = "go1", w_stance_vel: float = 0.05):
    """Cost shaped by an explicit :class:`ContactSchedule`.

    Per leg and time, references from the schedule (linearly interpolated
    between slots): swing legs flex the knee by ``knee_lift`` and follow
    the slot thigh offsets; stance legs extend to home and are damped
    (``w_stance_vel`` on their joint velocities, a smooth stand-in for
    "a stance foot does not move").  The trunk terms (velocity, height,
    upright, heading) take their weights from ``TrotCostParams``."""
    home_j = _const(model, home_joint_qpos)
    desired = _const(model, params.desired_vel_xy)
    thigh_idx, knee_idx, _, thigh_dir = _leg_layout(legs, params)
    knee_dir = -1.0
    stance_tab = _const(model, sched.stance)
    n_slots = stance_tab.shape[0]
    off_tab = (_const(model, sched.thigh_offset)
               if sched.thigh_offset is not None
               else torch.zeros_like(stance_tab))
    thigh_dof, knee_dof = _dofs(thigh_idx), _dofs(knee_idx)
    home_thigh, home_knee = home_j[thigh_idx], home_j[knee_idx]

    def _interp(table, pos):
        """Rows of ``table`` linearly interpolated at the fractional slot
        position ``pos`` (row k anchored at pos == k): cyclic wrap, or a
        clamp at both ends."""
        if sched.cyclic:
            pos = torch.remainder(pos, n_slots)
            fl = torch.floor(pos)
            i0 = fl.long() % n_slots
            i1 = (i0 + 1) % n_slots
        else:
            pos = torch.clamp(pos, 0.0, float(n_slots - 1))
            fl = torch.floor(pos)
            i0 = torch.clamp(fl.long(), 0, n_slots - 1)
            i1 = torch.clamp(i0 + 1, max=n_slots - 1)
        frac = (pos - fl)[..., None]
        return (1 - frac) * _rows(table, i0) + frac * _rows(table, i1)

    def step_cost(state: State, ctrl, prev_ctrl):
        qpos, qvel = state.qpos, state.qvel
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        pos = state.time / sched.slot_dt
        # stance flags anchor at slot centres: crisp mid-slot, blended
        # across slot boundaries; thigh offsets are slot-start waypoints
        stance_t = _interp(stance_tab, pos - 0.5)
        off_t = _interp(off_tab, pos)
        swing_t = 1.0 - stance_t
        joints = qpos[..., 7:]
        thigh_ref = home_thigh + thigh_dir * off_t
        knee_ref = home_knee + knee_dir * params.knee_lift * swing_t
        c_gait = params.w_gait * (
            _sq_sum(joints[..., thigh_idx] - thigh_ref)
            + _sq_sum(joints[..., knee_idx] - knee_ref)
        )
        c_stance = w_stance_vel * torch.sum(
            stance_t * (torch.square(qvel[..., thigh_dof])
                        + torch.square(qvel[..., knee_dof])), dim=-1)
        c_vel = params.w_vel * _sq_sum(qvel[..., :2] - desired)
        c_h = params.w_height * torch.square(qpos[..., 2] - params.target_height)
        c_up = params.w_upright * (torch.square(roll) + torch.square(pitch))
        c_lat = params.w_lateral * torch.square(qvel[..., 1])
        c_yawr = params.w_yaw_rate * torch.square(qvel[..., 5])
        dyaw = torch.atan2(torch.sin(yaw - params.desired_yaw),
                           torch.cos(yaw - params.desired_yaw))
        c_head = params.w_heading * torch.square(dyaw)
        c_rate = params.w_ctrl_rate * _sq_sum(ctrl - prev_ctrl)
        return (c_gait + c_stance + c_vel + c_h + c_up + c_lat + c_yawr
                + c_head + c_rate)

    return step_cost


def trot_gait_ref(model, params: TrotCostParams, home_joint_qpos,
                  legs: str = "go1"):
    """Phase-referenced trot joint targets in actuator order: the
    feed-forward gait that ``trot_cost`` pulls toward (its thigh and knee
    reference formulas), the warm start of the iLQR tracker.  Batch-first
    in time: ``u_ref(t)`` maps times (...) to controls (..., nu)."""
    home_j = _const(model, home_joint_qpos)
    thigh_idx, knee_idx, diag_sign, thigh_dir = _leg_layout(legs, params)
    knee_dir = -1.0
    qadr = (model.actuator_qposadr - 7).long()  # actuator -> joint index
    sign = _const(model, diag_sign)
    home_thigh, home_knee = home_j[thigh_idx], home_j[knee_idx]

    def u_ref(t):
        phase = (2.0 * math.pi * t / params.period_s)[..., None]
        s = torch.sin(phase)
        sl = torch.sin(phase + params.lift_phase)
        swing = torch.where(sign > 0, torch.clamp(sl, min=0.0),
                            torch.clamp(-sl, min=0.0))
        joints_ref = home_j.expand(t.shape + home_j.shape).clone()
        joints_ref[..., thigh_idx] = (
            home_thigh + thigh_dir * params.thigh_amp * sign * s)
        joints_ref[..., knee_idx] = (
            home_knee + knee_dir * params.knee_lift * swing)
        return joints_ref[..., qadr]

    return u_ref
