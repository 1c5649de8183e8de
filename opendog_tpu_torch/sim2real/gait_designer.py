"""Scripted open-loop trot designer + in-sim gait playback.

Port of the JAX package's ``sim2real/gait_designer.py``.

``design_trot``  — behavioural port of ``sim2real/main.py:63-151``: builds an
initial-hold + N alternating-diagonal shuffle steps + return-home sequence
from hand-tuned thigh/knee deltas, clamped to ctrlrange, with both sim-radian
and real-degree targets.

``replay_gait``  — the inverse pipeline of ``sim2real/run.py:243-351``: load
a real-degree gait, convert to sim radians (clamped), replay it through the
physics (the op-graph step) with each step held for its duration, and report
tracking metrics.  On CUDA the 128-substep and the 1-substep advances each
replay one CUDA graph, the counterparts of the JAX function's two jitted
steps.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..physics import State, dynamics, make_state
from ..solvers.graph import GraphedTick
from .calibration import Calibration

CHUNK = 128  # substeps of the long advance


class TrotParams(NamedTuple):
    """Hand-tuned gait deltas (sim radians) — sim2real/main.py:68-76."""

    thigh_forward: float = 0.10
    thigh_backward: float = -0.10
    back_knee_lift: float = -0.35
    back_knee_extend: float = 0.2
    front_knee_lift: float = -0.50
    front_knee_extend: float = 0.15
    phase_duration: float = 0.40
    initial_hold: float = 1.0
    num_steps: int = 12


def design_trot(model, params: TrotParams = TrotParams()):
    """Returns (durations (T,), sim_ctrl (T, nu) in calibration order,
    real_deg (T, nu)).  Step 0 holds home; steps alternate FR/BL and FL/BR
    swings; the last step returns home (main.py:84-151)."""
    cal = Calibration(model)
    home = dict(zip(cal.order, cal.sim_home_rad))
    lo = dict(zip(cal.order, cal.ctrl_lo))
    hi = dict(zip(cal.order, cal.ctrl_hi))
    p = params

    def clamp(name, v):
        return float(np.clip(v, lo[name], hi[name]))

    def pose(**deltas) -> List[float]:
        return [clamp(n, home[n] + deltas.get(n, 0.0)) for n in cal.order]

    rows = [pose()]
    durations = [p.initial_hold]
    for step in range(p.num_steps):
        if step % 2 == 0:  # FR/BL swing
            rows.append(pose(
                FR_tigh_actuator=p.thigh_forward,
                FR_knee_actuator=p.front_knee_lift,
                BL_tigh_actuator=p.thigh_forward,
                BL_knee_actuator=p.back_knee_lift,
                FL_tigh_actuator=p.thigh_backward,
                FL_knee_actuator=p.front_knee_extend,
                BR_tigh_actuator=p.thigh_backward,
                BR_knee_actuator=p.back_knee_extend,
            ))
        else:  # FL/BR swing
            rows.append(pose(
                FL_tigh_actuator=p.thigh_forward,
                FL_knee_actuator=p.front_knee_lift,
                BR_tigh_actuator=p.thigh_forward,
                BR_knee_actuator=p.back_knee_lift,
                FR_tigh_actuator=p.thigh_backward,
                FR_knee_actuator=p.front_knee_extend,
                BL_tigh_actuator=p.thigh_backward,
                BL_knee_actuator=p.back_knee_extend,
            ))
        durations.append(p.phase_duration)
    rows.append(pose())
    durations.append(1.0)

    sim_ctrl = np.asarray(rows, dtype=np.float32)
    # float32 tensors: torch.rad2deg rounds as jnp.degrees does (numpy's
    # np.degrees does not)
    real_deg = cal.sim_rad_to_real_deg(torch.from_numpy(sim_ctrl)).numpy()
    return np.asarray(durations), sim_ctrl, real_deg


def replay_gait(
    model,
    durations: Sequence[float],
    sim_ctrl_cal_order: np.ndarray,
    settle_steps: int = 100,
    device=None,
) -> Dict[str, np.ndarray]:
    """Replay a gait through the physics (run.py:243-351 without the
    wall-clock pacing — on-device time is exact).  Each step's target is held
    for its duration at the model timestep, in chunks of 128 substeps and
    then single substeps.  Returns trajectories of the trunk pose and
    per-step joint tracking error.  Runs on ``device`` (CUDA unless the
    caller names another)."""
    device = resolve_device(device)
    model = model.to(device)
    cal = Calibration(model)
    inv = np.argsort(cal.model_actuator_index)
    ctrl_model = np.asarray(sim_ctrl_cal_order, np.float32)[:, inv]

    state = make_state(model, "home")
    home_ctrl = model.key_ctrl[model.key_id("home")]
    state, _ = dynamics.step(model, state, home_ctrl, None,
                             n_substeps=settle_steps)

    def advance(n):
        def fn(qpos, qvel, t, ctrl):
            st, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=t),
                                  ctrl, n_substeps=n)
            return st.qpos, st.qvel, st.time
        return fn

    steps = {n: advance(n) for n in (CHUNK, 1)}
    graphs = device.type == "cuda"
    trunk, err = [], []
    qadr = model.numpy("actuator_qposadr")
    for dur, ctrl in zip(durations, ctrl_model):
        n = max(1, int(round(float(dur) / model.timestep)))
        cvec = torch.from_numpy(ctrl).to(device)
        x = (state.qpos, state.qvel, state.time)
        for size, count in ((CHUNK, n // CHUNK), (1, n % CHUNK)):
            for _ in range(count):
                if graphs and not isinstance(steps[size], GraphedTick):
                    steps[size] = GraphedTick(steps[size], x + (cvec,),
                                              device)
                x = steps[size](*x, cvec)
        state = State(*x)
        qpos = state.qpos.cpu().numpy()
        trunk.append(qpos[:7])
        err.append(np.abs(qpos[qadr] - ctrl).max())
    return dict(trunk=np.asarray(trunk), max_joint_err=np.asarray(err))
