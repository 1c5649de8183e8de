"""Robot application behaviours (L6 parity, ``Code/examples/``).

A copy of the JAX package's ``apps/gaits.py`` (which imports no JAX).

Pure control laws are separated from the I/O runners so they are unit
testable without hardware; runners drive a :class:`QuadPilotBody` (real
robot or the loopback C++ firmware simulator).

Covered reference apps:
  * gait playback            — examples/udp_walk.py:181-244
  * yaw-auto-corrected trot  — examples/udp_walk_straight.py:165-220
  * turn-while-walking       — examples/udp_walk_angle.py (same loop with a
                               settable target yaw)
  * roll stabilization       — examples/stabilization.py:194-247
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..sim2real.calibration import ACTUATOR_NAMES_ORDERED, REAL_HOME_DEG
from ..utils.config import RobotNetworkConfig

# canonical stance pose in real degrees (udp_walk_straight.py:130-141 —
# identical to the sim2real real-home map)
STANCE_DEG: Dict[str, float] = dict(REAL_HOME_DEG)

# auto-correct trot constants (udp_walk_straight.py:34-38)
CORRECTION_GAIN_KP = 1.5
NEUTRAL_LIFT_ANGLE = 30.0
MIN_LIFT_ANGLE = 20.0
MAX_LIFT_ANGLE = 50.0
WALK_STEP_DURATION = 0.4

STABILIZATION_KP = -2.0  # stabilization.py:39


def _clamp(v, lo, hi):
    return max(lo, min(v, hi))


def stance_vector(order: Sequence[str] = ACTUATOR_NAMES_ORDERED) -> List[float]:
    return [STANCE_DEG[n] for n in order]


def autocorrect_trot_cycle(
    yaw_error_deg: float,
    order: Sequence[str] = ACTUATOR_NAMES_ORDERED,
) -> List[List[float]]:
    """One 4-phase trot cycle with P-yaw correction
    (udp_walk_straight.py:181-216).

    Returns four 8-angle poses: [lift FR/BL, plant, lift FL/BR, plant].
    N/Y = 30 ∓ Kp*err clamped to [20, 50]."""
    correction = CORRECTION_GAIN_KP * yaw_error_deg
    N = _clamp(NEUTRAL_LIFT_ANGLE - correction, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)
    Y = _clamp(NEUTRAL_LIFT_ANGLE + correction, MIN_LIFT_ANGLE, MAX_LIFT_ANGLE)
    idx = {n: i for i, n in enumerate(order)}
    stance = stance_vector(order)
    step1 = list(stance)
    step1[idx["FR_knee_actuator"]] = N
    step1[idx["BL_knee_actuator"]] = -N
    step3 = list(stance)
    step3[idx["FL_knee_actuator"]] = Y
    step3[idx["BR_knee_actuator"]] = -Y
    return [step1, list(stance), step3, list(stance)]


def stabilization_targets(
    roll_deg: float,
    order: Sequence[str] = ACTUATOR_NAMES_ORDERED,
    kp: float = STABILIZATION_KP,
) -> List[float]:
    """Roll-stabilization pose (stabilization.py:222-239): right-side
    thighs/knees shift by +adj, left side by -adj (knee signs mirrored),
    clamped to per-joint bands around home."""
    adj = kp * roll_deg
    home = dict(STANCE_DEG)
    out = {}
    # clamp bands: thighs home±30, knees |home|∈[15, 75] preserving sign
    for n in order:
        h = home[n]
        side_right = n.startswith(("FR", "BR"))
        is_knee = "knee" in n
        if is_knee:
            sign = 1.0 if h >= 0 else -1.0
            if n in ("FR_knee_actuator",):
                v = h + adj
            elif n in ("BR_knee_actuator",):
                v = h - adj
            elif n in ("FL_knee_actuator",):
                v = h - adj
            else:  # BL
                v = h + adj
            v = sign * _clamp(abs(v), 15.0, 75.0)
        else:
            v = h + adj if side_right else h - adj
            v = _clamp(v, h - 30.0, h + 30.0)
        out[n] = v
    return [out[n] for n in order]


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------


def motor_bringup(body, config: RobotNetworkConfig = RobotNetworkConfig()) -> bool:
    """The canonical bring-up sequence: PID params -> pins -> reset ->
    enable (run_robot.py:300-307, udp_walk.py:73-127)."""
    ok = body.set_control_params(
        config.pid_p, config.pid_i, config.pid_d,
        config.dead_zone, config.pos_thresh,
    )
    ok = body.set_all_pins(list(config.pins)) and ok
    ok = body.reset_all() and ok
    ok = body.set_all_control_status(True) and ok
    return ok


def safe_shutdown(body) -> None:
    """Disable + reset on exit (run_robot.py:270-285)."""
    try:
        body.set_all_control_status(False)
        body.reset_all()
    finally:
        body.close()


def play_gait(
    body,
    durations: Sequence[float],
    targets_deg: np.ndarray,
    stop_event: Optional[threading.Event] = None,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> int:
    """Timed gait playback (udp_walk.py:181-244): merge each step's targets
    into the last-sent 8-vector, send, sleep the step duration.  Returns the
    number of steps executed."""
    last = stance_vector()
    executed = 0
    for dur, row in zip(durations, np.asarray(targets_deg)):
        if stop_event is not None and stop_event.is_set():
            break
        last = list(row)
        body.set_angles(last)
        sleep_fn(float(dur))
        executed += 1
    return executed


def walk_straight(
    body,
    n_cycles: int,
    target_yaw: float = 0.0,
    imu_esp_index: int = 1,
    step_duration: float = WALK_STEP_DURATION,
    stop_event: Optional[threading.Event] = None,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> None:
    """Yaw-auto-corrected trot (udp_walk_straight.py:165-220).  With a
    nonzero ``target_yaw`` this is the turn-while-walking variant
    (udp_walk_angle.py)."""
    for _ in range(n_cycles):
        if stop_event is not None and stop_event.is_set():
            break
        yaw = 0.0
        dmp = body.get_latest_dmp_data_for_esp(imu_esp_index)
        if dmp and "ypr_deg" in dmp:
            yaw = dmp["ypr_deg"].get("yaw", 0.0)
        for pose in autocorrect_trot_cycle(yaw - target_yaw):
            if stop_event is not None and stop_event.is_set():
                break
            body.set_angles(pose)
            sleep_fn(step_duration)
    body.set_angles(stance_vector())


def stabilize(
    body,
    duration_s: float,
    imu_esp_index: int = 0,
    rate_hz: float = 50.0,
    stop_event: Optional[threading.Event] = None,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> None:
    """50 Hz roll-stabilization loop (stabilization.py:194-247)."""
    deadline = time.time() + duration_s
    period = 1.0 / rate_hz
    while time.time() < deadline:
        if stop_event is not None and stop_event.is_set():
            break
        dmp = body.get_latest_dmp_data_for_esp(imu_esp_index)
        roll = dmp["ypr_deg"].get("roll", 0.0) if dmp else 0.0
        body.set_angles(stabilization_targets(roll))
        sleep_fn(period)
    body.set_angles(stance_vector())
