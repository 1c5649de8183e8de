"""On-robot policy inference — the sim2real deployment loop.

A copy of the JAX package's ``apps/run_policy.py`` (which imports no JAX).

Behavioural port of ``Code/mujoco/sim2real/run_robot.py``: a 12.5 Hz control
loop (run_robot.py:37) that reads DMP yaw/pitch/roll + world-frame
acceleration from the telemetry store, integrates a damped X-velocity
estimate (``v = 0.99 v + ax dt``, run_robot.py:166-172), maps real-robot
degrees to the policy's joint-delta radians (run_robot.py:189-196), runs the
actor mean, scales by the action amplitude and clips to ±45 deg per motor
before ``set_angles`` (run_robot.py:176-239).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..sim2real.calibration import ACTUATOR_NAMES_ORDERED, REAL_HOME_DEG

CONTROL_LOOP_HZ = 12.5          # run_robot.py:37
ACTION_SCALE_DEG = 50.0         # run_robot.py action scaling
MOTOR_LIMIT_DEG = 45.0          # per-motor clip (run_robot.py:230)
VELOCITY_DAMPING = 0.99         # run_robot.py:169


class VelocityEstimator:
    """Damped world-X velocity integration from DMP acceleration
    (run_robot.py:166-172)."""

    def __init__(self, damping: float = VELOCITY_DAMPING):
        self.damping = damping
        self.vx = 0.0
        self._last_t: Optional[float] = None

    def update(self, ax_mps2: float, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        dt = 0.0 if self._last_t is None else now - self._last_t
        self._last_t = now
        self.vx = self.damping * self.vx + ax_mps2 * dt
        return self.vx


def build_observation(
    ypr_deg: Sequence[float],
    motor_angles_deg: Sequence[float],
    vx_mps: float,
    order: Sequence[str] = ACTUATOR_NAMES_ORDERED,
) -> np.ndarray:
    """12-dim terrain-policy state (run_robot.py:176-207 / train2.py:183):
    [yaw, pitch, roll (rad), 8 joint deltas from real home (rad), vx]."""
    ypr_rad = np.radians(np.asarray(ypr_deg, dtype=np.float32))
    home = np.array([REAL_HOME_DEG[n] for n in order], dtype=np.float32)
    deltas_rad = np.radians(np.asarray(motor_angles_deg, np.float32) - home)
    return np.concatenate([ypr_rad, deltas_rad, [np.float32(vx_mps)]])


def action_to_target_degrees(
    action: np.ndarray,
    order: Sequence[str] = ACTUATOR_NAMES_ORDERED,
) -> np.ndarray:
    """Policy action in [-1,1]^8 -> absolute real-degree targets, scaled by
    50 deg and clipped to ±45 deg per motor (run_robot.py:225-236)."""
    home = np.array([REAL_HOME_DEG[n] for n in order], dtype=np.float32)
    target = home + np.clip(np.asarray(action) * ACTION_SCALE_DEG,
                            -ACTION_SCALE_DEG, ACTION_SCALE_DEG)
    return np.clip(target, home - MOTOR_LIMIT_DEG, home + MOTOR_LIMIT_DEG)


def run_policy_loop(
    body,
    policy_fn: Callable[[np.ndarray], np.ndarray],
    duration_s: float,
    imu_esp_index: int = 0,
    rate_hz: float = CONTROL_LOOP_HZ,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> int:
    """The realtime deployment loop (run_robot.py:252-263).  Returns loop
    iterations executed; warns (returns early) never — overruns are simply
    logged as in the reference."""
    period = 1.0 / rate_hz
    vel = VelocityEstimator()
    iters = 0
    deadline = time.time() + duration_s
    while time.time() < deadline:
        t0 = time.time()
        dmp = body.get_latest_dmp_data_for_esp(imu_esp_index)
        motor = body.get_latest_motor_data_for_esp(imu_esp_index)
        ypr = (
            [dmp["ypr_deg"].get(k, 0.0) for k in ("yaw", "pitch", "roll")]
            if dmp else [0.0, 0.0, 0.0]
        )
        ax = dmp["world_accel_mps2"].get("ax", 0.0) if dmp else 0.0
        vx = vel.update(ax, now=t0)
        # both ESPs' angle halves
        m0 = body.get_latest_motor_data_for_esp(0)
        m1 = body.get_latest_motor_data_for_esp(1)
        angles = (
            (m0["angles"] if m0 else [0.0] * 4)
            + (m1["angles"] if m1 else [0.0] * 4)
        )
        obs = build_observation(ypr, angles, vx)
        action = np.asarray(policy_fn(obs))
        body.set_angles(action_to_target_degrees(action))
        iters += 1
        elapsed = time.time() - t0
        if elapsed < period:
            sleep_fn(period - elapsed)
    return iters
