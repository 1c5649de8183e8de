"""Motor calibration harnesses + offline PID response simulation.

``simulate_pid_response`` — offline firmware-PID tuning against a noisy
first-order motor model (port of ``examples/pid.py:5-45``): lets you tune
P/I/D without hardware and is the analytic twin of the C++ firmware sim's
servo loop.

``step_response`` / ``analyze_response`` — hardware calibration harness
(behavioral port of ``examples/calibration_pos.py`` / ``calibration3.py``):
drive one motor through a reference step via the SDK, record telemetry,
detect the stability window and report rise time / overshoot / settling
time / steady-state error.

A copy of the JAX package's ``apps/calibration.py`` (which imports no JAX).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COUNTS_PER_REV = 1975  # esp32_motors.ino:32


@dataclass
class PIDGains:
    p: float = 0.9
    i: float = 0.001
    d: float = 0.3
    dead_zone: int = 10
    pos_thresh: int = 5
    max_power: int = 255


def firmware_power(gains: PIDGains, error: float, error_delta: float,
                   integral: float, dt: float) -> float:
    """The firmware's exact power law (esp32_motors.ino:131-164)."""
    if abs(error) <= gains.dead_zone:
        p_d = 0.0
    else:
        scaled = float(np.clip(error / gains.pos_thresh, -1.0, 1.0))
        p_term = gains.p * scaled * gains.max_power
        d_term = gains.d * (error_delta / dt)
        if abs(error) <= gains.dead_zone * 5:
            d_term *= 3.0
        d_term = float(np.clip(d_term, -gains.max_power / 2,
                               gains.max_power / 2))
        p_d = p_term + d_term
    power = p_d + gains.i * integral
    return float(np.clip(power, -gains.max_power, gains.max_power))


def simulate_pid_response(
    gains: PIDGains = PIDGains(),
    target_deg: float = 45.0,
    duration_s: float = 2.0,
    dt: float = 0.002,
    motor_tau: float = 0.05,
    vel_per_power: float = 2.0 * COUNTS_PER_REV / 255,
    noise_std: float = 1.0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Closed-loop simulation of the 500 Hz servo on a first-order motor
    (examples/pid.py semantics).  Returns time/angle/power traces."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt)
    target = target_deg * COUNTS_PER_REV / 360.0
    pos, vel, integral, last_err = 0.0, 0.0, 0.0, 0.0
    t_arr = np.arange(n) * dt
    pos_arr = np.zeros(n)
    pow_arr = np.zeros(n)
    for k in range(n):
        err = target - pos
        if abs(err) < gains.max_power / max(abs(gains.i), 1e-9):
            integral += err * dt
        power = firmware_power(gains, err, err - last_err, integral, dt)
        last_err = err
        vel += (power * vel_per_power - vel) * (dt / motor_tau)
        pos += vel * dt + rng.normal(0.0, noise_std) * dt
        pos_arr[k] = pos * 360.0 / COUNTS_PER_REV
        pow_arr[k] = power
    return dict(time=t_arr, angle_deg=pos_arr, power=pow_arr,
                target_deg=np.full(n, target_deg))


def analyze_response(time_s: np.ndarray, angle_deg: np.ndarray,
                     target_deg: float, settle_band: float = 2.0) -> Dict:
    """Step-response metrics with stability-window detection
    (calibration3.py:44-52 semantics: settled = stays within the band)."""
    a = np.asarray(angle_deg, dtype=float)
    t = np.asarray(time_s, dtype=float)
    rise_idx = np.argmax(a >= 0.9 * target_deg) if np.any(
        a >= 0.9 * target_deg) else -1
    overshoot = float(max(0.0, a.max() - target_deg))
    inside = np.abs(a - target_deg) <= settle_band
    settle_idx = -1
    for k in range(len(a)):
        if inside[k:].all():
            settle_idx = k
            break
    return dict(
        rise_time_s=float(t[rise_idx]) if rise_idx >= 0 else np.inf,
        overshoot_deg=overshoot,
        settling_time_s=float(t[settle_idx]) if settle_idx >= 0 else np.inf,
        steady_state_error_deg=float(abs(a[-1] - target_deg)),
        settled=settle_idx >= 0,
    )


def step_response(
    body,
    motor_idx: int,
    target_deg: float,
    duration_s: float = 3.0,
    sample_hz: float = 50.0,
) -> Dict[str, np.ndarray]:
    """Hardware (or firmware-sim) step-response capture via the SDK
    (calibration_pos.py harness).  Requires a listening ``body``."""
    esp = 0 if motor_idx < 4 else 1
    local = motor_idx % 4
    angles = [0.0] * 8
    angles[motor_idx] = target_deg
    body.set_angles(angles)
    t0 = time.time()
    ts: List[float] = []
    va: List[float] = []
    while time.time() - t0 < duration_s:
        data = body.get_latest_motor_data_for_esp(esp)
        if data:
            ts.append(time.time() - t0)
            va.append(float(data["angles"][local]))
        time.sleep(1.0 / sample_hz)
    return dict(time=np.asarray(ts), angle_deg=np.asarray(va))
