"""Command-tracking segment metrics (a copy of the JAX package's
``utils/cmd_tracking.py``, which imports no JAX), shared by the
command-conditioned evals (scripts/distill_cmd.py, scripts/soak_cmd.py and
the port's scripts/torch_distill_cmd.py) so "tracked" means the same
geometry everywhere:
forward speed is measured in the COMMANDED heading frame over the second
half of the window (transient settled), and the heading error is the
wrapped angle to the commanded yaw target.

Thresholds stay at the call sites (they are part of each artifact's
claim); only the measurement lives here.
"""
from __future__ import annotations

import numpy as np


def heading_frame_vx(xy, cmd_yaw: float, dt_tick: float = 0.02) -> float:
    """Mean forward speed in the commanded heading frame over the second
    half of an (T, 2) xy trajectory window."""
    xy = np.asarray(xy)
    half = xy.shape[0] // 2
    dx = xy[-1, 0] - xy[half, 0]
    dy = xy[-1, 1] - xy[half, 1]
    dt = max((xy.shape[0] - 1 - half) * dt_tick, 1e-6)
    return float((dx * np.cos(cmd_yaw) + dy * np.sin(cmd_yaw)) / dt)


def yaw_error(yaw: float, cmd_yaw: float) -> float:
    """|wrapped angle| from ``yaw`` to the commanded target."""
    return float(abs(np.arctan2(np.sin(yaw - cmd_yaw),
                                np.cos(yaw - cmd_yaw))))


def segment_record(xy, yaw_end: float, cmd, dt_tick: float = 0.02) -> dict:
    """Per-segment tracking record for a command ``(vx, vy, yaw_target)``
    over an (T, 2) xy window ending at heading ``yaw_end``."""
    cmd = [float(v) for v in cmd]
    vx_h = heading_frame_vx(xy, cmd[2], dt_tick)
    return dict(
        cmd=[round(v, 2) for v in cmd],
        mean_vx_cmd_frame=round(vx_h, 3),
        vx_err=round(abs(vx_h - cmd[0]), 3),
        yaw_end=round(float(yaw_end), 3),
        yaw_err=round(yaw_error(float(yaw_end), cmd[2]), 3),
    )
