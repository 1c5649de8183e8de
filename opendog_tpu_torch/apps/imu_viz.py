"""3-D IMU acceleration-vector visualizer.

Behavioural port of ``Code/examples/imu_visualizer.py:21-86``: poll the
camera's ``get_imu_data()`` at ~10 Hz and draw the (accel_x, accel_y,
accel_z) vector as a normalized 3-D quiver from the origin, viewed from
elev=20 azim=45 with ±10 axis limits.

Headless re-architecture: the Tk/TkAgg GUI becomes a pure projection core
(``project_vector``: the same elev/azim orthographic view, testable) with
two renderers — a terminal frame (``render_terminal``) and a matplotlib
Agg 3-D figure (``render_png``) — plus ``run`` which drives them from any
``get_imu_data``-shaped source (QuadPilotCamera or the loopback camera
sim's ``/imu_data`` endpoint).

A copy of the JAX package's ``apps/imu_viz.py`` (which imports no JAX); its
live app reads the port's ``sdk/camera.py`` (on ``urllib``).
"""
from __future__ import annotations

import math
import sys
import time
from typing import Callable, Optional

import numpy as np

AXIS_LIM = 10.0  # imu_visualizer.py:34-36 set_xlim/ylim/zlim(±10)
ELEV_DEG = 20.0  # imu_visualizer.py:37 view_init(elev=20, azim=45)
AZIM_DEG = 45.0


def normalize(vec) -> np.ndarray:
    """The reference quiver draws the vector normalized to length 1
    (imu_visualizer.py:68 ``length=1.0, normalize=True``); a zero vector
    stays zero."""
    v = np.asarray(vec, dtype=np.float64)
    n = float(np.linalg.norm(v))
    return v / n if n > 1e-12 else v


def project_vector(vec, elev_deg: float = ELEV_DEG,
                   azim_deg: float = AZIM_DEG) -> np.ndarray:
    """Orthographic screen-space (u, v) of a 3-D vector under matplotlib's
    3-D view angles: rotate by -azim about z, then -elev about the new y;
    screen u = rotated y, screen v = rotated z."""
    a = math.radians(azim_deg)
    e = math.radians(elev_deg)
    x, y, z = np.asarray(vec, dtype=np.float64)
    # yaw about z
    x1 = x * math.cos(a) + y * math.sin(a)
    y1 = -x * math.sin(a) + y * math.cos(a)
    # pitch about y1
    z2 = z * math.cos(e) - x1 * math.sin(e)
    return np.array([y1, z2])


def render_terminal(vec, width: int = 41, height: int = 21) -> str:
    """ASCII frame: the projected accel vector drawn from the canvas
    center, with the numeric readout the GUI shows on its axes."""
    v = normalize(vec)
    u, w = project_vector(v)
    canvas = [[" "] * width for _ in range(height)]
    cx, cy = width // 2, height // 2
    canvas[cy][cx] = "+"
    n_steps = max(width, height)
    for i in range(1, n_steps + 1):
        t = i / n_steps
        px = cx + int(round(t * u * (width // 2 - 1)))
        py = cy - int(round(t * w * (height // 2 - 1)))
        if 0 <= px < width and 0 <= py < height:
            canvas[py][px] = "*"
    x, y, z = np.asarray(vec, dtype=np.float64)
    head = (f"accel  x={x:+7.2f}  y={y:+7.2f}  z={z:+7.2f}   "
            f"|a|={np.linalg.norm([x, y, z]):6.2f} m/s^2")
    return head + "\n" + "\n".join("".join(row) for row in canvas)


def render_png(vec, path: str) -> str:
    """The reference's exact 3-D figure (quiver from origin, ±10 limits,
    elev 20 / azim 45) rendered offscreen via Agg."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = normalize(vec)
    fig = plt.figure(figsize=(6, 5), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("X Acceleration")
    ax.set_ylabel("Y Acceleration")
    ax.set_zlabel("Z Acceleration")
    ax.set_xlim([-AXIS_LIM, AXIS_LIM])
    ax.set_ylim([-AXIS_LIM, AXIS_LIM])
    ax.set_zlim([-AXIS_LIM, AXIS_LIM])
    ax.view_init(elev=ELEV_DEG, azim=AZIM_DEG)
    ax.quiver(0, 0, 0, v[0], v[1], v[2], length=1.0, color="r")
    fig.savefig(path)
    plt.close(fig)
    return path


def accel_from_imu(imu_data: Optional[dict]) -> np.ndarray:
    """imu_visualizer.py:57-61: missing fields default to 0."""
    d = imu_data or {}
    return np.array([float(d.get("accel_x", 0.0)),
                     float(d.get("accel_y", 0.0)),
                     float(d.get("accel_z", 0.0))])


def run(get_imu_data: Callable[[], Optional[dict]],
        n_frames: Optional[int] = None,
        period_s: float = 0.1,
        on_frame: Optional[Callable[[np.ndarray], None]] = None):
    """The 100 ms update loop (imu_visualizer.py:74).  ``get_imu_data`` is
    any IMU source (``QuadPilotCamera.get_imu_data`` on hardware, the
    camera-sim endpoint on loopback).  Bounded via ``n_frames`` for tests;
    default rendering is an in-place terminal redraw."""
    i = 0
    last = np.zeros(3)
    while n_frames is None or i < n_frames:
        vec = accel_from_imu(get_imu_data())
        last = vec
        if on_frame is not None:
            on_frame(vec)
        else:
            sys.stdout.write("\x1b[H\x1b[2J" + render_terminal(vec) + "\n")
            sys.stdout.flush()
        i += 1
        if n_frames is None or i < n_frames:
            time.sleep(period_s)
    return last


def main(camera_ip: str = "192.168.0.131"):  # pragma: no cover - live app
    from ..sdk.camera import QuadPilotCamera

    cam = QuadPilotCamera(camera_ip)
    cam.connect()
    run(cam.get_imu_data)


if __name__ == "__main__":  # pragma: no cover
    main(*sys.argv[1:])
