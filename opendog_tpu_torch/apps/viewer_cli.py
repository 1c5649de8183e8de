"""Keyboard driver for the interactive headless viewer (the displayless
analog of the reference's forked GUI viewer controls,
``test/viewer.py:382-387``; VERDICT r3 item 6).

Runs a :class:`SimViewer` standing-hold sim, serves the live MJPEG render
(open ``http://localhost:<port>/stream`` in a browser — the display), and
reads line commands from stdin:

    p                pause          (spacebar)
    r                resume
    s [N]            step N ticks while paused   (right-arrow)
    push FX FY FZ    apply a 0.1 s trunk force [N]      (mouse drag)
    twist TX TY TZ   apply a 0.1 s trunk torque [N m]
    drop Z           teleport the trunk to height Z [m] (slider)
    state            print trunk pose
    q                quit

Port of the JAX package's ``apps/viewer_cli.py``: the viewer runs on CUDA
unless ``--device cpu`` (``device="cpu"``) is given.

Usage: python -m opendog_tpu_torch.apps.viewer_cli [--robot go1|opendog]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_viewer(robot: str = "opendog", rate_hz: float = 50.0,
                 telemetry_port: int = 0, device=None, graphs: bool = True):
    """A flat-ground viewer of ``robot`` holding its home control; see
    :class:`~..telemetry.viewer.SimViewer` for ``device`` and ``graphs``."""
    from ..assets import load_go1, load_opendog
    from ..device import resolve_device
    from ..physics import make_state
    from ..telemetry.viewer import SimViewer

    dev = resolve_device(device)
    model = (load_go1("flat", device=dev) if robot == "go1"
             else load_opendog("flat", device=dev))
    state = make_state(model, "home")
    hold = model.key_ctrl[0]
    return SimViewer(model, state, lambda st, t: hold, rate_hz=rate_hz,
                     telemetry_port=telemetry_port, device=dev,
                     graphs=graphs)


def handle(viewer, line: str) -> str:
    """One CLI command against the viewer; returns the reply text."""
    parts = line.strip().split()
    if not parts:
        return ""
    cmd, args = parts[0].lower(), parts[1:]
    if cmd == "p":
        viewer.pause()
        return "paused"
    if cmd == "r":
        viewer.resume()
        return "resumed"
    if cmd == "s":
        n = int(args[0]) if args else 1
        if not viewer.paused:
            return "pause first (p)"
        st = viewer.step_once(n)
        return f"stepped {n}: t={float(st.time):.3f}"
    if cmd == "push":
        f = [float(a) for a in args] + [0.0] * (3 - len(args))
        viewer.apply_wrench(force=f[:3])
        return f"push {f[:3]} N for 0.1 s"
    if cmd == "twist":
        t = [float(a) for a in args] + [0.0] * (3 - len(args))
        viewer.apply_wrench(torque=t[:3])
        return f"twist {t[:3]} N m for 0.1 s"
    if cmd == "drop":
        z = float(args[0])
        st = viewer.snapshot()
        qpos = np.asarray(st.qpos).copy()
        qpos[2] = z
        viewer.set_state(qpos=qpos)
        return f"trunk z set to {z}"
    if cmd == "state":
        st = viewer.snapshot()
        q = np.asarray(st.qpos)
        return (f"t={float(st.time):.2f} x={q[0]:.3f} z={q[2]:.3f} "
                f"quat_w={q[3]:.3f} paused={viewer.paused}")
    if cmd == "q":
        return "quit"
    return f"unknown command: {cmd}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", choices=["opendog", "go1"],
                    default="opendog")
    ap.add_argument("--mjpeg_port", type=int, default=8081)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    viewer = build_viewer(args.robot, device=args.device).launch()
    port = viewer.start_mjpeg(args.mjpeg_port)
    print(f"live render: http://localhost:{port}/stream  "
          f"(single frame: /frame)")
    print("commands: p r s [N] | push FX FY FZ | twist TX TY TZ | "
          "drop Z | state | q")
    try:
        for line in sys.stdin:
            reply = handle(viewer, line)
            print(reply, flush=True)
            if reply == "quit":
                break
    finally:
        viewer.close()


if __name__ == "__main__":
    main()
