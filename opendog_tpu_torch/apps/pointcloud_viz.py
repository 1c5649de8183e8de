"""Headless 3-D point-cloud visualizer for the SLAM stack.

Port of ``opendog_tpu/apps/pointcloud_viz.py`` (its numpy renderer is
copied; the CLI runs on the port's modules).  The reference renders its
live point clouds with a pyray window fed by a RealSense camera
(``examples/slam_visualizer.py``: voxel-downsampled cloud + orbiting 3-D
camera; ``slam_realtime.py``: the same view with cluster stats).  Without a
display or a depth camera this module provides the same capability as a
pure-software renderer:

  * :func:`render_cloud_frame` -- pinhole projection + z-buffer splatting
    of a world-frame point cloud from an orbiting camera, points colored
    by height, with the robot trajectory drawn as a polyline (numpy
    only; no GUI/display dependencies);
  * :func:`orbit_frames` -- a revolving fly-around (the pyray viewer's
    mouse-orbit, scripted);
  * CLI ``python -m opendog_tpu_torch.apps.pointcloud_viz`` -- builds a
    map with the mapping/localization stack over sim-rendered depth
    (apps/slam.py) and writes an orbit GIF; ``--serve`` streams the orbit
    as MJPEG over HTTP.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation (rows: right, down, forward)."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def _height_colors(z: np.ndarray) -> np.ndarray:
    """(N, 3) uint8 blue->green->red ramp over the cloud's z range."""
    lo, hi = np.percentile(z, 2), np.percentile(z, 98)
    t = np.clip((z - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    r = np.clip(1.5 * t - 0.25, 0, 1)
    g = 1.0 - np.abs(2.0 * t - 1.0) * 0.8
    b = np.clip(1.0 - 1.5 * t, 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


def project_points(points: np.ndarray, eye: np.ndarray, target: np.ndarray,
                   width: int, height: int, fov_deg: float = 60.0):
    """Pinhole projection.  Returns (u, v, depth, in_front mask)."""
    R = _look_at(np.asarray(eye, np.float64),
                 np.asarray(target, np.float64))
    pc = (np.asarray(points, np.float64) - eye) @ R.T
    z = pc[:, 2]
    ok = z > 0.05
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    u = (width / 2 + f * pc[:, 0] / np.maximum(z, 1e-6)).astype(np.int32)
    v = (height / 2 + f * pc[:, 1] / np.maximum(z, 1e-6)).astype(np.int32)
    ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return u, v, z, ok


def _splat(img, zbuf, u, v, z, colors, size: int = 1):
    """Nearest-depth-wins splatting (vectorised z-buffer)."""
    imgf = img.reshape(-1, 3)
    zbf = zbuf.reshape(-1)
    for du in range(-size + 1, size):
        for dv in range(-size + 1, size):
            uu = np.clip(u + du, 0, img.shape[1] - 1)
            vv = np.clip(v + dv, 0, img.shape[0] - 1)
            flat = (vv.astype(np.int64) * img.shape[1] + uu)
            # far->near write order resolves within-batch collisions;
            # the keep mask defers to anything already nearer in zbuf
            order = np.argsort(-z)
            fo, zo, co = flat[order], z[order], colors[order]
            keep = zo <= zbf[fo]
            imgf[fo[keep]] = co[keep]
            np.minimum.at(zbf, fo, zo)


def render_cloud_frame(points_world: np.ndarray,
                       traj_xy: Optional[np.ndarray] = None,
                       orbit_deg: float = 30.0,
                       elev: float = 0.6,
                       radius: Optional[float] = None,
                       width: int = 480, height: int = 360,
                       colors: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """One orbit-camera view of a world point cloud -> (H, W, 3) uint8.

    Points are height-colored (or take explicit per-point ``colors``
    (N, 3) uint8); ``traj_xy`` (T, 2) draws the robot's path in white
    on the ground plane."""
    pts = np.asarray(points_world, np.float64).reshape(-1, 3)
    if pts.shape[0] == 0:
        return np.zeros((height, width, 3), np.uint8)
    center = pts.mean(0)
    spread = float(np.percentile(
        np.linalg.norm(pts - center, axis=1), 95))
    r = radius if radius is not None else max(1.5 * spread, 0.5)
    a = np.radians(orbit_deg)
    eye = center + np.array([r * np.cos(a), r * np.sin(a), elev * r])

    img = np.zeros((height, width, 3), np.uint8)
    img[:] = (12, 14, 22)  # dark background, pyray-viewer style
    zbuf = np.full((height, width), np.inf)
    u, v, z, ok = project_points(pts, eye, center, width, height)
    cols = (_height_colors(pts[:, 2]) if colors is None
            else np.asarray(colors, np.uint8))
    _splat(img, zbuf, u[ok], v[ok], z[ok], cols[ok])
    if traj_xy is not None and len(traj_xy):
        tr = np.asarray(traj_xy, np.float64)
        tr3 = np.concatenate(
            [tr, np.full((len(tr), 1), float(pts[:, 2].min()))], 1)
        # densify the polyline so it reads as a line after projection
        dense = []
        for a3, b3 in zip(tr3[:-1], tr3[1:]):
            dense.append(np.linspace(a3, b3, 12))
        dense = np.concatenate(dense) if dense else tr3
        u, v, z, ok = project_points(dense, eye, center, width, height)
        white = np.full((int(ok.sum()), 3), 255, np.uint8)
        _splat(img, zbuf, u[ok], v[ok], z[ok] - 0.05, white)
    return img


def orbit_frames(points_world: np.ndarray,
                 traj_xy: Optional[np.ndarray] = None,
                 n_frames: int = 36, **kw) -> Iterator[np.ndarray]:
    """Full revolution around the cloud (the scripted mouse-orbit)."""
    for k in range(n_frames):
        yield render_cloud_frame(points_world, traj_xy,
                                 orbit_deg=360.0 * k / n_frames, **kw)


def voxel_downsample(points: np.ndarray, voxel_m: float = 0.06
                     ) -> np.ndarray:
    """One representative point per occupied voxel — the reference
    viewer's per-frame downsampling (slam_visualizer.py's defaultdict
    voxel grid), vectorised."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    keys = np.floor(pts / voxel_m).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(idx)]


def serve_mjpeg_frames(frame_fn, port: int, fps: float = 8.0):
    """Minimal MJPEG-over-HTTP loop for a frame source ``frame_fn(i) ->
    (H, W, 3) uint8`` — the live-window substitute the sim viewer also
    uses (telemetry/viewer.py's display pattern, standalone here)."""
    import io
    import time as _time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from PIL import Image

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type",
                             "multipart/x-mixed-replace; boundary=f")
            self.end_headers()
            i = 0
            try:
                while True:
                    buf = io.BytesIO()
                    Image.fromarray(frame_fn(i)).save(buf, "JPEG")
                    jpg = buf.getvalue()
                    self.wfile.write(
                        b"--f\r\nContent-Type: image/jpeg\r\n"
                        + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                        + jpg + b"\r\n")
                    i += 1
                    _time.sleep(1.0 / fps)
            except (BrokenPipeError, ConnectionResetError):
                pass

    ThreadingHTTPServer(("0.0.0.0", port), H).serve_forever()


def main(argv=None):
    """Renders 24 depth frames along a straight walk over the generated
    terrain of ``--seed``, maps them into one world cloud, and writes its
    orbit as ``orbit.gif`` under ``--out`` (``imageio``)."""
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="runs/torch_slam_viz")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--seed", type=int, default=3,
                    help="torch.Generator seed of the terrain")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--serve", type=int, default=0,
                    help="port > 0: loop the orbit as an MJPEG stream")
    args = ap.parse_args(argv)

    import torch

    from ..assets import load_opendog
    from ..physics import terrain as terrain_lib
    from .mapping import transform_points
    from .slam import CamConfig, render_depth

    m = load_opendog("terrain", device=args.device)
    terr = terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(args.seed))
    cam = CamConfig()
    cloud, traj = [], []
    pose = np.array([0.0, 0.0, 0.0], np.float32)
    for _ in range(24):
        pts = render_depth(m, terr, pose, cam=cam)
        pts = pts[torch.isfinite(pts).all(1)]
        cloud.append(transform_points(pts, pose).cpu().numpy())
        traj.append(pose[:2].copy())
        pose = pose + np.array([0.06, 0.0, 0.05], np.float32)
    pts = voxel_downsample(np.concatenate(cloud))
    os.makedirs(args.out, exist_ok=True)
    frames = list(orbit_frames(pts, np.asarray(traj), args.frames))
    import imageio.v2 as imageio  # gated

    gif = os.path.join(args.out, "orbit.gif")
    imageio.mimsave(gif, frames, duration=0.12)
    print(f"wrote {gif} ({len(frames)} frames, "
          f"{pts.shape[0]} map points)")
    if args.serve:
        serve_mjpeg_frames(lambda i: frames[i % len(frames)],
                           port=args.serve)


if __name__ == "__main__":
    main()
