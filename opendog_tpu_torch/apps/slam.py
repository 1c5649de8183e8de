"""Terrain-relative localization: the SLAM pose-correction layer.

Port of ``opendog_tpu/apps/slam.py``.  The reference runs RTAB-Map SLAM
over a RealSense L515 (``Code/SLAM.md:1-123``, ``examples/
slam_realtime.py``): pose-graph localization correcting dead reckoning.
This module closes the loop on the simulated heightfield:

  * ``render_depth``       -- synthetic depth from the sim: camera rays
                              marched against the bilinear heightfield (48
                              coarse samples of every ray as one batch,
                              then 12 bisection steps), for one pose or a
                              batch of poses;
  * ``point_to_plane_icp`` -- scan-to-map point-to-plane ICP over the planar
                              pose (x, y, yaw): Gauss-Newton with projective
                              association onto the heightfield surface,
                              the Jacobian from ``torch.func.jacfwd``;
  * ``TerrainLocalizer``   -- dead-reckoner prediction + ICP correction;
  * ``simulate_walk_localization`` -- a simulated walk with biased
                              odometry, reporting trajectory RMSE for dead
                              reckoning against ICP-corrected.

Functions on tensors run where their inputs live; ``simulate_walk_
localization`` runs on the model's device.  On featureless (flat) terrain
the ICP normal equations are singular in (x, y); Levenberg damping then
leaves the pose at the odometry prediction.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..physics.dynamics import _terrain_height_normal
from ..physics.model import Terrain
from ..physics.terrain import linspace
from .mapping import DeadReckoner


class CamConfig(NamedTuple):
    """Depth camera intrinsics/mount (L515-ish field of view, decimated)."""

    width: int = 32
    height: int = 24
    fov_x_deg: float = 70.0
    cam_height: float = 0.25      # mount height above the trunk origin
    pitch_deg: float = 35.0       # downward pitch
    max_range: float = 4.0


def _ray_grid(cam: CamConfig) -> np.ndarray:
    """(H*W, 3) unit ray directions in the camera frame (x fwd, z up)."""
    fx = 0.5 * cam.width / np.tan(np.radians(cam.fov_x_deg) / 2)
    u = np.arange(cam.width) - (cam.width - 1) / 2
    v = np.arange(cam.height) - (cam.height - 1) / 2
    uu, vv = np.meshgrid(u, v)
    d = np.stack([np.full_like(uu, fx), -uu, -vv], axis=-1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.radians(cam.pitch_deg)
    # pitch DOWN about +y: x-forward rays acquire a negative z component
    Rp = np.array([[np.cos(p), 0, np.sin(p)],
                   [0, 1, 0],
                   [-np.sin(p), 0, np.cos(p)]])
    return (d @ Rp.T).astype(np.float32)


def _as_pose(pose_xy_yaw, device) -> torch.Tensor:
    return torch.as_tensor(pose_xy_yaw, dtype=torch.float32, device=device)


def render_depth(model, terrain: Terrain, pose_xy_yaw,
                 cam: CamConfig = CamConfig(), coarse: int = 48,
                 bisect: int = 12) -> torch.Tensor:
    """Ray-march the heightfield from a camera at planar ``pose`` (3,) ->
    (H*W, 3) hit points in the ROBOT frame (NaN rows = no hit in range);
    poses (B, 3) give (B, H*W, 3), each frame that of its own pose.
    Computed on the terrain's device.

    Robot frame: world translated by (-x, -y, 0) and rotated by -yaw; z
    stays absolute (a legged robot knows its height from kinematics)."""
    dev = terrain.height.device
    pose = _as_pose(pose_xy_yaw, dev)
    x, y, yaw = pose[..., 0], pose[..., 1], pose[..., 2]  # (...)
    # cos and sin rounded from float64, and the rotation written out: the
    # same bits on every device, and JAX's op-by-op product bit for bit (a
    # bisection step turns one ulp into a final interval, 2e-5 m)
    c = torch.cos(yaw.double()).float()[..., None]
    s = torch.sin(yaw.double()).float()[..., None]
    dr = torch.from_numpy(_ray_grid(cam)).to(dev)         # (R, 3)
    # robot->world rotation about z, (..., R, 3)
    dirs_w = torch.stack([dr[:, 0] * c - dr[:, 1] * s,
                          dr[:, 0] * s + dr[:, 1] * c,
                          dr[:, 2].expand(c.shape[:-1] + dr.shape[:1])], -1)
    # camera sits cam_height above the LOCAL terrain (the robot stands on it)
    h0, _ = _terrain_height_normal(model, terrain, pose[..., None, :2])
    origin = torch.stack([x, y, h0[..., 0] + cam.cam_height], -1)  # (..., 3)
    origin = origin[..., None, :]                         # (..., 1, 3)

    ts = linspace(0.05, cam.max_range, coarse, dev)

    def sdf(t, d):
        """Height above the terrain of the points ``t`` (..., R, k) along
        the rays ``d`` (..., R, 3)."""
        p = origin[..., None, :] + t[..., None] * d[..., None, :]
        h, _ = _terrain_height_normal(model, terrain, p[..., :2])
        return p[..., 2] - h

    phis = sdf(ts.expand(dirs_w.shape[:-1] + (coarse,)), dirs_w)
    # first coarse interval with a sign change (above -> below)
    hit = (phis[..., :-1] > 0) & (phis[..., 1:] <= 0)
    idx = torch.argmax(hit.to(torch.int32), dim=-1)       # (..., R)
    found = torch.any(hit, dim=-1)
    lo, hi = ts[idx], ts[idx + 1]
    for _ in range(bisect):
        mid = 0.5 * (lo + hi)
        above = sdf(mid[..., None], dirs_w)[..., 0] > 0
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    t_hit = 0.5 * (lo + hi)
    p_w = origin + t_hit[..., None] * dirs_w
    p_w = torch.where(found[..., None], p_w, torch.nan)
    # world -> robot frame
    rel = p_w - torch.stack([x, y, torch.zeros_like(x)], -1)[..., None, :]
    return torch.stack([c * rel[..., 0] + s * rel[..., 1],
                        -s * rel[..., 0] + c * rel[..., 1],
                        rel[..., 2]], -1)


def icp_residuals(model, terrain: Terrain, pts: torch.Tensor,
                  pose: torch.Tensor) -> torch.Tensor:
    """(N,) point-to-plane residuals of robot-frame points ``pts`` (N, 3,
    finite) under ``pose`` (3,): ``n_z(q) * (p_z - h(q))`` at the vertical
    projection ``q`` of each transformed point onto the heightfield."""
    x, y, yaw = pose[0], pose[1], pose[2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = c * pts[:, 0] - s * pts[:, 1] + x
    py = s * pts[:, 0] + c * pts[:, 1] + y
    h, n = _terrain_height_normal(model, terrain,
                                  torch.stack([px, py], dim=-1))
    return n[:, 2] * (pts[:, 2] - h)


def point_to_plane_icp(model, terrain: Terrain, points_robot: torch.Tensor,
                       pose_init, iters: int = 10,
                       damping: float = 1e-3,
                       huber_delta: float = 0.08):
    """Scan-to-map point-to-plane ICP over the planar pose -> (pose (3,),
    rms ()) on the points' device.

    Residual per point: ``n(q)·(T_pose(p) - q)`` with ``q`` the vertical
    projection of the transformed point onto the heightfield and ``n`` its
    surface normal (projective data association, recomputed every
    Gauss-Newton iteration).  Huber weights bound outlier influence; the
    3x3 normal equations get Levenberg damping so featureless terrain
    degrades to the initial pose instead of exploding.  ``rms`` is the
    weighted residual of the last iteration, before its update."""
    pts = points_robot
    finite = torch.isfinite(pts).all(dim=1)
    pts = torch.where(finite[:, None], pts, 0.0)
    finite = finite.to(pts.dtype)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    residuals = functools.partial(icp_residuals, model, terrain, pts)
    jacobian = torch.func.jacfwd(residuals)
    pose = _as_pose(pose_init, pts.device)
    rms = None
    for _ in range(iters):
        r = residuals(pose)
        J = jacobian(pose)                         # (N, 3)
        w = finite / torch.clamp(torch.abs(r) / huber_delta, min=1.0)
        JtJ = (J * w[:, None]).T @ J + damping * eye
        Jtr = (J * w[:, None]).T @ r
        delta = torch.linalg.solve(JtJ, Jtr)
        pose = pose - delta
        rms = torch.sqrt(torch.mean(w * r ** 2))
    return pose, rms


class TerrainLocalizer:
    """Dead-reckoner prediction + ICP correction (the RTAB-Map role), on
    the terrain's device."""

    def __init__(self, model, terrain: Terrain, cam: CamConfig = CamConfig(),
                 iters: int = 10):
        self.model = model
        self.terrain = terrain
        self.cam = cam
        self.iters = iters
        self.reckoner = DeadReckoner()
        self.pose = np.zeros(3, np.float32)

    def update(self, vx: float, vy: float, yaw_deg: float, dt: float,
               points_robot=None) -> Tuple[np.ndarray, float]:
        """Odometry prediction, then (when a depth frame (N, 3) is given,
        tensor or numpy) ICP correction.  Returns (pose (x, y, yaw),
        icp_rms)."""
        # predict: integrate odometry velocities from the CURRENT estimate
        # (DeadReckoner semantics, obstacle.py path estimate)
        self.reckoner.x, self.reckoner.y = float(self.pose[0]), float(
            self.pose[1])
        pred = np.asarray(
            self.reckoner.update(vx, vy, yaw_deg, dt), np.float32)
        rms = float("nan")
        if points_robot is not None:
            pts = torch.as_tensor(points_robot, dtype=torch.float32,
                                  device=self.terrain.height.device)
            corrected, rms_t = point_to_plane_icp(
                self.model, self.terrain, pts, pred, iters=self.iters)
            pred = corrected.cpu().numpy()
            rms = float(rms_t)
        self.pose = pred
        return self.pose, rms


def simulate_walk_localization(
    model, terrain: Terrain, n_steps: int = 40, dt: float = 0.1,
    v_true: float = 0.25, odom_bias: float = 0.25, yaw_noise_deg: float = 1.5,
    depth_noise_m: float = 0.01, cam: CamConfig = CamConfig(), seed: int = 0,
    frames: Optional[list] = None,
):
    """A simulated walk whose odometry is biased (scale error) and
    yaw-noisy; depth frames are rendered from the TRUE pose with
    ``depth_noise_m`` Gaussian sensor noise (numpy draws from ``seed``, as
    in the reference).  Returns trajectory-error metrics for the open-loop
    dead reckoner against the ICP-corrected localizer.  ``frames``, when
    given a list, receives each step's (true pose, noisy robot-frame
    frame), numpy."""
    rng = np.random.default_rng(seed)
    loc = TerrainLocalizer(model, terrain, cam=cam)
    reck = DeadReckoner()
    dev = terrain.height.device

    gt = np.zeros((n_steps, 3), np.float32)
    est_dr = np.zeros_like(gt)
    est_icp = np.zeros_like(gt)
    for k in range(n_steps):
        t = (k + 1) * dt
        yaw_true = 0.15 * np.sin(0.5 * t)          # gentle S-curve heading
        gt[k] = [gt[k - 1][0] + v_true * dt * np.cos(yaw_true) if k else
                 v_true * dt * np.cos(yaw_true),
                 gt[k - 1][1] + v_true * dt * np.sin(yaw_true) if k else
                 v_true * dt * np.sin(yaw_true),
                 yaw_true]
        v_odom = v_true * (1.0 + odom_bias)        # biased speed estimate
        yaw_odom_deg = np.degrees(yaw_true) + rng.normal(0, yaw_noise_deg)
        est_dr[k] = reck.update(v_odom, 0.0, yaw_odom_deg, dt)
        frame = render_depth(model, terrain, torch.from_numpy(gt[k]).to(dev),
                             cam=cam).cpu().numpy()
        frame = (frame + rng.normal(0, depth_noise_m, frame.shape)).astype(
            np.float32)
        if frames is not None:
            frames.append((gt[k].copy(), frame))
        pose, _ = loc.update(v_odom, 0.0, yaw_odom_deg, dt,
                             points_robot=frame)
        est_icp[k] = pose

    def rmse(est):
        return float(np.sqrt(np.mean(np.sum(
            (est[:, :2] - gt[:, :2]) ** 2, axis=1))))

    return {
        "steps": n_steps,
        "distance_m": round(float(v_true * dt * n_steps), 3),
        "deadreckon_rmse_m": round(rmse(est_dr), 4),
        "icp_rmse_m": round(rmse(est_icp), 4),
        "deadreckon_final_err_m": round(float(np.linalg.norm(
            est_dr[-1, :2] - gt[-1, :2])), 4),
        "icp_final_err_m": round(float(np.linalg.norm(
            est_icp[-1, :2] - gt[-1, :2])), 4),
        "icp_beats_deadreckon": bool(rmse(est_icp) < rmse(est_dr)),
    }
