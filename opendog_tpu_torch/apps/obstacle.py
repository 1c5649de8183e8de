"""Perception-driven obstacle avoidance.

Port of ``opendog_tpu/apps/obstacle.py``, the control core of
``Code/examples/obstacle.py``: a voxel-clustering obstacle detector over
depth point clouds (process_points_gpu, obstacle.py:120), here on tensors
with exact integer counts on every device, and the IDLE/WALKING/AVOIDING
state machine steering around obstacles via target-yaw offsets
(robot_control_thread_func, obstacle.py:199-262), host-side numpy as in
the reference.  The RealSense capture and pyray visualisation of the
reference are hardware/display-bound; the detector takes any (N, 3) point
cloud.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch


def detect_obstacles(
    points,
    voxel_size: float = 0.05,
    min_points_per_voxel: int = 5,
    max_range: float = 2.0,
    height_band: Tuple[float, float] = (-0.1, 0.5),
    grid_extent: float = 2.0,
):
    """Voxel-occupancy obstacle detection (obstacle.py:120 semantics):
    bin points (N, 3) into a 2-D ground-plane grid, threshold occupancy,
    return (centers (M, 2), counts (M,) int32) of every cell as a
    fixed-size masked array (centers of unoccupied cells are NaN), on the
    points' device (a numpy cloud is taken to the CPU)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    r = torch.sqrt(torch.sum(pts[:, :2] * pts[:, :2], dim=1))
    valid = (
        (r < max_range)
        & (pts[:, 2] > height_band[0])
        & (pts[:, 2] < height_band[1])
    )
    n_cells = int(2 * grid_extent / voxel_size)
    ij = torch.clamp(
        ((pts[:, :2] + grid_extent) / voxel_size).to(torch.int32),
        0, n_cells - 1,
    ).long()
    flat = ij[:, 0] * n_cells + ij[:, 1]
    counts = torch.zeros(n_cells * n_cells, dtype=torch.int32,
                         device=pts.device).index_add_(
        0, flat, valid.to(torch.int32))
    occupied = counts >= min_points_per_voxel
    idx = torch.arange(n_cells * n_cells, device=pts.device)
    cx = (idx // n_cells).to(torch.float32) * voxel_size - grid_extent \
        + voxel_size / 2
    cy = (idx % n_cells).to(torch.float32) * voxel_size - grid_extent \
        + voxel_size / 2
    centers = torch.stack([cx, cy], dim=1)
    centers = torch.where(occupied[:, None], centers, torch.nan)
    return centers, counts


class AvoidState(enum.Enum):
    IDLE = "IDLE"
    WALKING = "WALKING"
    AVOIDING = "AVOIDING"


@dataclass
class ObstacleAvoider:
    """The steering state machine (obstacle.py:199-262): walk straight at
    the target yaw; when an obstacle lies within ``trigger_dist`` of the
    heading corridor, offset the target yaw away from it until clear."""

    trigger_dist: float = 0.8
    corridor_halfwidth: float = 0.25
    avoid_yaw_offset_deg: float = 35.0
    state: AvoidState = AvoidState.IDLE
    base_target_yaw: float = 0.0
    target_yaw: float = 0.0
    # dead-reckoned pose (obstacle.py keeps a path estimate)
    path: List[Tuple[float, float]] = field(default_factory=list)

    def start(self, target_yaw: float = 0.0):
        self.state = AvoidState.WALKING
        self.base_target_yaw = target_yaw
        self.target_yaw = target_yaw

    def stop(self):
        self.state = AvoidState.IDLE

    def update(self, obstacle_centers: np.ndarray,
               yaw_deg: float) -> float:
        """One control update: returns the target yaw to feed the
        auto-correct walk.  ``obstacle_centers`` are (M, 2) robot-frame
        points (NaN rows ignored)."""
        if self.state == AvoidState.IDLE:
            return self.target_yaw
        pts = np.asarray(obstacle_centers)
        pts = pts[np.isfinite(pts).all(axis=1)] if pts.size else pts
        blocking = None
        if pts.size:
            ahead = pts[(pts[:, 0] > 0.05) & (pts[:, 0] < self.trigger_dist)]
            in_corridor = ahead[
                np.abs(ahead[:, 1]) < self.corridor_halfwidth
            ] if ahead.size else ahead
            if in_corridor.size:
                blocking = in_corridor[np.argmin(in_corridor[:, 0])]
        if blocking is not None:
            self.state = AvoidState.AVOIDING
            # steer away from the obstacle's side
            sign = -1.0 if blocking[1] >= 0 else 1.0
            self.target_yaw = self.base_target_yaw + sign * self.avoid_yaw_offset_deg
        elif self.state == AvoidState.AVOIDING:
            self.state = AvoidState.WALKING
            self.target_yaw = self.base_target_yaw
        return self.target_yaw


def render_avoidance_frame(points_robot: np.ndarray,
                           obstacle_centers: np.ndarray,
                           avoider: "ObstacleAvoider",
                           orbit_deg: float = 210.0,
                           width: int = 480, height: int = 360
                           ) -> np.ndarray:
    """Headless scene view of the avoidance loop — the display half of the
    reference's pyray window (obstacle.py's live cloud + cluster + robot
    view), rendered by the point-cloud visualizer:

      * scene cloud height-colored,
      * detected obstacle cells as RED pillars,
      * the heading corridor as two WHITE rails from the robot,
      * the robot as a GREEN pillar at the origin.

    All robot-frame; returns (H, W, 3) uint8 (stream with
    ``pointcloud_viz.serve_mjpeg_frames`` for the live-window analog)."""
    from .pointcloud_viz import render_cloud_frame

    pts = np.asarray(points_robot, np.float64).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(1)]
    from .pointcloud_viz import _height_colors

    parts = [pts]
    cols = [_height_colors(pts[:, 2]) if len(pts) else
            np.zeros((0, 3), np.uint8)]
    cen = np.asarray(obstacle_centers)
    cen = cen[np.isfinite(cen).all(1)] if cen.size else cen.reshape(0, 2)
    if len(cen):
        zs = np.linspace(0.0, 0.35, 8)
        pillars = np.concatenate(
            [np.concatenate([np.repeat(cen, len(zs), 0),
                             np.tile(zs, len(cen))[:, None]], 1)])
        parts.append(pillars)
        cols.append(np.tile(np.array([[255, 60, 50]], np.uint8),
                            (len(pillars), 1)))
    # heading corridor rails (robot frame: +x is the walk direction)
    xs = np.linspace(0.05, avoider.trigger_dist, 20)
    for side in (-1.0, 1.0):
        rail = np.stack([xs, np.full_like(xs, side
                                          * avoider.corridor_halfwidth),
                         np.full_like(xs, 0.02)], 1)
        parts.append(rail)
        cols.append(np.tile(np.array([[235, 235, 235]], np.uint8),
                            (len(rail), 1)))
    robot = np.stack([np.zeros(6), np.zeros(6),
                      np.linspace(0.0, 0.25, 6)], 1)
    parts.append(robot)
    cols.append(np.tile(np.array([[60, 255, 80]], np.uint8), (6, 1)))
    allpts = np.concatenate(parts)
    allcols = np.concatenate(cols)
    return render_cloud_frame(allpts, orbit_deg=orbit_deg,
                              width=width, height=height,
                              colors=allcols)
