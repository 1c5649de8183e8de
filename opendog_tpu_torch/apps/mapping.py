"""Point-cloud mapping: the SLAM-adjacent utilities.

Port of ``opendog_tpu/apps/mapping.py``.  The reference's SLAM layer
(``examples/slam_realtime.py``, ``slam_visualizer.py``, ``Code/SLAM.md``)
streams RealSense L515 depth into voxel maps; the sensor and the GL viewers
are hardware-bound, and this module carries the portable core on tensors:

  * ``VoxelMap``         -- occupancy counts (int32, on a device)
                            accumulated from depth point clouds under a
                            dead-reckoned pose; integer sums are exact, so
                            every device gives the same counts;
  * ``transform_points`` -- robot-frame -> world-frame cloud transform;
  * ``DeadReckoner``     -- host-side velocity integration, as in the
                            reference.

A RealSense grabber is provided behind an optional import (``pyrealsense2``
is not installed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def transform_points(points_robot: torch.Tensor, pose_xy_yaw
                     ) -> torch.Tensor:
    """(N, 3) robot-frame points -> world frame under (x, y, yaw), on the
    points' device."""
    pose = torch.as_tensor(pose_xy_yaw, dtype=torch.float32,
                           device=points_robot.device)
    x, y, yaw = pose[0], pose[1], pose[2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    xy = points_robot[:, :2] @ R.T + torch.stack([x, y])
    return torch.cat([xy, points_robot[:, 2:3]], dim=1)


@dataclass
class VoxelMap:
    """Occupancy counts over a fixed world grid, on ``device`` (CUDA unless
    the caller names another)."""

    extent: float = 5.0
    voxel: float = 0.1
    height_band: Tuple[float, float] = (0.02, 0.8)
    counts: Optional[torch.Tensor] = None
    device: Optional[object] = None

    def __post_init__(self):
        n = int(2 * self.extent / self.voxel)
        if self.counts is None:
            self.counts = torch.zeros((n, n), dtype=torch.int32,
                                      device=resolve_device(self.device))
        self.device = self.counts.device

    def integrate(self, points_world) -> "VoxelMap":
        """A new map with the in-band points of ``points_world`` (N, 3)
        added (NaN rows add nothing)."""
        pts = torch.as_tensor(points_world, dtype=torch.float32,
                              device=self.counts.device)
        n = self.counts.shape[0]
        valid = (
            (torch.abs(pts[:, 0]) < self.extent)
            & (torch.abs(pts[:, 1]) < self.extent)
            & (pts[:, 2] > self.height_band[0])
            & (pts[:, 2] < self.height_band[1])
        )
        ij = torch.clamp(((pts[:, :2] + self.extent) / self.voxel).to(
            torch.int32), 0, n - 1).long()
        counts = self.counts.index_put((ij[:, 0], ij[:, 1]),
                                       valid.to(torch.int32), accumulate=True)
        return VoxelMap(self.extent, self.voxel, self.height_band, counts)

    def occupied(self, threshold: int = 3) -> np.ndarray:
        """(M, 2) world xy centers of occupied voxels (host-side)."""
        c = self.counts.cpu().numpy()
        ii, jj = np.nonzero(c >= threshold)
        return np.stack(
            [ii * self.voxel - self.extent + self.voxel / 2,
             jj * self.voxel - self.extent + self.voxel / 2], axis=1
        )


@dataclass
class DeadReckoner:
    """Velocity-integrated planar pose estimate (obstacle.py's path
    estimate + run_robot.py's damped velocity integration)."""

    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0

    def update(self, vx: float, vy: float, yaw_deg: float, dt: float):
        self.yaw = np.radians(yaw_deg)
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        self.x += (vx * c - vy * s) * dt
        self.y += (vx * s + vy * c) * dt
        return (self.x, self.y, self.yaw)


def make_realsense_source(width: int = 640, height: int = 480, fps: int = 30):
    """Optional RealSense L515 depth source (SLAM.md pipeline); raises
    ImportError when pyrealsense2 is absent."""
    import pyrealsense2 as rs  # gated

    pipeline = rs.pipeline()
    cfg = rs.config()
    cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    pipeline.start(cfg)
    pc = rs.pointcloud()

    def grab() -> np.ndarray:
        frames = pipeline.wait_for_frames()
        depth = frames.get_depth_frame()
        points = pc.calculate(depth)
        v = np.asanyarray(points.get_vertices()).view(np.float32)
        return v.reshape(-1, 3)

    return grab
