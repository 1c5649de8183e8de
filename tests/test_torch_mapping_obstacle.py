"""Mapping, obstacles and the headless viewers of the port against the JAX
package: ``transform_points``, the ``VoxelMap`` and ``detect_obstacles``
counts (integer sums: equal exactly), the dead reckoner, the
``ObstacleAvoider`` state machine and ``render_avoidance_frame`` (bytes
equal), the point-cloud viewer (``apps/pointcloud_viz.py``, its CLI on the
CPU) and the depth display loop (``apps/depth.py``)."""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.apps import depth as jdepth
from opendog_tpu.apps import mapping as jmapping
from opendog_tpu.apps import obstacle as jobstacle
from opendog_tpu.apps import pointcloud_viz as jviz
from opendog_tpu.physics.terrain import generate_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.apps import depth, mapping, obstacle, pointcloud_viz
from opendog_tpu_torch.apps import slam
from opendog_tpu_torch.physics import terrain_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walk_cloud():
    """World-frame points of six frames along a walk over the generated
    terrain of PRNGKey(0), the port's render (the JAX one reads the same,
    tests/test_torch_slam.py), with random points mixed in, and the
    robot-frame frames."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    tt = terrain_from_numpy(np.asarray(
        generate_terrain(jax.random.PRNGKey(0), jm).height), "cpu")
    poses = [np.array([0.06 * k, 0.02 * k, 0.05 * k], np.float32)
             for k in range(6)]
    frames = [slam.render_depth(m, tt, p).numpy() for p in poses]
    rng = np.random.default_rng(4)
    extra = np.stack([rng.uniform(-6, 6, 3000), rng.uniform(-6, 6, 3000),
                      rng.uniform(-0.3, 1.0, 3000)], 1).astype(np.float32)
    return poses, frames, extra


def test_transform_points_matches_jax(walk_cloud):
    poses, frames, _ = walk_cloud
    for pose, frame in zip(poses, frames):
        want = np.asarray(jmapping.transform_points(jnp.asarray(frame),
                                                    pose))
        got = mapping.transform_points(torch.from_numpy(frame), pose)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   equal_nan=True)
    out = mapping.transform_points(torch.tensor([[1.0, 0.0, 0.1]]),
                                   (0.0, 0.0, np.pi / 2))
    np.testing.assert_allclose(out[0].numpy(), [0.0, 1.0, 0.1], atol=1e-6)


@pytest.mark.parametrize("extent,voxel", [(5.0, 0.1), (2.0, 0.5)])
def test_voxel_map_counts_equal_jax(walk_cloud, extent, voxel):
    """Integrated frame by frame (NaN rows and out-of-band points add
    nothing): the int32 counts equal, and so do the occupied centers."""
    poses, frames, extra = walk_cloud
    vm = mapping.VoxelMap(extent=extent, voxel=voxel, device="cpu")
    jvm = jmapping.VoxelMap(extent=extent, voxel=voxel)
    for pose, frame in zip(poses, frames):
        world = np.asarray(jmapping.transform_points(jnp.asarray(frame),
                                                     pose))
        vm = vm.integrate(torch.tensor(world))
        jvm = jvm.integrate(jnp.asarray(world))
    vm = vm.integrate(extra)            # numpy points are taken too
    jvm = jvm.integrate(jnp.asarray(extra))
    assert vm.counts.dtype == torch.int32
    np.testing.assert_array_equal(vm.counts.numpy(), np.asarray(jvm.counts))
    assert int(vm.counts.sum()) > 100
    for thr in (1, 3):
        np.testing.assert_array_equal(vm.occupied(thr), jvm.occupied(thr))


def test_voxel_map_filters_below_ground():
    vm = mapping.VoxelMap(extent=2.0, voxel=0.5, device="cpu")
    vm = vm.integrate(torch.tensor([[1.1, -0.6, 0.3]]).repeat(10, 1))
    occ = vm.occupied(threshold=3)
    assert len(occ) == 1
    assert abs(occ[0][0] - 1.25) < 0.26 and abs(occ[0][1] + 0.75) < 0.26
    vm2 = mapping.VoxelMap(extent=2.0, voxel=0.5, device="cpu").integrate(
        torch.tensor([[1.1, -0.6, -0.5]]).repeat(10, 1))
    assert len(vm2.occupied(threshold=3)) == 0


def test_dead_reckoner_matches_jax():
    dr, jdr = mapping.DeadReckoner(), jmapping.DeadReckoner()
    rng = np.random.default_rng(0)
    for _ in range(20):
        vx, vy, yaw, dt = rng.normal(size=4)
        assert dr.update(vx, vy, 30 * yaw, 0.1) == jdr.update(
            vx, vy, 30 * yaw, 0.1)


def _obstacle_clouds(walk_cloud):
    """Robot-frame clouds: the rendered frames, and a box-shaped obstacle
    ahead on either side over random ground clutter."""
    _, frames, _ = walk_cloud
    rng = np.random.default_rng(5)
    out = list(frames[:3])
    for side in (0.1, -0.1, 0.6):
        box = np.stack([rng.uniform(0.4, 0.55, 400),
                        rng.uniform(side - 0.1, side + 0.1, 400),
                        rng.uniform(0.0, 0.4, 400)], 1)
        clutter = np.stack([rng.uniform(-2.5, 2.5, 2000),
                            rng.uniform(-2.5, 2.5, 2000),
                            rng.uniform(-0.2, 0.6, 2000)], 1)
        out.append(np.concatenate([box, clutter]).astype(np.float32))
    return out


def test_detect_obstacles_and_avoider_match_jax(walk_cloud):
    """Counts equal exactly, centers equal (NaN where unoccupied); the
    steering state machine fed both packages' centers makes the same
    decisions, and the avoidance view renders the same bytes."""
    av, jav = obstacle.ObstacleAvoider(), jobstacle.ObstacleAvoider()
    av.start(10.0)
    jav.start(10.0)
    states = []
    for k, cloud in enumerate(_obstacle_clouds(walk_cloud)):
        centers, counts = obstacle.detect_obstacles(torch.from_numpy(cloud))
        jc, jn = jobstacle.detect_obstacles(jnp.asarray(cloud))
        assert counts.dtype == torch.int32 and counts.shape == (6400,)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
        yaw = av.update(centers.numpy(), 5.0 * k)
        assert yaw == jav.update(np.asarray(jc), 5.0 * k)
        assert av.state.value == jav.state.value
        states.append(av.state.value)
        if k == 3:
            img = obstacle.render_avoidance_frame(cloud, centers.numpy(), av,
                                                  width=160, height=120)
            jimg = jobstacle.render_avoidance_frame(cloud, np.asarray(jc),
                                                    jav, width=160,
                                                    height=120)
            assert img.dtype == np.uint8 and img.tobytes() == jimg.tobytes()
    assert "AVOIDING" in states and "WALKING" in states
    av.stop()
    assert av.update(np.zeros((0, 2)), 0.0) == av.target_yaw


def test_pointcloud_viewer_matches_jax(walk_cloud):
    _, _, extra = walk_cloud
    down = pointcloud_viz.voxel_downsample(extra, voxel_m=0.4)
    np.testing.assert_array_equal(down, jviz.voxel_downsample(extra, 0.4))
    traj = np.stack([np.linspace(-1, 1, 30), np.zeros(30)], 1)
    img = pointcloud_viz.render_cloud_frame(down, traj, orbit_deg=40.0,
                                            width=160, height=120)
    assert img.tobytes() == jviz.render_cloud_frame(
        down, traj, orbit_deg=40.0, width=160, height=120).tobytes()
    assert (img.min(-1) > 200).any()          # the white trajectory
    frames = list(pointcloud_viz.orbit_frames(down, traj, n_frames=2,
                                              width=80, height=60))
    assert len(frames) == 2 and not np.array_equal(frames[0], frames[1])
    assert pointcloud_viz.render_cloud_frame(np.zeros((0, 3))).shape == (
        360, 480, 3)


def test_pointcloud_viz_cli_on_cpu(tmp_path):
    """The CLI maps 24 frames over the seeded terrain and writes the orbit
    GIF (imageio)."""
    pytest.importorskip("imageio")
    pointcloud_viz.main(["--device", "cpu", "--frames", "2",
                         "--out", str(tmp_path)])
    assert os.path.getsize(tmp_path / "orbit.gif") > 1000


def test_depth_display_loop_matches_jax():
    rng = np.random.default_rng(0)
    frames = [(rng.uniform(0, 1, (12, 16, 3)) * 255).astype(np.uint8)
              for _ in range(3)]

    def predictor(f):
        return f.mean(-1) / 255.0 + 0.5

    got = list(depth.depth_stream(iter(frames), predictor))
    want = list(jdepth.depth_stream(iter(frames), predictor))
    for (d, u8), (jd, ju8) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(u8, ju8)
    assert depth.normalize_depth(np.ones((4, 4))).max() == 0
