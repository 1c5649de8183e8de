"""Terrain-relative localization of the port (``apps/slam.py``) against the
JAX package's (``opendog_tpu/apps/slam.py``) on the same terrains, poses
and frames: the ray grid, the ray-marched depth, the ICP residuals, their
Jacobian and the Gauss-Newton pose, and the simulated walk.

The JAX side runs op by op (``jax.disable_jit()``) where the test asks for
1e-5: compiled, XLA fuses products and sums into one rounding, and a
bisection step that meets the surface within an ulp of its midpoint then
ends one final interval away ((4 - 0.05) / 47 / 2^12 = 2.05e-5 m along the
ray) on a few rays of a frame.  Terrains come from JAX
``generate_terrain(PRNGKey(k))`` carried across as numpy."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.apps import slam as jslam
from opendog_tpu.physics import dynamics as jax_dyn
from opendog_tpu.physics.model import Terrain as JaxTerrain
from opendog_tpu.physics.terrain import generate_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.apps import slam
from opendog_tpu_torch.physics import terrain_from_numpy

torch.set_num_threads(1)

TOL = 1e-5                                  # m, and on the pose
FINAL_INTERVAL = (4.0 - 0.05) / 47 / 2 ** 12  # one final bisection interval


@pytest.fixture(scope="module")
def world():
    """(JAX model, port model, JAX terrain, port terrain) on the generated
    terrain of PRNGKey(0), a non-flat episode (relief over 0.05 m)."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jt = generate_terrain(jax.random.PRNGKey(0), jm)
    assert float(jt.height.max() - jt.height.min()) > 0.05
    return jm, m, jt, terrain_from_numpy(np.asarray(jt.height), "cpu")


def _flat_world():
    """``tests/test_slam.py:66``'s featureless 10 x 10 terrain."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    h = np.full((10, 10), 0.151, np.float32)
    return jm, m, JaxTerrain(height=jnp.asarray(h)), terrain_from_numpy(
        h, "cpu")


def _assert_same_frame(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)


def test_ray_grid_equal():
    for cam in (slam.CamConfig(), slam.CamConfig(width=8, height=6,
                                                 pitch_deg=20.0)):
        got = slam._ray_grid(cam)
        assert got.dtype == np.float32 and got.shape == (
            cam.width * cam.height, 3)
        np.testing.assert_array_equal(got, jslam._ray_grid(jslam.CamConfig(
            *cam)))


POSES = [(0.2, 0.1, 0.3), (0.3, -0.2, 0.2), (-1.0, 0.7, 2.5)]


@pytest.mark.parametrize("pose", POSES)
def test_render_depth_matches_jax(world, pose):
    """Within 1e-5 m of JAX op by op with the same NaN mask (they read bit
    for bit here), and a batch of poses gives each pose's frame."""
    jm, m, jt, tt = world
    with jax.disable_jit():
        want = np.asarray(jslam.render_depth(jm, jt, jnp.array(pose)))
    got = slam.render_depth(m, tt, pose)
    assert got.dtype == torch.float32
    _assert_same_frame(got.numpy(), want, TOL)
    assert np.isfinite(want).all(axis=1).mean() > 0.8
    batch = slam.render_depth(m, tt, torch.tensor(POSES))
    assert batch.shape == (len(POSES), 32 * 24, 3)
    i = POSES.index(pose)
    np.testing.assert_array_equal(batch[i].numpy(), got.numpy())


def test_render_depth_flat_terrain_matches_jax():
    jm, m, jt, tt = _flat_world()
    for pose in ((0.0, 0.0, 0.0), (0.5, -0.4, 1.0)):
        with jax.disable_jit():
            want = np.asarray(jslam.render_depth(jm, jt, jnp.array(pose)))
        _assert_same_frame(slam.render_depth(m, tt, pose).numpy(), want, TOL)


def test_render_depth_within_a_final_interval_of_compiled_jax(world):
    """Against the jitted reference (as ``simulate_walk_localization``
    calls it): the same NaN mask, every ray within one final bisection
    interval (plus 1e-6 m of rounding)."""
    jm, m, jt, tt = world
    pose = POSES[0]
    want = np.asarray(jax.jit(lambda p: jslam.render_depth(jm, jt, p))(
        jnp.array(pose)))
    _assert_same_frame(slam.render_depth(m, tt, pose).numpy(), want,
                       FINAL_INTERVAL + 1e-6)


def _noisy_frame(m, tt, pose, seed=0):
    pts = slam.render_depth(m, tt, pose).numpy()
    rng = np.random.default_rng(seed)
    return (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


def _jax_residuals(jm, jt, pts):
    """``opendog_tpu/apps/slam.py:140-148``'s residuals of finite points."""
    def residuals(pose):
        x, y, yaw = pose[0], pose[1], pose[2]
        c, s = jnp.cos(yaw), jnp.sin(yaw)
        px = c * pts[:, 0] - s * pts[:, 1] + x
        py = s * pts[:, 0] + c * pts[:, 1] + y
        h, n = jax_dyn._terrain_height_normal(
            jm, jt, jnp.stack([px, py], axis=-1))
        return n[:, 2] * (pts[:, 2] - h)
    return residuals


def test_icp_residuals_and_jacobian_match_jax(world):
    """The residuals and their ``torch.func.jacfwd`` Jacobian (N, 3)
    against ``jax.jacfwd``, within 1e-5, at a pose off the truth."""
    jm, m, jt, tt = world
    frame = _noisy_frame(m, tt, (0.3, -0.2, 0.2))
    pts = np.where(np.isfinite(frame).all(1)[:, None], frame, 0.0)
    pose = np.array([0.42, -0.28, 0.26], np.float32)
    jres = _jax_residuals(jm, jt, jnp.asarray(pts))
    with jax.disable_jit():
        want_r = np.asarray(jres(jnp.asarray(pose)))
        want_J = np.asarray(jax.jacfwd(jres)(jnp.asarray(pose)))
    tp = torch.from_numpy(pts)
    got_r = slam.icp_residuals(m, tt, tp, torch.from_numpy(pose))
    got_J = torch.func.jacfwd(
        lambda q: slam.icp_residuals(m, tt, tp, q))(torch.from_numpy(pose))
    assert got_J.shape == (pts.shape[0], 3)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_J.numpy(), want_J, rtol=0, atol=TOL)
    assert np.abs(want_J).max() > 0.1   # the terrain constrains the pose


@pytest.mark.parametrize("flat", [False, True])
def test_icp_matches_jax(world, flat):
    """A 12 cm / 3.4 degree start error, 10 Gauss-Newton iterations: pose
    and rms within 1e-5 of JAX op by op (``tests/test_slam.py:50, 64``);
    on the flat terrain both stay at the start pose in x, y."""
    jm, m, jt, tt = _flat_world() if flat else world
    gt = np.array([0.0, 0.0, 0.0] if flat else [0.3, -0.2, 0.2], np.float32)
    frame = _noisy_frame(m, tt, gt)
    pose0 = (np.array([0.1, -0.1, 0.05], np.float32) if flat
             else gt + np.array([0.12, -0.08, 0.06], np.float32))
    with jax.disable_jit():
        jpose, jrms = jslam.point_to_plane_icp(jm, jt, jnp.asarray(frame),
                                               pose0)
    pose, rms = slam.point_to_plane_icp(m, tt, torch.from_numpy(frame), pose0)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(rms), float(jrms), rtol=0, atol=TOL)
    if flat:
        assert abs(float(pose[0]) - 0.1) < 2e-2
    else:
        assert np.abs(pose.numpy()[:2] - gt[:2]).max() < 5e-3


def test_walk_localization_matches_jax(world):
    """``simulate_walk_localization`` at 25 steps (``tests/test_slam.py:82``)
    against the JAX harness as it runs (jitted render and ICP): every
    metric within 1e-4 m (the metrics are rounded to 4 decimals), the same
    booleans, and the reference's gates."""
    jm, m, jt, tt = world
    want = jslam.simulate_walk_localization(jm, jt, n_steps=25)
    got = slam.simulate_walk_localization(m, tt, n_steps=25)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, bool):
            assert got[k] is v, k
        else:
            assert abs(got[k] - v) <= 1e-4 + 1e-9, (k, got[k], v)
    assert got["icp_beats_deadreckon"]
    assert got["icp_rmse_m"] < 0.5 * got["deadreckon_rmse_m"]
    assert got["icp_final_err_m"] < 0.05


def test_localizer_update_without_frame_is_pure_odometry(world):
    _, m, _, tt = world
    loc = slam.TerrainLocalizer(m, tt)
    pose, rms = loc.update(0.2, 0.0, 0.0, 0.1, points_robot=None)
    np.testing.assert_allclose(pose[0], 0.02, atol=1e-6)
    assert np.isnan(rms)
