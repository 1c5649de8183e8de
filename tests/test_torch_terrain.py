"""Terrain and kinematics of the port against the JAX package: the
procedural terrain (through the ``draws`` seam), the flat terrain, the
bilinear height / normal lookup, the level-parallel ``fk`` and the per-geom
contact planes that feed the substep kernel's per-geom mode."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import Terrain as JaxTerrain
from opendog_tpu.physics import dynamics as jax_dyn
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.physics import terrain as jax_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import (Terrain, dynamics, make_state,
                                       terrain, terrain_from_numpy)

torch.set_num_threads(1)

ROBOTS = {
    "go1": (lambda: jax_assets.load_go1("flat"),
            lambda: assets.load_go1("flat", device="cpu")),
    "mini": (jax_assets.load_mini, lambda: assets.load_mini(device="cpu")),
    "opendog": (lambda: jax_assets.load_opendog("terrain"),
                lambda: assets.load_opendog("terrain", device="cpu")),
}


def jax_draws(key, jm):
    """The seven random fields ``jax_terrain.generate_terrain`` draws from
    ``key`` (terrain.py:58-77, same keys, calls and ranges), as the port's
    ``TerrainDraws``."""
    nrow, ncol = jm.hfield_nrow, jm.hfield_ncol
    keys = jax.random.split(key, 7)
    mx = jax_terrain.MAX_ABS_HEIGHT
    u = jax.random.uniform
    fields = [
        u(keys[0], minval=0.1, maxval=0.4),
        u(keys[1], (nrow, ncol), minval=-mx, maxval=mx),
        u(keys[2], (nrow, ncol), minval=0.2, maxval=0.6),
        u(keys[3], (nrow, ncol), minval=0.2, maxval=0.6),
        u(keys[4], (nrow, ncol)),
        u(keys[5], (nrow, ncol), minval=-mx * 0.8, maxval=mx * 0.8),
        u(keys[6]),
    ]
    return terrain.TerrainDraws(*(torch.from_numpy(np.array(f))
                                  for f in fields))


def _opendog_terrain_pair(seed=0):
    """(jax model, port model, jax Terrain, port Terrain) on the generated
    terrain of ``PRNGKey(seed)`` (seed 0 is not a flat episode)."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    key = jax.random.PRNGKey(seed)
    jt = jax_terrain.generate_terrain(key, jm)
    return jm, m, jt, terrain_from_numpy(np.asarray(jt.height), "cpu")


@pytest.mark.parametrize("seed,start", [(0, (0.0, 0.0)), (1, (0.5, -1.0)),
                                        (2, (0.0, 0.0))])
def test_generate_terrain_through_draws_matches_jax(seed, start):
    """Same draws, same heights to 1e-5 m (float32 sin / cos and linspace
    of the two libraries).  Seed 2 draws a flat episode."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_terrain.generate_terrain(key, jm, start).height)
    got = terrain.generate_terrain(m, robot_start_xy=start,
                                   draws=jax_draws(key, jm))
    assert got.height.shape == (100, 100)
    assert got.height.dtype == torch.float32
    np.testing.assert_allclose(got.height.numpy(), want, rtol=0, atol=1e-5)


def test_generate_terrain_from_a_generator():
    """One generator seed gives one terrain; the heights lie in the
    hfield's range."""
    m = assets.load_opendog("terrain", device="cpu")
    a = terrain.generate_terrain(m, torch.Generator().manual_seed(4))
    b = terrain.generate_terrain(m, torch.Generator().manual_seed(4))
    assert torch.equal(a.height, b.height)
    h = a.height
    assert 0.001 - 1e-6 <= float(h.min()) <= float(h.max()) <= 0.301 + 1e-6
    with pytest.raises(ValueError, match="heightfield"):
        terrain.generate_terrain(assets.load_go1("flat", device="cpu"))


def test_flat_terrain_matches_jax_exactly():
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    want = np.asarray(jax_terrain.flat_terrain(jm).height)
    got = terrain.flat_terrain(m).height.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert Terrain.flat(3, 4).height.shape == (3, 4)


def test_terrain_height_normal_matches_jax():
    """Random xy over the grid and past its edges (the lookup clips to
    n - 1.001 cells), plus the exact corners: height and normal to 1e-6;
    no terrain gives the plane z = 0."""
    jm, m, jt, t = _opendog_terrain_pair()
    rng = np.random.default_rng(0)
    xy = rng.uniform(-5.5, 5.5, (256, 2)).astype(np.float32)
    xy[:4] = [[-5.0, -5.0], [5.0, 5.0], [5.0, -5.0], [4.999, 4.9999]]
    hj, nj = jax_dyn._terrain_height_normal(jm, jt, jnp.asarray(xy))
    h, n = dynamics._terrain_height_normal(m, t, torch.from_numpy(xy))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    h0, n0 = dynamics._terrain_height_normal(m, None, torch.from_numpy(xy))
    assert float(h0.abs().max()) == 0.0
    np.testing.assert_array_equal(n0.numpy(), np.tile([0, 0, 1.0], (256, 1)))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_fk_matches_jax(robot):
    """Random joint and base poses, single and batched: body positions and
    quaternions to 1e-6."""
    jfn, pfn = ROBOTS[robot]
    jm, m = jfn(), pfn()
    rng = np.random.default_rng(1)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (6, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.3, (6, 3))
    qpos[:, 3:7] = rng.normal(size=(6, 4))  # fk normalises the base quat
    qpos[:, 7:] += rng.normal(0, 0.4, (6, m.nq - 7))
    xpos, xquat = dynamics.fk(m, torch.from_numpy(qpos))
    assert xpos.shape == (6, m.nbody, 3) and xquat.shape == (6, m.nbody, 4)
    jx, jq = jax.vmap(lambda q: jax_dyn.fk(jm, q))(jnp.asarray(qpos))
    np.testing.assert_allclose(xpos.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(xquat.numpy(), np.asarray(jq), atol=1e-6)
    one = dynamics.fk(m, torch.from_numpy(qpos[0]))[0]
    np.testing.assert_allclose(one.numpy(), np.asarray(jx)[0], atol=1e-6)


def _mini_ramp(slope=0.08, n=9, half=2.0):
    """The linear x-ramp of tests/test_pallas_core.py::_ramp_terrain_mini,
    in both packages."""
    jm = jax_assets.load_mini().replace(
        hfield_size=jnp.asarray([half, half, 1.0, 0.0], jnp.float32))
    m = assets.load_mini(device="cpu")
    m = m.replace(hfield_size=torch.tensor([half, half, 1.0, 0.0]))
    xs = np.linspace(-half, half, n, dtype=np.float32)
    height = np.tile(slope * xs[None, :], (n, 1))  # row ~ y, col ~ x
    return jm, m, JaxTerrain(height=jnp.asarray(height)), \
        terrain_from_numpy(height, "cpu")


def test_geom_local_planes_on_mini_ramp():
    """On a linear ramp every geom's plane is the ramp itself:
    n ~ (-s, 0, 1), d = 0 (test_pallas_core.py:222-233); and the port
    matches the JAX planes to 1e-5."""
    jm, m, jt, t = _mini_ramp(slope=0.08)
    planes = dynamics.geom_local_planes(m, t, make_state(m, "home").qpos)
    assert planes.shape == (m.ngeom, 4)
    n_ref = np.array([-0.08, 0.0, 1.0])
    n_ref = n_ref / np.linalg.norm(n_ref)
    np.testing.assert_allclose(planes[:, :3].numpy(),
                               np.tile(n_ref, (m.ngeom, 1)), atol=1e-5)
    np.testing.assert_allclose(planes[:, 3].numpy(), 0.0, atol=1e-5)
    want = jax_dyn.geom_local_planes(jm, jt, jax_make_state(jm, "home").qpos)
    np.testing.assert_allclose(planes.numpy(), np.asarray(want), atol=1e-5)


def test_geom_local_planes_on_generated_terrain_match_jax():
    """opendog over a generated terrain, random poses across it (batched):
    the (ngeom, 4) planes to 1e-5."""
    jm, m, jt, t = _opendog_terrain_pair()
    rng = np.random.default_rng(2)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (8, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-3, 3, (8, 2))
    qpos[:, 2] += 0.15
    qpos[:, 7:] += rng.normal(0, 0.2, (8, m.nq - 7))
    got = dynamics.geom_local_planes(m, t, torch.from_numpy(qpos))
    assert got.shape == (8, m.ngeom, 4)
    want = jax.vmap(lambda q: jax_dyn.geom_local_planes(jm, jt, q))(
        jnp.asarray(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
