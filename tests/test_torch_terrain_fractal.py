"""The fractal terrain family of the port against the JAX package's
``generate_terrain_fractal`` (``opendog_tpu/physics/terrain.py:100-156``),
through the ``draws`` seam, and the port's ``linspace`` against
``jnp.linspace`` bit for bit."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import terrain as jax_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import terrain

torch.set_num_threads(1)


def jax_fractal_draws(key, jm):
    """The draws ``jax_terrain.generate_terrain_fractal`` makes from
    ``key`` (terrain.py:120-141: same keys, calls and ranges), as the
    port's ``FractalDraws``."""
    nrow, ncol = jm.hfield_nrow, jm.hfield_ncol
    sx = float(jm.hfield_size[0])
    keys = jax.random.split(key, 8)
    u = jax.random.uniform
    fields = [
        u(keys[0], minval=1.6, maxval=2.4),
        jax.random.normal(keys[1], (nrow, ncol)),
        jax.random.normal(keys[2], (nrow, ncol)),
        u(keys[6]),
        u(keys[7], minval=0.3, maxval=0.8),
        u(keys[4], (3, 2), minval=-0.7 * sx, maxval=0.7 * sx),
        u(keys[5], (3,), minval=0.3, maxval=1.0),
    ]
    return terrain.FractalDraws(*(torch.from_numpy(np.array(f))
                                  for f in fields))


@pytest.mark.parametrize("seed,start", [(200, (0.0, 0.0)),
                                        (201, (0.0, 0.0)),
                                        (7, (0.5, -1.0))])
def test_fractal_through_draws_matches_jax(seed, start):
    """Same draws, same heights within 1e-5 x the hfield's z extent (the
    two libraries' FFTs and powers round differently)."""
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    key = jax.random.PRNGKey(seed)
    want = np.asarray(
        jax_terrain.generate_terrain_fractal(key, jm, start).height)
    got = terrain.generate_terrain_fractal(
        m, draws=jax_fractal_draws(key, jm), robot_start_xy=start)
    assert got.height.shape == (100, 100)
    assert got.height.dtype == torch.float32
    sz = float(jm.hfield_size[2])
    np.testing.assert_allclose(got.height.numpy(), want, rtol=0,
                               atol=1e-5 * sz)


def test_fractal_batched_draws_equal_single_terrains():
    """Draws with a leading batch axis give each terrain of its own draws,
    bit for bit; a generator seed gives one terrain in the hfield's
    range."""
    m = assets.load_opendog("terrain", device="cpu")
    draws = terrain.draw_terrain_fractal(
        m, torch.Generator().manual_seed(3), batch_shape=(2,))
    both = terrain.generate_terrain_fractal(m, draws=draws).height
    assert both.shape == (2, 100, 100)
    for b in range(2):
        one = terrain.generate_terrain_fractal(
            m, draws=terrain.FractalDraws(*(f[b] for f in draws))).height
        assert torch.equal(one, both[b])
    t1 = terrain.generate_terrain_fractal(
        m, generator=torch.Generator().manual_seed(0)).height
    t2 = terrain.generate_terrain_fractal(
        m, generator=torch.Generator().manual_seed(0)).height
    assert torch.equal(t1, t2)
    base, sz = float(m.numpy("hfield_size")[3]), float(
        m.numpy("hfield_size")[2])
    assert float(t1.min()) >= base - 1e-6
    assert float(t1.max()) <= base + sz + 1e-6
    assert float(t1.max() - t1.min()) > 0.5 * sz


@pytest.mark.parametrize("start,stop,num", [(0.05, 4.0, 48), (-5.0, 5.0, 100),
                                            (-5.0, 5.0, 160), (-1.0, 1.0, 24),
                                            (-1.0, 1.0, 32), (0.0, 1.0, 1)])
def test_linspace_equals_jnp_linspace_bit_for_bit(start, stop, num):
    """The coarse ray samples (``slam.py:86``) and the fractal's grids are
    ``jnp.linspace``: bit for bit op by op, and within two ulps of the
    larger endpoint of XLA's compiled forms (traced endpoints, where it
    fuses a product and a sum, and constant-folded ones)."""
    got = terrain.linspace(start, stop, num).numpy()
    assert got.dtype == np.float32 and got.shape == (num,)
    with jax.disable_jit():
        want = np.asarray(jnp.linspace(start, stop, num))
    np.testing.assert_array_equal(got, want)
    for compiled in (jnp.linspace(start, stop, num),
                     jax.jit(lambda: jnp.linspace(start, stop, num))()):
        np.testing.assert_allclose(got, np.asarray(compiled), rtol=0,
                                   atol=2 * np.spacing(np.float32(max(
                                       abs(start), abs(stop)))))
