"""The monocular depth stack of the port (``apps/mono_depth.py``) against
the JAX package's: both shaded renderers, the ``DepthCNN`` forward and loss
gradient on JAX weights carried by ``load_flax_depth_params``, the
predictor on a camera-sized RGB frame, and the init law.  The JAX renders
run op by op (``jax.disable_jit()``; compiled, a few rays end one final
bisection interval away, tests/test_torch_slam.py); the JAX net runs
jitted, as its own tests run it."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.apps import mono_depth as jmono
from opendog_tpu.physics.terrain import generate_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.apps import mono_depth
from opendog_tpu_torch.physics import terrain_from_numpy
from opendog_tpu_torch.rl.networks import _TRUNC_STD

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jt = generate_terrain(jax.random.PRNGKey(0), jm)
    return jm, m, jt, terrain_from_numpy(np.asarray(jt.height), "cpu")


@pytest.fixture(scope="module")
def jax_params():
    """A JAX ``DepthCNN`` initialised as ``train_depth_net`` initialises it
    (PRNGKey(seed) on a (1, 24, 32, 1) frame), as numpy."""
    x = jnp.zeros((1, 24, 32, 1), jnp.float32)
    p = jmono.DepthCNN().init(jax.random.PRNGKey(3), x)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("renderer", ["render_shaded",
                                      "render_shaded_overcast"])
@pytest.mark.parametrize("pose", [(0.2, 0.1, 0.0), (0.4, -0.3, 0.5),
                                  (-1.2, 0.9, -2.0)])
def test_shaded_renderers_match_jax(world, renderer, pose):
    """Image and depth within 1e-5 (numpy float64 shading over float32
    hits and normals); the frame is aligned with its depth."""
    jm, m, jt, tt = world
    pose = np.array(pose, np.float32)
    with jax.disable_jit():
        jimg, jdepth = getattr(jmono, renderer)(jm, jt, pose, seed=5)
    img, depth = getattr(mono_depth, renderer)(m, tt, pose, seed=5)
    assert img.shape == (24, 32) and depth.shape == (24, 32)
    assert img.dtype == np.float32 and depth.dtype == np.float32
    np.testing.assert_allclose(img, jimg, rtol=0, atol=TOL)
    np.testing.assert_allclose(depth, jdepth, rtol=0, atol=TOL)
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert np.isfinite(depth).all() and depth.min() > 0.05


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 24, 32, 1)).astype(np.float32)
    y = rng.uniform(0.3, 4.0, (n, 24, 32)).astype(np.float32)
    return x, y


def test_depth_cnn_forward_and_gradient_match_jax(jax_params):
    """Same weights (flax HWIO kernels carried into OIHW), same depth
    within 1e-5 m on a batch of 4, and the same loss gradient within
    1e-5."""
    x, y = _frames(4)
    jnet = jmono.DepthCNN()
    want = np.asarray(jax.jit(jnet.apply)(jax_params, jnp.asarray(x)))
    net = mono_depth.load_flax_depth_params(mono_depth.DepthCNN(),
                                            jax_params)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = net(xt)
    assert got.shape == (4, 24, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)

    def jloss(p):
        return jnp.mean((jnet.apply(p, jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    jgrad = jax.jit(jax.grad(jloss))(jax_params)
    loss = torch.mean((got - torch.from_numpy(y)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(jax_params)),
                               rtol=TOL)
    for i, conv in enumerate(net.convs):
        g = jgrad["params"][f"Conv_{i}"]
        np.testing.assert_allclose(
            conv.weight.grad.numpy(),
            np.asarray(g["kernel"]).transpose(3, 2, 0, 1), rtol=0, atol=TOL,
            err_msg=f"Conv_{i} kernel")
        np.testing.assert_allclose(conv.bias.grad.numpy(),
                                   np.asarray(g["bias"]), rtol=0, atol=TOL,
                                   err_msg=f"Conv_{i} bias")


def test_sim_predictor_matches_jax(jax_params):
    """A 480 x 640 RGB uint8 frame (gray, 0-255 -> 0-1, an antialiased
    bilinear resize to 24 x 32, the net): within 1e-5 m."""
    rng = np.random.default_rng(1)
    frame = (rng.uniform(0, 1, (480, 640, 3)) * 255).astype(np.uint8)
    want = jmono.make_sim_predictor(jax_params)(frame)
    net = mono_depth.load_flax_depth_params(mono_depth.DepthCNN(),
                                            jax_params)
    got = mono_depth.make_sim_predictor(net)(frame)
    assert got.shape == (24, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # an already small gray frame in [0, 1] passes through the same path
    small = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    np.testing.assert_allclose(mono_depth.make_sim_predictor(net)(small),
                               jmono.make_sim_predictor(jax_params)(small),
                               rtol=0, atol=TOL)


def test_init_follows_flax_law(jax_params):
    """One generator seed gives one net; kernels are cut at two standard
    deviations of sqrt(1 / fan_in) / 0.8796 with flax's spread, biases
    0."""
    a = mono_depth.DepthCNN(generator=torch.Generator().manual_seed(0))
    b = mono_depth.DepthCNN(generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for i, conv in enumerate(a.convs):
        fan_in = conv.in_channels * 9
        std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
        w = conv.weight.detach().numpy()
        assert np.abs(w).max() <= 2 * std + 1e-7
        assert not conv.bias.detach().numpy().any()
        jk = jax_params["params"][f"Conv_{i}"]["kernel"]
        assert w.shape == jk.transpose(3, 2, 0, 1).shape
        if w.size >= 4000:   # the wide layers: the spread within 10%
            assert abs(w.std() / jk.std() - 1) < 0.1, (i, w.std(), jk.std())
