"""Training the port's ``DepthCNN`` (``apps/mono_depth.train_depth_net``)
against the JAX package's optax loop, and on its own.

Adam in float32 in another order steps a weight whose gradient sits at
rounding level by up to lr in either direction, so trained nets are held
as functions on the round's data, not weight by weight.  The JAX package's
own jitted and op-by-op runs of these 20 steps (same init, same batches)
read 1.5e-3 m apart in their predictions and up to 7.7e-4 apart in their
relative per-step loss; the port is held to 3e-3 m on its predictions and
its validation RMSE, and to 2e-3 on its final loss."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.apps import mono_depth as jmono
from opendog_tpu.physics.terrain import generate_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.apps import depth, mono_depth
from opendog_tpu_torch.physics import terrain_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds():
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    jts = [generate_terrain(jax.random.PRNGKey(k), jm) for k in (0, 2)]
    return jm, m, jts, [terrain_from_numpy(np.asarray(t.height), "cpu")
                        for t in jts]


def test_twenty_adam_steps_match_optax_as_functions(worlds):
    """``train_depth_net`` at 16 / 4 frames and 20 steps from the JAX
    init (``init_params``): the same datasets and minibatches, the final
    loss and validation numbers, and the trained nets' depth on the
    training frames."""
    jm, m, jts, tts = worlds
    kw = dict(n_train=16, n_val=4, steps=20, seed=0)
    jparams, jmet = jmono.train_depth_net(jm, jts, **kw)
    init = jmono.DepthCNN().init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 24, 32, 1), jnp.float32))
    net, met = mono_depth.train_depth_net(
        m, tts, device="cpu", init_params=jax.tree_util.tree_map(
            np.asarray, init), **kw)
    assert met.keys() == jmet.keys()
    for k in ("train_frames", "val_frames", "steps", "beats_baseline",
              "mean_depth_baseline_rmse_m"):
        assert met[k] == jmet[k], k
    np.testing.assert_allclose(met["final_train_loss"],
                               jmet["final_train_loss"], rtol=2e-3)
    assert abs(met["val_rmse_m"] - jmet["val_rmse_m"]) <= 3e-3
    # JAX renders its frames compiled: a few rays end one final bisection
    # interval (2.05e-5 m) away, which moves their shading by up to 5e-5
    xi, yi = mono_depth._dataset(m, tts, 16, mono_depth.CamConfig(), 0)
    jxi, jyi = jmono._dataset(jm, jts, 16, jmono.CamConfig(), 0)
    np.testing.assert_allclose(xi[:, 0], jxi[..., 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(yi, jyi, rtol=0, atol=3e-5)
    want = np.asarray(jax.jit(jmono.DepthCNN().apply)(
        jparams, jnp.asarray(jxi)))
    with torch.no_grad():
        got = net(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)


@pytest.fixture(scope="module")
def trained(worlds):
    _, m, _, tts = worlds
    return mono_depth.train_depth_net(m, tts, n_train=24, n_val=8,
                                      steps=150, seed=0, device="cpu")


def test_own_training_beats_the_mean_depth_baseline(trained):
    """``tests/test_mono_depth.py:41-46``'s gates on the port's own init."""
    _, metrics = trained
    assert metrics["beats_baseline"], metrics
    assert metrics["val_rmse_m"] < 0.5 * metrics[
        "mean_depth_baseline_rmse_m"], metrics


def test_trained_net_serves_the_depth_stream(worlds, trained):
    """The trained net in ``apps/depth.py``'s display loop: an RGB uint8
    frame in, a depth map that follows the ground truth out; and on
    held-out terrain realizations it still beats the mean-depth
    baseline."""
    jm, m, _, tts = worlds
    net, _ = trained
    img, truth = mono_depth.render_shaded(m, tts[0],
                                          np.array([0.4, -0.3, 0.5]), seed=5)
    rgb = (np.stack([img] * 3, axis=-1) * 255).astype(np.uint8)
    (d, d_u8), = depth.depth_stream(iter([rgb]),
                                    mono_depth.make_sim_predictor(net))
    assert d.shape == (24, 32) and d_u8.dtype == np.uint8
    assert np.corrcoef(d.ravel(), truth.ravel())[0, 1] > 0.8
    heldout = [terrain_from_numpy(np.asarray(generate_terrain(
        jax.random.PRNGKey(k), jm).height), "cpu") for k in (101, 103)]
    x, y = mono_depth._dataset(m, heldout, 8, mono_depth.CamConfig(), 900)
    with torch.no_grad():
        pred = net(torch.from_numpy(x)).numpy()
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    assert rmse < float(np.sqrt(np.mean((y.mean() - y) ** 2)))
