"""Behaviour cloning and policy introspection of the port
(``opendog_tpu_torch/apps/cloning.py``, ``nnvis.py``) against the JAX
package's on the CPU.

* ``expert_action`` is exact.
* ``train_cloned_policy`` starts from the JAX function's flax init (its
  first key) and takes the uniform draws of its per-step keys.  Adam steps
  a weight whose gradient sits at rounding level by up to lr in either
  direction (ROADMAP Queue 3), and on this ReLU net the two packages'
  weights part from step ~20 (1e-7 after 5 steps, 3.5e-3 after 50, on the
  CPU).  So after 200 steps the two are held as functions: outputs on 61
  errors in [-30, 30] within 1.0 degree (1.4% of the ~73-degree output
  range) and their RMS distances to the expert within 1% of each other.
  At 1500 steps the port passes tests/test_apps_extra.py:38-44's 2.5-degree
  band.
* ``capture_activations`` gives flax's key set, values within 1e-6 on the
  carried-over parameters; the dashboard renders.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu.apps import cloning as jcloning
from opendog_tpu.apps import nnvis as jnnvis
from opendog_tpu.rl import MLPActorCritic as JMLPActorCritic
from opendog_tpu_torch.apps import cloning, nnvis
from opendog_tpu_torch.rl.networks import MLPActorCritic, load_flax_params

torch.set_num_threads(1)

ERRORS = np.linspace(-30.0, 30.0, 61).astype(np.float32)


def _jax_start(key, num_steps, batch=256, err_range=30.0):
    """The JAX function's init and draws: ``split(key)`` -> (init key,
    key of the step keys), one ``uniform`` per step."""
    k1, k2 = jax.random.split(key)
    init = jcloning.WalkPolicyNet().init(k1, jnp.zeros((1, 1)))
    keys = jax.random.split(k2, num_steps)
    draws = jax.vmap(lambda k: jax.random.uniform(
        k, (batch, 1), minval=-err_range, maxval=err_range))(keys)
    return jax.tree_util.tree_map(np.asarray, init), np.array(draws)


def test_expert_action_is_exact():
    got = cloning.expert_action(torch.from_numpy(ERRORS)).numpy()
    want = np.asarray(jcloning.expert_action(jnp.asarray(ERRORS)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cloning.expert_action(10.0).numpy(),
                                  [20.0, 45.0])


def test_flax_params_carry_over():
    init, _ = _jax_start(jax.random.PRNGKey(3), 1)
    net = cloning.load_flax_params(cloning.WalkPolicyNet(device="cpu"),
                                   init)
    x = ERRORS[:, None]
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jcloning.WalkPolicyNet().apply(init, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_flax_style_init_scale():
    net = cloning.WalkPolicyNet(generator=torch.Generator().manual_seed(0),
                                device="cpu")
    for lin in net.layers:
        w = lin.weight.detach()
        bound = 2.0 * np.sqrt(1.0 / lin.in_features) / 0.87962566103423978
        assert float(w.abs().max()) <= bound + 1e-6
        assert float(lin.bias.detach().abs().max()) == 0.0


def test_cloned_policy_holds_to_jax_as_a_function():
    key, steps = jax.random.PRNGKey(0), 200
    jnet, jparams = jcloning.train_cloned_policy(key, num_steps=steps)
    init, draws = _jax_start(key, steps)
    net = cloning.train_cloned_policy(draws=torch.from_numpy(draws),
                                      num_steps=steps, params=init,
                                      device="cpu")
    x = ERRORS[:, None]
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    expert = np.asarray(jcloning.expert_action(jnp.asarray(ERRORS)))
    np.testing.assert_allclose(got, want, atol=1.0, rtol=0)
    rms_got = np.sqrt(np.mean((got - expert) ** 2))
    rms_want = np.sqrt(np.mean((want - expert) ** 2))
    assert abs(rms_got - rms_want) <= 0.01 * rms_want


def test_cloning_learns_expert():
    """tests/test_apps_extra.py:38-44 on the port: the JAX test's start
    (key 0) and draws, 1500 steps."""
    init, draws = _jax_start(jax.random.PRNGKey(0), 1500)
    net = cloning.train_cloned_policy(
        draws=torch.from_numpy(draws), num_steps=1500, params=init,
        device="cpu")
    for e in (-20.0, -5.0, 0.0, 5.0, 20.0):
        n, y = cloning.cloned_lift_angles(net, e)
        want = cloning.expert_action(e).numpy()
        assert abs(n - want[0]) < 2.5 and abs(y - want[1]) < 2.5


def test_draws_are_checked_and_drawn():
    with pytest.raises(ValueError):
        cloning.train_cloned_policy(draws=torch.zeros(3, 4, 1), num_steps=2,
                                    batch=4, device="cpu")
    net = cloning.train_cloned_policy(
        generator=torch.Generator().manual_seed(0), num_steps=3, batch=8,
        device="cpu")
    assert np.isfinite(cloning.cloned_lift_angles(net, 3.0)).all()


@pytest.mark.parametrize("layer_norm", [False, True])
def test_capture_activations_has_flax_keys_and_values(layer_norm):
    jnet = JMLPActorCritic(action_dim=4, hidden=(16, 8),
                           layer_norm_extractor=layer_norm)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    net = MLPActorCritic(10, 4, hidden=(16, 8),
                         layer_norm_extractor=layer_norm, device="cpu")
    load_flax_params(net, jax.tree_util.tree_map(np.asarray, params))
    obs = np.random.default_rng(0).normal(size=(3, 10)).astype(np.float32)
    want = jnnvis.capture_activations(jnet, params, jnp.asarray(obs))
    got = nnvis.capture_activations(net, torch.from_numpy(obs))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    summ = nnvis.activation_summary(got)
    for k, v in jnnvis.activation_summary(want).items():
        assert summ[k]["shape"] == v["shape"]
        assert abs(summ[k]["mean"] - v["mean"]) < 1e-6


def test_capture_removes_its_hooks():
    net = MLPActorCritic(10, 4, hidden=(16, 8), device="cpu")
    obs = torch.ones(2, 10)
    nnvis.capture_activations(net, obs)
    assert all(not lin._forward_hooks for _, lin in net.flax_layers())


def test_activation_dashboard_renders(tmp_path):
    net = MLPActorCritic(10, 4, hidden=(16, 8),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    seq = [nnvis.capture_activations(net, torch.ones(1, 10) * (0.1 * t))
           for t in range(5)]
    p = str(tmp_path / "acts.png")
    nnvis.render_activation_dashboard(seq, p)
    assert os.path.getsize(p) > 1000
