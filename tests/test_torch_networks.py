"""The port's policy network against the JAX package's: ``MLPActorCritic``
in every option with flax's parameters carried across by
``load_flax_params`` (mean, log-std and value to 1e-5 abs and relative:
float32 products summed in another order), the Gaussian helpers to 1e-6,
and the flax-style initialisation by its statistics."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu.rl import networks as jax_networks
from opendog_tpu_torch.rl import networks

torch.set_num_threads(1)

OBS, ACT, B = 23, 7, 64
OPTIONS = {
    "sim2real": dict(hidden=(512, 256), squash_mean=True),
    "sb3": dict(hidden=(64, 64), squash_mean=False),
    "extractor": dict(hidden=(32, 16), layer_norm_extractor=True),
    "extractor-dims": dict(hidden=(24,), layer_norm_extractor=True,
                           extractor_dims=(30, 20), log_std_init=-1.0),
}


def _obs(seed=0):
    return np.random.default_rng(seed).normal(0, 1.5, (B, OBS)).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_network_matches_flax_with_carried_parameters(name):
    opts = OPTIONS[name]
    jnet = jax_networks.MLPActorCritic(action_dim=ACT, **opts)
    obs = _obs()
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1]))
    # perturb every leaf so that biases, LayerNorm scales and the log-std
    # are not at their initial constants
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(2)
    leaves = [np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32)
              for x in leaves]
    params = jax.tree.unflatten(tree, leaves)
    jmean, jlog_std, jvalue = jnet.apply(params, jnp.asarray(obs))
    net = networks.MLPActorCritic(OBS, ACT, **opts)
    networks.load_flax_params(net, jax.tree.map(np.asarray, params))
    mean, log_std, value = net(torch.from_numpy(obs))
    assert mean.shape == (B, ACT) and value.shape == (B,)
    for got, want in ((mean, jmean), (log_std, jlog_std), (value, jvalue)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    m2, _, v2 = net(torch.from_numpy(obs), value=False)
    assert v2 is None and torch.equal(m2, mean)
    # one unbatched observation
    one = net(torch.from_numpy(obs[3]))[0]
    np.testing.assert_allclose(one.detach().numpy(), np.asarray(jmean)[3],
                               atol=1e-5, rtol=1e-5)


def test_load_flax_params_checks_the_tree():
    jnet = jax_networks.MLPActorCritic(action_dim=ACT, hidden=(8, 8))
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, OBS))))
    with pytest.raises(ValueError, match="flax tree has layers"):
        networks.load_flax_params(networks.MLPActorCritic(
            OBS, ACT, hidden=(8, 8), layer_norm_extractor=True), params)
    with pytest.raises(ValueError, match="flax shape"):
        networks.load_flax_params(networks.MLPActorCritic(
            OBS + 1, ACT, hidden=(8, 8)), params)
    # without the top-level "params" key too
    net = networks.load_flax_params(networks.MLPActorCritic(
        OBS, ACT, hidden=(8, 8)), params["params"])
    np.testing.assert_array_equal(net.actor[0].weight.detach().numpy(),
                                  params["params"]["Dense_0"]["kernel"].T)


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(3)
    mean = rng.normal(0, 1, (B, ACT)).astype(np.float32)
    log_std = rng.normal(-0.5, 0.3, ACT).astype(np.float32)
    action = rng.normal(0, 1, (B, ACT)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        networks.gaussian_logp(t(mean), t(log_std), t(action)).numpy(),
        np.asarray(jax_networks.gaussian_logp(mean, log_std, action)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(networks.gaussian_entropy(t(log_std))),
        float(jax_networks.gaussian_entropy(log_std)), rtol=1e-6)
    # a sample is mean + std * N(0, 1) from the generator
    a = networks.sample_action(torch.Generator().manual_seed(4), t(mean),
                               t(log_std))
    noise = torch.randn((B, ACT), generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(
        a.numpy(), mean + np.exp(log_std) * noise.numpy(), rtol=1e-6,
        atol=1e-6)


def test_flax_style_initialisation():
    """Kernels from a normal truncated at two standard deviations whose
    spread is sqrt(1 / fan_in), as flax's lecun_normal; zero biases, unit
    LayerNorm scales, the log-std at its initial value; reproducible from
    the generator.  The same statistics from flax's own init."""
    opts = dict(hidden=(512, 256), layer_norm_extractor=True,
                extractor_dims=(50, 40))
    net = networks.MLPActorCritic(OBS, ACT, generator=torch.Generator()
                                  .manual_seed(0), **opts)
    again = networks.MLPActorCritic(OBS, ACT, generator=torch.Generator()
                                    .manual_seed(0), **opts)
    jparams = jax_networks.MLPActorCritic(action_dim=ACT, **opts).init(
        jax.random.PRNGKey(0), jnp.zeros((1, OBS)))["params"]
    for (fname, mod), (name2, mod2) in zip(net.flax_layers(),
                                           again.flax_layers()):
        if isinstance(mod, torch.nn.Linear):
            w = mod.weight.detach().numpy()
            assert torch.equal(mod.weight, mod2.weight)
            std = math.sqrt(1.0 / mod.in_features)
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
            jw = np.asarray(jparams[fname]["kernel"])
            assert jw.shape == w.T.shape
            if w.size >= 1000:
                for x in (w, jw):
                    assert abs(x.std() / std - 1) < 0.1, (fname, x.std())
                    assert abs(x.mean()) < 0.1 * std
            assert not mod.bias.detach().any()
        else:
            assert torch.equal(mod.scale, torch.ones_like(mod.scale))
            assert not mod.bias.detach().any()
    np.testing.assert_allclose(net.log_std.detach().numpy(),
                               np.full(ACT, np.log(0.4), np.float32))
