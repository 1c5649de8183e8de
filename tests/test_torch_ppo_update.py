"""One PPO update against optax: the tiny env's chunk cut to one epoch of
one minibatch (all 32 samples), so that the chunk is its rollout, GAE,
the advantage normalisation and a single clipped Adam step, from a JAX
train state carried across (Adam moments not zero) and on the JAX chunk's
draws.  Parameters to 2e-6 after the step (Adam's float32 update in
another order, on data that agree to the jitted JAX step's roundings).
One jitted JAX chunk per file."""
import numpy as np
import torch

from test_torch_ppo import run_chunk_vs_jax, as_torch

torch.set_num_threads(1)


def test_one_minibatch_update_matches_optax():
    jstate, jm, state, m, _ = run_chunk_vs_jax(
        "clip", num_epochs=1, minibatch_size=32)
    want = as_torch(jstate.params)
    for k, v in want.items():
        got = state.params[k].detach()
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    for k in ("actor_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert state.opt_state.state[state.params["log_std"]]["step"] == 2
