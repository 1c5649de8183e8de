"""``eval.py``'s CLI against the JAX package's on the committed runs/walk_1
policy: the JAX CLI restores the Orbax ``best/`` checkpoint, the port's
reads its ``.npz``; the port's env is handed the reset draws of the JAX
CLI's episode key (the only substitution).  The printed episode line
and the rad action table agree to one unit of their last printed digit;
the deg table and the paw contact forces (the JAX CLI's step is jitted:
its fused roundings move a contact force by up to a few 0.01 N) to
0.1."""
import os
import re
import sys

import numpy as np
import torch
import jax

from opendog_tpu import envs as jax_envs
from opendog_tpu import eval as jax_eval
from opendog_tpu_torch import envs
from opendog_tpu_torch import eval as eval_cli
from opendog_tpu_torch.rl.networks import COMMITTED_WALK_POLICY
from test_torch_envs import reset_draws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--steps", "20", "--episodes", "1", "--print_actions", "3"]


def _numbers(text):
    out = []
    for line in text.splitlines():
        if line.startswith(("episode", "  t=", "  paw")):
            out.append([float(x) for x in re.findall(
                r"-?\d+\.\d+|-?\d+(?=[\s\]|])", line.split(":", 1)[1])])
    return out


def test_eval_cli_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["eval", "walk", "--run",
                                      os.path.join(REPO, "runs", "walk_1"),
                                      *ARGS])
    jax_eval.main()
    want = _numbers(capsys.readouterr().out)
    # the JAX CLI's first episode key: split(PRNGKey(seed))[1]
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    from opendog_tpu.assets import load_opendog
    jenv = jax_envs.WalkEnv(load_opendog("flat"))
    monkeypatch.setattr(envs.WalkEnv, "draw_reset",
                        lambda self, g, n: reset_draws(jenv, self, key[None]))
    eval_cli.main(["walk", "--ckpt", COMMITTED_WALK_POLICY, "--device",
                   "cpu", *ARGS])
    got = _numbers(capsys.readouterr().out)
    assert len(got) == len(want) == 5, (got, want)
    # episode: return (2 decimals), length, fwd_x (3); rad (3), deg (1);
    # paw Fz (2)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        np.testing.assert_allclose(g, w, rtol=0, atol=0.1 + 1e-9)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0.011)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g[:8], w[:8], rtol=0, atol=0.0011)
