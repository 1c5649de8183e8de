"""Checkpoints: the committed ``.npz`` of the JAX package's runs/walk_1
best policy (step 970) equals its Orbax restore bit for bit, and loads
into the port's 64-64 walk network; the port's ``Checkpointer`` keeps
``max_to_keep`` steps, skips a step already on disk, restores the latest
or a given step, and restores a train state in place."""
import os

import numpy as np
import torch
import jax

from opendog_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from opendog_tpu_torch.rl.networks import (COMMITTED_WALK_POLICY,
                                           MLPActorCritic, load_flax_params,
                                           read_npz_tree)
from opendog_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)


def test_committed_walk_policy_equals_its_orbax_checkpoint():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = JaxCheckpointer(os.path.join(repo, "runs", "walk_1",
                                        "best")).restore(step=970)
    got = read_npz_tree(COMMITTED_WALK_POLICY)
    flat_w = jax.tree_util.tree_flatten_with_path(want["params"])[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
    net = MLPActorCritic(33, 8, hidden=(64, 64), squash_mean=False)
    load_flax_params(net, got)
    np.testing.assert_array_equal(net.actor[0].weight.detach().numpy(),
                                  np.asarray(want["params"]["Dense_0"]
                                             ["kernel"]).T)


def test_checkpointer_steps_and_restore(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for step in (1, 2, 3):
        assert ck.save(step, {"x": torch.full((2,), float(step))})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not ck.save(3, {"x": torch.zeros(2)}, force=True)  # on disk
    assert torch.equal(ck.restore()["x"], torch.full((2,), 3.0))
    assert torch.equal(ck.restore(step=2)["x"], torch.full((2,), 2.0))
    net = MLPActorCritic(4, 2, hidden=(8,))
    ck.save(4, net)
    other = MLPActorCritic(4, 2, hidden=(8,))
    assert ck.restore(template=other) is other
    for (k, a), b in zip(net.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    ck.close()
