"""A whole PPO chunk (``loss="plain"``) against the JAX package's
jitted ``make_ppo`` chunk on the tiny env of tests/test_ppo.py:11-13
(OpenDOG walk, frame_skip 2, 4 envs, 8 steps; 2 epochs of 2 minibatches
of 16), from a carried JAX train state, on the JAX chunk's own draws; the
tolerances of tests/test_torch_ppo.py::check_chunk.  One jitted JAX chunk
per file (its compile)."""
import torch

from test_torch_ppo import check_chunk

torch.set_num_threads(1)


def test_plain_chunk_matches_jax():
    check_chunk("plain")
