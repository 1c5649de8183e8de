"""The payload-randomised distiller (``payload_range``: each scenario's
expert plans with its payload and the plant integrates it on the kernel's
payload rows; the student does not observe it) against the JAX package's
on the kernel engine (JAX ``"pallas"`` in interpret mode): a round and an
eval on JAX's draws, as tests/test_torch_distill.py holds the command
variants, to the tolerances stated there.
"""
import torch

from test_torch_distill import run_round_and_eval
from test_torch_exact_plant import _interpret

torch.set_num_threads(1)


def test_payload_round_and_eval_match_jax(monkeypatch):
    _interpret(monkeypatch)
    run_round_and_eval("payload", "kernel")
