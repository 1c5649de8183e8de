"""Every entry point of the training path runs on the CUDA card unless the
caller asks for the CPU, and raises where there is no card: ``train``,
``make_ppo``, ``make_eval``, ``PolicyRollout``, ``build`` (a task) and
``eval.py``'s CLI.  Nothing falls back to the CPU.  Where a card is
present (the chip machine) the test has nothing to show and skips."""
import pytest
import torch

from opendog_tpu_torch import eval as eval_cli
from opendog_tpu_torch import train as train_mod
from opendog_tpu_torch.rl.evaluate import PolicyRollout, make_eval
from opendog_tpu_torch.rl.ppo import PPOConfig, make_ppo

torch.set_num_threads(1)


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, env, net = train_mod.build("walk", "cpu")
    calls = [
        lambda: train_mod.train("walk", total_chunks=1,
                                out_dir=str(tmp_path)),
        lambda: train_mod.build("turn"),
        lambda: make_ppo(env, net, PPOConfig()),
        lambda: make_eval(env, net, 5),
        lambda: PolicyRollout(env, lambda o: o, 5),
        lambda: eval_cli.main(["walk", "--run", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a CUDA graph on the CPU is refused, not run eagerly
    with pytest.raises(ValueError, match="CUDA graph"):
        make_ppo(env, net, PPOConfig(), device="cpu", graphs=True)
