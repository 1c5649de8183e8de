"""The training and evaluation entry points on the CPU: ``train("walk")``
end to end with eval, best parameters and the GIF (as
tests/test_ppo.py:109-126 drives the JAX one); a resumed run (1 chunk,
save, resume, 1 chunk) equal bit for bit to a 2-chunk run; the sym task's
walk.json export; ``eval.py``'s CLI on the run and on the committed
walk policy."""
import json
import os

import numpy as np
import torch

from opendog_tpu_torch import eval as eval_cli
from opendog_tpu_torch import train as train_mod
from opendog_tpu_torch.envs.base import tree_leaves
from opendog_tpu_torch.rl.networks import COMMITTED_WALK_POLICY

torch.set_num_threads(1)

TINY = dict(n_envs=2, n_steps=8, minibatch_size=8, num_epochs=1,
            device="cpu")


def test_train_entry_eval_best_and_video(tmp_path):
    train_mod.train("walk", total_chunks=2, out_dir=str(tmp_path), seed=0,
                    save_interval=2, eval_interval=1, video_interval=2,
                    eval_steps=10, **TINY)
    run = tmp_path / "walk_0"
    assert (run / "best").exists() and any((run / "best").iterdir())
    assert (run / "ckpt" / "2" / "state.pt").exists()
    gifs = [f for f in os.listdir(run) if f.startswith("eval_")
            and f.endswith(".gif")]
    assert gifs, os.listdir(run)
    lines = [json.loads(s) for s in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert any("eval/episode_return" in r for r in lines)
    train_keys = {k for r in lines for k in r if k.startswith("train/")}
    assert {"train/mean_reward", "train/sum_reward_per_env",
            "train/done_rate", "train/actor_loss", "train/value_loss",
            "train/value_resid_frac", "train/entropy", "train/mean_value",
            "train/steps_per_sec"} <= train_keys
    assert json.loads((run / "adaptive.json").read_text())["lr"] == 1e-4
    # eval.py on the run: best, latest and a step
    for ckpt in ("best", "latest", "2"):
        out = eval_cli.main(["walk", "--run", str(run), "--ckpt", ckpt,
                             "--steps", "5", "--episodes", "1",
                             "--device", "cpu"])
        assert 0 < out[0]["episode_len"] <= 5


def _state_tensors(state):
    out = dict(state.params)
    for i, st in state.opt_state.state_dict()["state"].items():
        out.update({f"adam{i}.{k}": v for k, v in st.items()})
    out.update({f"env{i}": v
                for i, v in enumerate(tree_leaves(state.env_states))})
    out["last_obs"] = state.last_obs
    out["generator"] = state.generator.get_state()
    return out


def test_resumed_run_equals_one_run_bit_for_bit(tmp_path):
    kw = dict(TINY, seed=3, eval_interval=0, save_interval=100)
    whole = train_mod.train("walk", total_chunks=2,
                            out_dir=str(tmp_path / "a"), **kw)
    train_mod.train("walk", total_chunks=1, out_dir=str(tmp_path / "b"),
                    **kw)
    resumed = train_mod.train("walk", total_chunks=1,
                              out_dir=str(tmp_path / "b"), resume=True, **kw)
    assert whole.update_count == resumed.update_count == 2
    a, b = _state_tensors(whole), _state_tensors(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the resumed run saved its own step beside the first run's
    assert sorted(os.listdir(tmp_path / "b" / "walk_3" / "ckpt")) == \
        ["1", "2"]


def test_sym_task_exports_walk_json(tmp_path, monkeypatch):
    """The sym task (512-256 tanh-squashed network, plain loss, adaptive
    schedule) trains a chunk and writes walk_rl_sym_ep1.json; the export
    is cut to 2 steps here (the task's own 50 substeps per step run
    eagerly on the CPU)."""
    export = train_mod.gait_json.generate_walk_json

    def short(policy, env, path, **kw):
        return export(policy, env, path, num_steps=2, **kw)

    monkeypatch.setattr(train_mod.gait_json, "generate_walk_json", short)
    state = train_mod.train("sym", n_envs=2, n_steps=2, total_chunks=1,
                            out_dir=str(tmp_path), save_interval=1,
                            minibatch_size=4, num_epochs=1, eval_interval=0,
                            device="cpu")
    seq = json.loads((tmp_path / "sym_0" / "walk_rl_sym_ep1.json")
                     .read_text())
    assert len(seq) == 2 and seq[0]["duration"] == 0.1
    assert set(seq[0]["targets_deg"]) == {
        "FR_tigh_actuator", "FR_knee_actuator", "FL_tigh_actuator",
        "FL_knee_actuator", "BR_tigh_actuator", "BR_knee_actuator",
        "BL_tigh_actuator", "BL_knee_actuator"}
    assert state.params["actor.0.weight"].shape == (512, 22)
    assert np.isfinite(state.params["log_std"].detach().numpy()).all()


def test_eval_cli_on_the_committed_walk_policy():
    """The JAX package's runs/walk_1 best policy, carried as an .npz,
    walks forward on the port's plant (20 steps, upright)."""
    out = eval_cli.main(["walk", "--ckpt", COMMITTED_WALK_POLICY,
                         "--steps", "20", "--episodes", "1",
                         "--device", "cpu", "--print_actions", "1"])
    assert out[0]["episode_len"] == 20 and not out[0]["terminated"]
    assert out[0]["forward_x"] > 0.02
